"""models/bace/ and ops/poly.py of the PyTorch port against the JAX
reference (exact), at K = 8 instances."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from octopuszk_tpu.fields.spec import FR as RFR
from octopuszk_tpu.models.bace import prover as rprover
from octopuszk_tpu.models.bace.circuit import (
    Circuit as RCircuit, ConstantGate as RConstantGate,
    InputGate as RInputGate, ProductGate as RProductGate, SumGate as RSumGate)
from octopuszk_tpu.ops import poly as rpoly

from octopuszk_tpu_torch import convert
from octopuszk_tpu_torch.fields.spec import FR
from octopuszk_tpu_torch.models.bace import prover, verifier
from octopuszk_tpu_torch.models.bace.circuit import (
    Circuit, ConstantGate, InputGate, ProductGate, SumGate)
from octopuszk_tpu_torch.ops import poly
from octopuszk_tpu_torch.utils.bigint import words_to_ints

# The port's CPU path is many small tensor ops.  Several test processes
# share the cores, and torch's intra-op thread pools would oversubscribe
# them (each op many times slower), so each process keeps one thread.
torch.set_num_threads(1)

K = 8
P = FR.p


def _circuits(gates):
    """The profiler's circuit (x0 + x1) * x0, and (x0 + 7) * x1 with a
    constant gate, built from one gate namespace (the port's or the
    reference's).  Both have two inputs and degree 2, so the reference
    compiles its transforms once for both."""
    circuit, inp, const, add, mul = gates
    x0, x1 = inp(0), inp(1)
    return {
        "profiler": circuit(2, mul(add(x0, x1), x0)),
        "constant": circuit(2, mul(add(x0, const(7)), x1)),
    }


CIRCUITS = _circuits((Circuit, InputGate, ConstantGate, SumGate, ProductGate))
HOST = {"profiler": lambda x: (x[0] + x[1]) * x[0] % P,
        "constant": lambda x: (x[0] + 7) * x[1] % P}


def _words(n, seed):
    """n canonical Montgomery elements from a seeded numpy draw."""
    rng = np.random.default_rng(seed)
    w = rng.integers(0, 1 << 32, size=(8, n), dtype=np.uint32)
    w[7] &= (1 << 28) - 1                  # below 2^252 < p
    return torch.from_numpy(w.view(np.int32))


@pytest.fixture(scope="module")
def ref():
    """The reference's proofs for both circuits and its polynomial
    evaluations, computed once."""
    rcirc = _circuits((RCircuit, RInputGate, RConstantGate, RSumGate,
                       RProductGate))
    proofs = {}
    for name, c in rcirc.items():
        inputs = _words(K * c.input_size, seed=len(name))
        proofs[name] = (inputs, np.asarray(rprover.compute_proof(
            RFR, c, jnp.asarray(convert.field_to_ref(inputs)), K)))
    evals = {}
    for n in (5, 8):
        coeffs, x = _words(n, seed=10 + n), _words(1, seed=20 + n)[:, 0]
        evals[n] = (coeffs, x, np.asarray(rpoly.evaluate_poly(
            RFR, jnp.asarray(convert.field_to_ref(coeffs)),
            jnp.asarray(convert.field_to_ref(x)))))
    return proofs, evals


@pytest.mark.parametrize("name", sorted(CIRCUITS))
def test_compute_proof_equals_reference(ref, name):
    inputs, want = ref[0][name]
    got = prover.compute_proof(FR, CIRCUITS[name], inputs, K)
    assert got.shape == (8, prover.proof_size(CIRCUITS[name], K))
    np.testing.assert_array_equal(convert.field_to_ref(got), want)


@pytest.mark.parametrize("name", sorted(CIRCUITS))
def test_verify_and_get_result(ref, name):
    c = CIRCUITS[name]
    inputs, _ = ref[0][name]
    proof = prover.compute_proof(FR, c, inputs, K)
    assert verifier.verify_proof(FR, c, proof, inputs, K, seed=1)
    bad = proof.clone()
    bad[0, 0] += 1                         # one word of one coefficient
    assert not verifier.verify_proof(FR, c, bad, inputs, K, seed=1)
    vals = [FR.from_mont(v) for v in words_to_ints(inputs.numpy())]
    per_instance = [vals[k * c.input_size:(k + 1) * c.input_size]
                    for k in range(K)]
    got = [FR.from_mont(v) for v in words_to_ints(
        verifier.get_result(FR, c, proof, K).numpy())]
    assert got == [HOST[name](x) for x in per_instance]


@pytest.mark.parametrize("n", [5, 8])
def test_evaluate_poly_equals_reference(ref, n):
    coeffs, x, want = ref[1][n]
    np.testing.assert_array_equal(
        convert.field_to_ref(poly.evaluate_poly(FR, coeffs, x)[:, None]),
        want[:, None])


def test_wide_sum_carries_past_32_bits():
    """2^17 copies of p - 1: every 16-bit digit sum passes 2^32, which the
    reference's uint32 chunks could not hold in one pass."""
    n = 1 << 17
    top = torch.from_numpy(np.frombuffer(
        (P - 1).to_bytes(32, "little"), dtype="<u4").view(np.int32).copy())
    terms = top[:, None].expand(8, n)
    got = words_to_ints(poly.wide_sum(FR, terms).numpy()[:, None])[0]
    assert got == n * (P - 1) % P
