"""The slice as a whole: serial Groth16 on ``serial_construct(14, 3, seed=7)``
in the PyTorch port against the JAX reference.  The same seeds give the same
CRS (packed queries bit for bit after ``convert``) and the same proof, and
each verifier accepts the other's proof."""

import numpy as np
import pytest
import torch

from octopuszk_tpu.models.groth16 import (
    objects as robjects, prover as rprover, setup as rsetup,
    verifier as rverifier)
from octopuszk_tpu.relations import construct as rconstruct

from octopuszk_tpu_torch import convert
from octopuszk_tpu_torch.curves import host_curve as hc
from octopuszk_tpu_torch.fields.spec import FR
from octopuszk_tpu_torch.models.groth16 import prover, setup, verifier
from octopuszk_tpu_torch.models.groth16.objects import Proof
from octopuszk_tpu_torch.ops import msm
from octopuszk_tpu_torch.relations import construct

QUERIES = ("query_a", "query_b_g1", "query_b_g2", "query_h", "delta_abc_g1")


@pytest.fixture(scope="module")
def reference():
    r1cs, primary, aux = rconstruct.serial_construct(14, 3, seed=7)
    crs = rsetup.setup(r1cs, seed=8)
    proof = rprover.prove(crs.proving_key, primary, aux, seed=9)
    return crs, primary, aux, proof


@pytest.fixture(scope="module")
def ported():
    r1cs, primary, aux = construct.serial_construct(14, 3, seed=7, device="cpu")
    stages = {}
    crs = setup.setup(r1cs, seed=8, stage_seconds=stages)
    assert "enc-H(g1)" in stages and all(v >= 0 for v in stages.values())
    return crs, primary, aux


def test_setup_equals_reference(reference, ported):
    rcrs, *_ = reference
    crs, *_ = ported
    want = convert.proving_key_from_ref(rcrs.proving_key, device="cpu")
    pk = crs.proving_key
    for q in QUERIES:
        assert torch.equal(getattr(pk, q), getattr(want, q)), q
        np.testing.assert_array_equal(
            convert.packed_to_ref(getattr(pk, q)),
            np.asarray(getattr(rcrs.proving_key, q)))
    for f in ("alpha_g1", "beta_g1", "beta_g2", "delta_g1", "delta_g2"):
        assert getattr(pk, f) == getattr(want, f), f
    assert pk.packed and want.packed
    vk = crs.verification_key
    rvk = convert.verification_key_from_ref(rcrs.verification_key)
    assert vk.alpha_beta_gt == rvk.alpha_beta_gt
    assert (vk.gamma_g2, vk.delta_g2) == (rvk.gamma_g2, rvk.delta_g2)
    assert vk.gamma_abc_g1 == rvk.gamma_abc_g1 and len(vk.gamma_abc_g1) == 3


def test_prove_on_reference_key_equals_reference(reference):
    rcrs, primary, aux, rproof = reference
    pk = convert.proving_key_from_ref(rcrs.proving_key, device="cpu")
    proof = prover.prove(pk, primary, aux, seed=9)
    assert (proof.a, proof.b, proof.c) == (rproof.a, rproof.b, rproof.c)


@pytest.fixture(scope="module")
def port_proof(ported):
    """A proof made wholly by the port, every MSM through the Pippenger
    pipeline (the default dispatch is double-and-add at this size)."""
    crs, primary, aux = ported
    saved = msm.NAIVE_THRESHOLD
    msm.NAIVE_THRESHOLD = 0
    try:
        stages = {}
        proof = prover.prove(crs.proving_key, primary, aux, seed=9,
                             stage_seconds=stages)
    finally:
        msm.NAIVE_THRESHOLD = saved
    assert "msm-B(g1+g2)" in stages
    return proof


def test_pippenger_proof_equals_reference(reference, port_proof):
    *_, rproof = reference
    assert (port_proof.a, port_proof.b, port_proof.c) == (
        rproof.a, rproof.b, rproof.c)


def test_each_verifier_accepts_the_other(reference, ported, port_proof):
    rcrs, primary, _, rproof = reference
    crs, *_ = ported
    assert rverifier.verify(
        rcrs.verification_key, primary,
        robjects.Proof(a=port_proof.a, b=port_proof.b, c=port_proof.c))
    assert verifier.verify(crs.verification_key, primary,
                           Proof(a=rproof.a, b=rproof.b, c=rproof.c))
    assert verifier.verify(crs.verification_key, primary, port_proof)


def test_reject_wrong_input(ported, port_proof):
    crs, primary, _ = ported
    bad = list(primary)
    bad[1] = (bad[1] + 1) % FR.p
    assert not verifier.verify(crs.verification_key, bad, port_proof)
    with pytest.raises(ValueError):
        verifier.verify(crs.verification_key, [2] + bad[1:], port_proof)


def test_reject_tampered_proof(ported, port_proof):
    crs, primary, _ = ported
    tampered = Proof(a=hc.g1_add(port_proof.a, hc.G1_GEN), b=port_proof.b,
                     c=port_proof.c)
    assert not verifier.verify(crs.verification_key, primary, tampered)


def test_debug_checks(ported):
    """config.debug turns on the satisfiability assertion."""
    import types
    crs, primary, aux = ported
    bad_aux = list(aux)
    bad_aux[0] = (bad_aux[0] + 1) % FR.p
    with pytest.raises(AssertionError, match="not satisfied"):
        prover.prove(crs.proving_key, primary, bad_aux, seed=9,
                     config=types.SimpleNamespace(debug=True))
