"""ops/ntt.py of the PyTorch port against the JAX reference (exact)."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from octopuszk_tpu.fields.spec import FR as RFR
from octopuszk_tpu.ops import ntt as rntt
from octopuszk_tpu.utils.bigint import ints_to_limbs

from octopuszk_tpu_torch import convert
from octopuszk_tpu_torch.fields.spec import FR
from octopuszk_tpu_torch.ops import ntt
from octopuszk_tpu_torch.utils.bigint import ints_to_words

# The port's CPU path is many small tensor ops.  Several test processes
# share the cores, and torch's intra-op thread pools would oversubscribe
# them (each op many times slower), so each process keeps one thread.
torch.set_num_threads(1)

N = 64


@pytest.fixture(scope="module")
def vec():
    rng = random.Random(31)
    vals = [FR.to_mont(rng.randrange(FR.p)) for _ in range(N)]
    return (jnp.asarray(ints_to_limbs(vals, 16)),
            torch.from_numpy(ints_to_words(vals).copy()))


def _same(ref, got):
    np.testing.assert_array_equal(np.asarray(ref), convert.field_to_ref(got))


@pytest.mark.parametrize("fn", ["ntt", "intt", "coset_ntt", "coset_intt",
                                "divide_by_z_on_coset"])
def test_transforms(vec, fn):
    rx, tx = vec
    _same(getattr(rntt, fn)(RFR, rx), getattr(ntt, fn)(FR, tx))


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n", [64, 32])
def test_four_step_forced(vec, inverse, n):
    """The 4-step runs from 2^18 up; call it directly at n = 64 (square
    view) and n = 32 (R = 2C), against the reference's 4-step and its
    flat transform."""
    rx, tx = vec[0][:, :n], vec[1][:, :n].contiguous()
    got = ntt._ntt_4step(FR, tx, inverse)
    _same(rntt._ntt_4step(RFR, rx, inverse), got)
    assert torch.equal(got, (ntt.intt if inverse else ntt.ntt)(FR, tx))


def test_multiply_by_coset_and_powers(vec):
    rx, tx = vec
    _same(rntt.multiply_by_coset(RFR, rx, inverse=True),
          ntt.multiply_by_coset(FR, tx, inverse=True))
    _same(rntt.powers(RFR, rx[:, 3], 37), ntt.powers(FR, tx[:, 3], 37))
    _same(rntt.powers_batched(RFR, rx[:, :5], 6),
          ntt.powers_batched(FR, tx[:, :5].contiguous(), 6))
    _same(rntt.ntt_batched(RFR, rx.reshape(16, 8, 8)),
          ntt.ntt_batched(FR, tx.reshape(8, 8, 8)))


@pytest.mark.parametrize("on_domain", [False, True])
def test_lagrange_coeffs(on_domain):
    t = pow(FR.rou_of_order(N), 5, FR.p) if on_domain else 0xDEADBEEF12345
    rt = jnp.asarray(ints_to_limbs([FR.to_mont(t)], 16))[:, 0]
    tt = ntt._elem(FR, t, "cpu")
    _same(rntt.lagrange_coeffs(RFR, N, rt), ntt.lagrange_coeffs(FR, N, tt))
    assert rntt.compute_z_at(RFR, N, t) == ntt.compute_z_at(FR, N, t)
