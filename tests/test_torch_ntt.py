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
    """The 4-step runs above the sub-transform cap (2^12); call it directly
    at n = 64 (square view) and n = 32 (R = 2C), against the reference's
    4-step and its flat transform."""
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


ROUTED = ("ntt", "intt", "coset_ntt", "coset_intt")


@pytest.fixture(scope="module")
def ref_transforms(vec):
    return {fn: np.asarray(getattr(rntt, fn)(RFR, vec[0])) for fn in ROUTED}


@pytest.mark.parametrize("cap", [8, 4])
def test_transforms_routed_by_the_cap(vec, ref_transforms, monkeypatch, cap):
    """With the sub-transform cap lowered to 8, n = 64 is the 4-step's two
    ntt_block passes (the twiddles, the coset powers and the scale as
    pre / post tables); with 4, its columns (R = 8) are a 4-step of their
    own.  Each against the reference."""
    monkeypatch.setattr(ntt, "BLOCK_MAX", cap)
    for fn in ROUTED:
        _same(ref_transforms[fn], getattr(ntt, fn)(FR, vec[1]))


def _stage_twiddles(n, inverse):
    w = FR.rou_of_order(n)
    w = pow(w, -1, FR.p) if inverse else w
    return torch.from_numpy(ints_to_words(
        [FR.to_mont(pow(w, k, FR.p)) for k in range(n // 2)]).copy())


def _table(vals):
    return torch.from_numpy(ints_to_words(
        [FR.to_mont(v % FR.p) for v in vals]).copy())


def test_ntt_block_plain(vec, ref_transforms):
    """ntt_block's plain version, one transform of L = 64 (B = 1): DIF
    without tables is ntt, DIF with the coset powers as ``pre`` is
    coset_ntt, DIT with 1/n as ``post`` is intt and with g^-i / n coset_intt;
    and a batch of two, the second column a copy, with a ``pre`` table
    broadcast over it."""
    from octopuszk_tpu_torch.ops import kernels
    x = vec[1][:, :, None]
    g, ninv = FR.generator, pow(N, -1, FR.p)
    coset = _table([pow(g, i, FR.p) for i in range(N)])[:, :, None]
    icoset = _table([pow(g, -i, FR.p) * ninv for i in range(N)])[:, :, None]
    scale = _table([ninv])[:, :, None]
    fwd, inv = _stage_twiddles(N, False), _stage_twiddles(N, True)
    for fn, tw, dif, pre, post in (("ntt", fwd, True, None, None),
                                   ("coset_ntt", fwd, True, coset, None),
                                   ("intt", inv, False, None, scale),
                                   ("coset_intt", inv, False, None, icoset)):
        got = kernels.ntt_block_plain(FR, x, tw, dif, pre, post)
        _same(ref_transforms[fn], got[:, :, 0])
    two = kernels.ntt_block_plain(FR, torch.cat([x, x], dim=2), fwd, True,
                                  coset.expand(8, N, 2))
    _same(ref_transforms["coset_ntt"], two[:, :, 1])


def test_second_call_builds_no_table(vec, monkeypatch):
    """The stage twiddles, the 4-step twiddles, the coset powers and the
    scale are built on a transform's first call and kept: the second call
    of every routed transform builds nothing (``powers`` is not called)."""
    monkeypatch.setattr(ntt, "BLOCK_MAX", 8)
    monkeypatch.setattr(ntt, "_TABLES", {})
    calls = []
    powers = ntt.powers
    monkeypatch.setattr(ntt, "powers", lambda *a: calls.append(a) or
                        powers(*a))
    first = [getattr(ntt, fn)(FR, vec[1]) for fn in ROUTED]
    built = len(calls)
    assert built > 0
    again = [getattr(ntt, fn)(FR, vec[1]) for fn in ROUTED]
    assert len(calls) == built
    assert all(torch.equal(a, b) for a, b in zip(first, again))
