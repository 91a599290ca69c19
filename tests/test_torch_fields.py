"""fields/fp.py and fields/fp2.py of the PyTorch port against the JAX
reference, bit for bit after the limb repack.  Inputs come from a seeded
``random.Random`` and go to both sides; tolerance: exact equality."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from octopuszk_tpu.fields import fp as rfp, fp2 as rfp2
from octopuszk_tpu.fields import spec as rspec
from octopuszk_tpu.utils.bigint import ints_to_limbs

from octopuszk_tpu_torch import convert
from octopuszk_tpu_torch.fields import fp, fp2
from octopuszk_tpu_torch.fields import spec as tspec
from octopuszk_tpu_torch.utils.bigint import ints_to_words, words_to_ints

# The port's CPU path is many small tensor ops.  Several test processes
# share the cores, and torch's intra-op thread pools would oversubscribe
# them (each op many times slower), so each process keeps one thread.
torch.set_num_threads(1)

N = 64
SPECS = {"fr": (rspec.FR, tspec.FR), "fq": (rspec.FQ, tspec.FQ)}


def _values(p, seed, n=N):
    rng = random.Random(seed)
    return [0, 1, p - 1] + [rng.randrange(p) for _ in range(n - 3)]


def _both(vals):
    """The same host ints as (reference limbs, port words)."""
    ref = jnp.asarray(ints_to_limbs(vals, 16))
    return ref, torch.from_numpy(ints_to_words(vals).copy())


def _same(ref, got):
    np.testing.assert_array_equal(np.asarray(ref), convert.field_to_ref(got))


@pytest.fixture(params=sorted(SPECS))
def field(request):
    rs, ts = SPECS[request.param]
    xs, ys = _values(rs.p, 1), list(reversed(_values(rs.p, 2)))
    return rs, ts, _both(xs), _both(ys)


def test_spec_constants_agree():
    for rs, ts in SPECS.values():
        assert (rs.p, rs.r_mod_p, rs.r2_mod_p) == (ts.p, ts.r_mod_p, ts.r2_mod_p)
        assert ts.n0inv16 == rs.n0inv
        assert (ts.p * ts.n0inv32 + 1) % (1 << 32) == 0
        assert rs.rou_of_order(2) == ts.rou_of_order(2)
    assert rspec.FR.rou_of_order(1 << 20) == tspec.FR.rou_of_order(1 << 20)


def test_repack_is_lossless(field):
    rs, ts, (ra, ta), _ = field
    _same(ra, ta)
    assert torch.equal(convert.field_from_ref(np.asarray(ra), "cpu"), ta)
    assert torch.equal(
        convert.field_from_ref(convert.field_to_ref(ta), "cpu"), ta)


@pytest.mark.parametrize("op", ["add", "sub", "mont_mul"])
def test_binary_ops(field, op):
    rs, ts, (ra, ta), (rb, tb) = field
    _same(getattr(rfp, op)(rs, ra, rb), getattr(fp, op)(ts, ta, tb))


@pytest.mark.parametrize("op", ["neg", "double", "mont_sqr", "to_mont",
                                "from_mont", "inv"])
def test_unary_ops(field, op):
    rs, ts, (ra, ta), _ = field
    _same(getattr(rfp, op)(rs, ra), getattr(fp, op)(ts, ta))


@pytest.mark.parametrize("k", [0, 3, 9, -5])
def test_mul_small(field, k):
    rs, ts, (ra, ta), _ = field
    _same(rfp.mul_small(rs, ra, k), fp.mul_small(ts, ta, k))


def test_predicates_and_select(field):
    rs, ts, (ra, ta), (rb, tb) = field
    assert np.asarray(rfp.is_zero(ra)).tolist() == fp.is_zero(ta).tolist()
    assert np.asarray(rfp.eq(ra, rb)).tolist() == fp.eq(ta, tb).tolist()
    mask = np.arange(N) % 3 == 0
    _same(rfp.select(jnp.asarray(mask), ra, rb),
          fp.select(torch.from_numpy(mask), ta, tb))


def test_constant_and_zeros():
    ts = tspec.FQ
    one = fp.constant(ts.one_mont_words, (2, 3), "cpu")
    assert one.shape == (8, 2, 3)
    assert set(words_to_ints(one.numpy())) == {ts.r_mod_p}
    assert not fp.zeros_like_batch((5,), "cpu").any()
    _same(rfp.constant(rspec.FQ.one_mont_limbs, (2, 3)), one)


def test_pow_const(field):
    rs, ts, (ra, ta), _ = field
    _same(rfp.pow_const(rs, ra, 0b1011001), fp.pow_const(ts, ta, 0b1011001))


def test_kernel_inv(field):
    """ops/kernels.py ``inv`` (on the CPU its plain version) and fp.inv, the
    entry point that now calls it, against the reference's fp.inv; zero
    among the inputs maps to zero."""
    from octopuszk_tpu_torch.ops import kernels
    rs, ts, (ra, ta), _ = field
    want = rfp.inv(rs, ra)
    _same(want, kernels.inv(ts, ta))
    _same(want, fp.inv(ts, ta))
    assert not fp.inv(ts, ta)[:, 0].any()          # element 0 is zero


def test_batch_inv(field):
    rs, ts, _, _ = field
    vals = [v or 7 for v in _values(rs.p, 3)]
    ra, ta = _both(vals)
    _same(rfp.batch_inv(rs, ra), fp.batch_inv(ts, ta))


@pytest.mark.parametrize("n,lanes", [(64, 8), (50, 16)])
def test_batch_inv_rows(field, n, lanes):
    rs, ts, _, _ = field
    ra, ta = _both(_values(rs.p, 4, n))        # zeros map to zero
    want = rfp.batch_inv_rows(rs, ra, lanes)
    got = fp.batch_inv_rows(ts, ta, lanes)
    _same(want, got)
    raw = words_to_ints(fp.from_mont(ts, fp.mont_mul(ts, got, ta)).numpy())
    assert raw[0] == 0 and all(v == 1 for v in raw[1:])


@pytest.mark.parametrize("out_mont", [False, True])
def test_from_wide(field, out_mont):
    rs, ts, _, _ = field
    wide = np.random.default_rng(5).integers(0, 2**31, size=(16, N))
    want = rfp.from_wide(rs, jnp.asarray(wide.astype(np.uint32)), out_mont)
    got = fp.from_wide(ts, torch.from_numpy(wide.astype(np.int64)), out_mont)
    _same(want, got)
    if not out_mont:
        _same(rfp.reduce_sum_mont(rs, jnp.asarray(wide.astype(np.uint32))),
              fp.reduce_sum_mont(ts, torch.from_numpy(wide.astype(np.int64))))


# ---- Fp2 ----

@pytest.fixture
def fp2_pairs():
    rs, ts = SPECS["fq"]
    a0, a1 = _both(_values(rs.p, 6)), _both(list(reversed(_values(rs.p, 7))))
    b0, b1 = _both(_values(rs.p, 8)), _both(_values(rs.p, 9))
    return (rs, ts, ((a0[0], a1[0]), (a0[1], a1[1])),
            ((b0[0], b1[0]), (b0[1], b1[1])))


def _same2(ref, got):
    for r, g in zip(ref, got):
        _same(r, g)


@pytest.mark.parametrize("op", ["add", "sub", "mul"])
def test_fp2_binary(fp2_pairs, op):
    rs, ts, (ra, ta), (rb, tb) = fp2_pairs
    _same2(getattr(rfp2, op)(rs, ra, rb), getattr(fp2, op)(ts, ta, tb))


@pytest.mark.parametrize("op", ["neg", "double", "sqr", "conj", "inv"])
def test_fp2_unary(fp2_pairs, op):
    rs, ts, (ra, ta), _ = fp2_pairs
    _same2(getattr(rfp2, op)(rs, ra), getattr(fp2, op)(ts, ta))


def test_fp2_mul_fp_and_predicates(fp2_pairs):
    rs, ts, (ra, ta), (rb, tb) = fp2_pairs
    _same2(rfp2.mul_fp(rs, ra, rb[0]), fp2.mul_fp(ts, ta, tb[0]))
    assert np.asarray(rfp2.is_zero(ra)).tolist() == fp2.is_zero(ta).tolist()
    assert np.asarray(rfp2.eq(ra, ra)).tolist() == fp2.eq(ta, ta).tolist()
    mask = np.arange(N) % 2 == 0
    _same2(rfp2.select(jnp.asarray(mask), ra, rb),
           fp2.select(torch.from_numpy(mask), ta, tb))


def test_fp2_inv_of_zero(fp2_pairs):
    """fp2.inv through fp.inv with an element whose both components are
    zero, against the reference; it maps to zero."""
    rs, ts, (ra, ta), _ = fp2_pairs
    ra = (ra[0].at[:, 1].set(0), ra[1].at[:, 1].set(0))
    ta = tuple(c.clone() for c in ta)
    for c in ta:
        c[:, 1] = 0
    got = fp2.inv(ts, ta)
    _same2(rfp2.inv(rs, ra), got)
    assert not got[0][:, 1].any() and not got[1][:, 1].any()


def test_fp2_batch_inv_rows(fp2_pairs):
    rs, ts, (ra, ta), _ = fp2_pairs
    _same2(rfp2.batch_inv_rows(rs, ra, 8), fp2.batch_inv_rows(ts, ta, 8))


def test_fp2_nonresidue_minus_1_is_the_default(fp2_pairs):
    """The non-residue argument at -1 (BN254a's u^2 = -1) gives the words
    of the default and of the reference's nr = -1."""
    rs, ts, (ra, ta), (rb, tb) = fp2_pairs
    _same2(rfp2.mul(rs, ra, rb, -1), fp2.mul(ts, ta, tb, -1))
    _same2(rfp2.sqr(rs, ra, -1), fp2.sqr(ts, ta, -1))
    _same2(rfp2.inv(rs, ra, -1), fp2.inv(ts, ta, -1))
    for got, want in ((fp2.mul(ts, ta, tb, -1), fp2.mul(ts, ta, tb)),
                      (fp2.sqr(ts, ta, -1), fp2.sqr(ts, ta)),
                      (fp2.batch_inv_rows(ts, ta, 8, -1),
                       fp2.batch_inv_rows(ts, ta, 8))):
        assert all(torch.equal(x, y) for x, y in zip(got, want))
