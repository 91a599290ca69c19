"""ops/msm.py of the PyTorch port against the host oracle (python-int
curve arithmetic) and the JAX reference, compared as affine host ints: the
result point does not depend on the sort's tie order, the intermediate
tensors do.  The reference's G2 Pippenger pipeline takes minutes to compile
on the CPU, so the double MSM is held to the host oracle here and to the
reference through the proof in test_torch_groth16.py.  Shapes follow tests/test_msm_quick.py (64 points, c = 8,
lanes = 32 pinned, which forces the Pippenger pipeline)."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from octopuszk_tpu.curves import bn254 as rbn
from octopuszk_tpu.ops import msm as rmsm
from octopuszk_tpu.utils.bigint import ints_to_limbs

from octopuszk_tpu_torch import convert
from octopuszk_tpu_torch.curves import bn254, group_ops as jac
from octopuszk_tpu_torch.fields.spec import FR
from octopuszk_tpu_torch.ops import msm
from octopuszk_tpu_torch.utils.bigint import ints_to_words

# The port's CPU path is many small tensor ops.  Several test processes
# share the cores, and torch's intra-op thread pools would oversubscribe
# them (each op many times slower), so each process keeps one thread.
torch.set_num_threads(1)

N, C, LANES = 50, 8, 32          # 50 points pad to 64 packed rows
R = FR.p


def _points(group, seed, n):
    rng = random.Random(seed)
    pts = [group.host.mul(group.generator_affine, rng.randrange(1, 1 << 48))
           for _ in range(n)]
    pts[4] = None                # identity among the bases
    return pts


def _scalars(seed, n):
    rng = random.Random(seed)
    return [0, R, R - 1, 1, 2, (1 << 254) - 1] + [
        rng.randrange(R) for _ in range(n - 6)]


def _dev(ks):
    return torch.from_numpy(ints_to_words(ks).copy())


def _rdev(ks):
    return jnp.asarray(ints_to_limbs(ks, 16))


def _host1(group, p):
    return group.points_to_host(jac._map_coords(p, lambda c: c[..., None]))[0]


def _rhost1(group, p):
    from octopuszk_tpu.curves import group_ops as rjac
    return group.points_to_host(rjac._map_coords(p, lambda c: c[..., None]))[0]


@pytest.fixture(scope="module")
def bases():
    out = {}
    for name, rg, tg in (("G1", rbn.G1, bn254.G1), ("G2", rbn.G2, bn254.G2)):
        pts = _points(tg, 41, N)
        pad_to = msm._msm_pad_to(tg, N, LANES, 22)
        assert pad_to == 64 == rmsm._msm_pad_to(rg, N, LANES, 22)
        packed = msm.points_to_packed(tg, tg.points_to_device(pts, "cpu"),
                                      pad_to=pad_to)
        rpacked = rmsm.points_to_packed(rg, rg.points_to_device(pts),
                                        pad_to=pad_to)
        out[name] = (rg, tg, pts, packed, rpacked)
    return out


@pytest.mark.parametrize("name", ["G1", "G2"])
def test_packing_round_trip(bases, name):
    rg, tg, pts, packed, rpacked = bases[name]
    assert torch.equal(convert.packed_from_ref(np.asarray(rpacked), tg, "cpu"),
                       packed)
    np.testing.assert_array_equal(np.asarray(rpacked),
                                  convert.packed_to_ref(packed))
    back = tg.points_to_host(msm.packed_to_points(tg, packed))
    assert back == pts + [None] * (64 - N)


def test_digits_agree():
    ks = _scalars(42, 20)
    for c, nw in ((8, 32), (17, 15), (5, 51)):
        mag, neg = msm._signed_digits(_dev(ks), c, nw)
        rmag, rneg = rmsm._signed_digits(_rdev(ks), c, nw)
        assert mag.tolist() == np.asarray(rmag).tolist()
        assert neg.tolist() == np.asarray(rneg).tolist()
        for j, k in enumerate(ks):      # the digits reassemble the scalar
            val = sum((-1) ** int(neg[w, j]) * int(mag[w, j]) << (c * w)
                      for w in range(nw))
            assert val == k
    assert msm._digits(_dev(ks), 4, 64).tolist() == np.asarray(
        rmsm._digits(_rdev(ks), 4, 64)).tolist()


def test_pippenger_msm_packed_g1(bases):
    rg, tg, pts, packed, rpacked = bases["G1"]
    ks = _scalars(43, N)
    got = _host1(tg, msm.pippenger_msm_packed(tg, packed, _dev(ks),
                                              c=C, lanes=LANES))
    assert got == tg.host.naive_msm(ks, pts)
    want = _rhost1(rg, rmsm.pippenger_msm_packed(rg, rpacked, _rdev(ks),
                                                 c=C, lanes=LANES))
    assert got == want
    # below NAIVE_THRESHOLD the default dispatch is double-and-add
    assert _host1(tg, msm.pippenger_msm_packed(tg, packed, _dev(ks))) == got
    # all-zero scalars give the identity
    zero = _dev([0] * N)
    assert _host1(tg, msm.pippenger_msm_packed(tg, packed, zero,
                                               c=C, lanes=LANES)) is None


def test_pippenger_double_msm_packed(bases):
    rg1, tg1, pts1, packed1, rpacked1 = bases["G1"]
    rg2, tg2, pts2, packed2, rpacked2 = bases["G2"]
    ks = _scalars(44, N)
    b1, b2 = msm.pippenger_double_msm_packed(
        tg1, tg2, packed1, packed2, _dev(ks), c=C, lanes=LANES)
    got = (_host1(tg1, b1), _host1(tg2, b2))
    assert got == (tg1.host.naive_msm(ks, pts1), tg2.host.naive_msm(ks, pts2))
    # the G1 leg equals the single MSM (shared digits and sort change nothing)
    assert got[0] == _host1(tg1, msm.pippenger_msm_packed(
        tg1, packed1, _dev(ks), c=C, lanes=LANES))


@pytest.mark.parametrize("name", ["G1", "G2"])
def test_fixed_base_msm_small(bases, name):
    """Held to the host oracle here; the reference's small path is compared
    through the CRS in test_torch_groth16.py."""
    rg, tg, pts, _, _ = bases[name]
    ks = _scalars(45, 21)
    base = pts[7]
    got = tg.points_to_host(msm.fixed_base_msm(
        tg, tg.point_to_device(base, "cpu"), _dev(ks)))
    assert got == [tg.host.mul(base, k) for k in ks]


@pytest.fixture(scope="module")
def reference_fixed_g1(bases):
    """The reference's packed fixed-base evaluation of _scalars(46, 21) on
    G1's pts[9] at w = 6, as affine host ints (its XLA:CPU compile is most
    of a test's time, so the tests below share it)."""
    rg, _, pts, _, _ = bases["G1"]
    saved = rmsm.FIXED_PACKED_MIN
    rmsm.FIXED_PACKED_MIN = 1
    try:
        return rg.points_to_host(rmsm._fixed_base_msm_packed(
            rg, rg.point_to_device(pts[9]), _rdev(_scalars(46, 21)), 6))
    finally:
        rmsm.FIXED_PACKED_MIN = saved


@pytest.mark.parametrize("name", ["G1", "G2"])
def test_fixed_base_msm_packed_direct(bases, name, monkeypatch,
                                      reference_fixed_g1):
    """The packed fixed-base path (setup's path from 2^14 scalars) called
    at a small window width, with one table serving two batches."""
    rg, tg, pts, _, _ = bases[name]
    ks = _scalars(46, 21)
    base = pts[9]
    monkeypatch.setattr(msm, "FIXED_PACKED_MIN", 1)
    dev_base = tg.point_to_device(base, "cpu")
    table = msm.fixed_base_table(tg, dev_base, len(ks), w=6)
    assert table.packed and table.data.shape == (43 << 6, 16 * tg.coord_dim)
    got = tg.points_to_host(msm.fixed_base_msm(tg, dev_base, _dev(ks),
                                               table=table))
    assert got == [tg.host.mul(base, k) for k in ks]
    again = tg.points_to_host(msm.fixed_base_msm(
        tg, dev_base, _dev(ks[::-1]), table=table))
    assert again == got[::-1]
    if name == "G1":
        assert got == reference_fixed_g1


@pytest.mark.parametrize("name", ["G1", "G2"])
def test_fixed_base_msm_packed_chunks(bases, name, monkeypatch,
                                      reference_fixed_g1):
    """setup's chunked evaluation (``fixed_base_msm_packed``) with
    FIXED_CHUNK_LOG lowered to 3: the 21 scalars of the direct test above
    in three chunks (8, 8, 5), written into 32 rows.  The rows equal the
    one-chunk result's word for word; the points are the host oracle's and
    (G1) the reference's, the identity past the scalars."""
    rg, tg, pts, _, _ = bases[name]
    ks = _scalars(46, 21)
    base = pts[9]
    monkeypatch.setattr(msm, "FIXED_PACKED_MIN", 1)
    dev_base = tg.point_to_device(base, "cpu")
    table = msm.fixed_base_table(tg, dev_base, len(ks), w=6)
    one = msm.fixed_base_msm_packed(tg, table, _dev(ks), 32)
    chunks = []
    whole = msm.fixed_base_msm
    monkeypatch.setattr(msm, "fixed_base_msm", lambda g, b, s, **kw: (
        chunks.append(s.shape[1]), whole(g, b, s, **kw))[1])
    monkeypatch.setattr(msm, "FIXED_CHUNK_LOG", 3)
    got = msm.fixed_base_msm_packed(tg, table, _dev(ks), 32)
    assert chunks == [8, 8, 5]
    assert got.shape == (32, 16 * tg.coord_dim) and got.dtype == torch.int32
    assert torch.equal(got, one)
    host = tg.points_to_host(msm.packed_to_points(tg, got))
    assert host == [tg.host.mul(base, k) for k in ks] + [None] * 11
    if name == "G1":
        assert host[:21] == reference_fixed_g1


def test_pippenger_host_matches_naive(bases):
    _, tg, pts, _, _ = bases["G1"]
    ks = _scalars(47, N)
    assert msm.pippenger_host(tg, ks, pts, order=R) == tg.host.naive_msm(ks, pts)
    assert msm.pippenger_host(tg, [-1, 3], pts[:2], order=R) == tg.host.add(
        tg.host.neg(pts[0]), tg.host.mul(pts[1], 3))
    assert msm.pippenger_host(tg, [], []) is None


def test_choosers_agree():
    for n in (3, 64, 1 << 14, 1 << 21):
        assert msm._choose_w(n) == rmsm._choose_w(n)
        assert msm._choose_w_packed(n) == rmsm._choose_w_packed(n)
        assert msm._choose_c_large(n) == rmsm._choose_c_large(n)
        assert msm._plan_packed(n, None, 22) == rmsm._plan_packed(n, None, 22)
    assert msm.NAIVE_THRESHOLD == rmsm.NAIVE_THRESHOLD
    assert msm.FIXED_PACKED_MIN == rmsm.FIXED_PACKED_MIN
