"""The unpacked and remaining MSM entry points of the port's ops/msm.py:
the sort-based ``pippenger_msm`` (kernel h's path), ``pippenger_msm_large``,
``double_batch_msm``, ``field_batch_msm``, the host-streamed packed MSMs and
the host algorithms.  Compared exactly, as affine host ints, with the host
oracle (python-int curve arithmetic) and, for ``pippenger_msm`` on G1, with
the JAX reference (one XLA:CPU compile; the reference's G2 pipeline takes
minutes to compile on the CPU)."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from octopuszk_tpu.curves import bn254 as rbn
from octopuszk_tpu.ops import msm as rmsm
from octopuszk_tpu.utils.bigint import ints_to_limbs

from octopuszk_tpu_torch.curves import bn254, group_ops as jac
from octopuszk_tpu_torch.fields.spec import FR
from octopuszk_tpu_torch.ops import kernels, msm
from octopuszk_tpu_torch.utils.bigint import int_to_words, ints_to_words, \
    words_to_ints

# The port's CPU path is many small tensor ops.  Several test processes
# share the cores, and torch's intra-op thread pools would oversubscribe
# them (each op many times slower), so each process keeps one thread.
torch.set_num_threads(1)

R = FR.p
GROUPS = {"G1": bn254.G1, "G2": bn254.G2}


def _points(group, seed, n):
    """Host points with an identity base and a repeated point."""
    rng = random.Random(seed)
    pts = [group.host.mul(group.generator_affine, rng.randrange(1, 1 << 48))
           for _ in range(n)]
    pts[3] = None
    pts[6] = pts[5]
    return pts


def _scalars(seed, n):
    """Zero, r - 1, 1, a repeated scalar, the rest random."""
    rng = random.Random(seed)
    ks = [0, R - 1, 1] + [rng.randrange(R) for _ in range(n - 3)]
    ks[10] = ks[11]
    return ks


def _dev(ks):
    return torch.from_numpy(ints_to_words(ks).copy())


def _host1(group, p):
    return group.points_to_host(jac._map_coords(p, lambda c: c[..., None]))[0]


def test_pippenger_msm_g1_equals_reference():
    """n = 32, c = 5, lanes = 8 (4 rows, 51 windows) in both packages."""
    n = 32
    g, rg = bn254.G1, rbn.G1
    pts, ks = _points(g, 51, n), _scalars(52, n)
    kernels.reset_launch_counts()
    got = _host1(g, msm.pippenger_msm(g, g.points_to_device(pts, "cpu"),
                                      _dev(ks), c=5, lanes=8))
    assert kernels.LAUNCHES["scan_accumulate"] == 0     # CPU: plain version
    want = rg.points_to_host(jac._map_coords(
        rmsm.pippenger_msm(rg, rg.points_to_device(pts),
                           jnp.asarray(ints_to_limbs(ks, 16)), 5, 8),
        lambda c: c[..., None]))[0]
    assert got == want == g.host.naive_msm(ks, pts)


@pytest.mark.parametrize("name", sorted(GROUPS))
def test_pippenger_msm_oracle(name):
    """A batch that does not divide into the lanes (37 points on 8 lanes,
    padded with identities and zero scalars), duplicate scalars and
    points, zero and r - 1 scalars and an identity base."""
    g = GROUPS[name]
    n = 37
    pts, ks = _points(g, 53, n), _scalars(54, n)
    got = _host1(g, msm.pippenger_msm(g, g.points_to_device(pts, "cpu"),
                                      _dev(ks), c=5, lanes=8))
    assert got == g.host.naive_msm(ks, pts)


def test_pippenger_msm_defaults_and_short_scalars():
    """The default window and lane choice, and fewer scalars than points
    (the missing ones are zero)."""
    g = bn254.G1
    n = 40
    pts, ks = _points(g, 55, n), _scalars(56, n)
    assert (msm._choose_c(n), msm._choose_lanes(n)) == (
        rmsm._choose_c(n), rmsm._choose_lanes(n)) == (4, 32)
    for m in (1 << 21, 1 << 10, 3):
        assert msm._choose_c(m) == rmsm._choose_c(m)
        assert msm._choose_lanes(m) == rmsm._choose_lanes(m)
    got = _host1(g, msm.pippenger_msm(g, g.points_to_device(pts, "cpu"),
                                      _dev(ks[:30])))
    assert got == g.host.naive_msm(ks[:30], pts[:30])


def test_pippenger_msm_large():
    """Unpacked batch -> packed rows -> the signed-digit pipeline, over
    three chunks."""
    g = bn254.G1
    n = 40
    pts, ks = _points(g, 57, n), _scalars(58, n)
    got = _host1(g, msm.pippenger_msm_large(
        g, g.points_to_device(pts, "cpu"), _dev(ks), c=4, lanes=8,
        chunk_log=4))
    assert got == g.host.naive_msm(ks, pts)


def test_double_batch_msm():
    ks = _scalars(59, 12)
    b1 = _points(bn254.G1, 60, 8)[1]
    b2 = _points(bn254.G2, 61, 8)[1]
    r1, r2 = msm.double_batch_msm(
        bn254.G1, bn254.G2, bn254.G1.point_to_device(b1, "cpu"),
        bn254.G2.point_to_device(b2, "cpu"), _dev(ks), w=4)
    assert bn254.G1.points_to_host(r1) == [bn254.G1.host.mul(b1, k)
                                           for k in ks]
    assert bn254.G2.points_to_host(r2) == [bn254.G2.host.mul(b2, k)
                                           for k in ks]


def test_field_batch_msm():
    rng = random.Random(62)
    base = rng.randrange(R)
    ks = [0, 1, R - 1] + [rng.randrange(R) for _ in range(5)]
    out = msm.field_batch_msm(
        FR, torch.from_numpy(int_to_words(FR.to_mont(base))),
        _dev([FR.to_mont(k) for k in ks]))
    got = [FR.from_mont(v) for v in words_to_ints(out.numpy())]
    assert got == [k * base % R for k in ks]


def test_host_algorithms():
    g = bn254.G1
    rng = random.Random(63)
    n = 23
    ks = [rng.randrange(R) for _ in range(n - 3)] + [0, 0, 5]
    ks[1] = ks[0]
    pts = _points(g, 64, n)
    want = g.host.naive_msm(ks, pts)
    assert msm.sorted_msm_host(g, ks, pts) == want
    assert msm.bos_coster_msm_host(g, ks, pts) == want
    assert msm.distributed_sorted_msm_host(g, ks, pts, 4) == want
    assert msm.distributed_bos_coster_msm_host(g, ks, pts, 4) == want
    assert msm.distributed_pippenger_msm_host(g, ks, pts, 4) == want
    assert msm.bos_coster_msm_host(g, [0, 0], pts[:2]) is None
    assert msm.sorted_msm_host(g, [], []) is None


def test_streamed_msms():
    """Bases in host memory, staged in three chunks (chunk_log = 5 over 96
    points), against the oracle."""
    g1, g2 = bn254.G1, bn254.G2
    n = 96
    ks = _scalars(65, n)
    p1, p2 = _points(g1, 66, n), _points(g2, 67, n)
    h1 = msm.points_to_packed(g1, g1.points_to_device(p1, "cpu"))
    h2 = msm.points_to_packed(g2, g2.points_to_device(p2, "cpu"))
    sc = _dev(ks)
    assert msm._plan_packed(n, 8, 5)[0] == 3
    got = _host1(g1, msm.pippenger_msm_packed_stream(
        g1, h1, sc, c=4, lanes=8, chunk_log=5, device="cpu"))
    want1 = g1.host.naive_msm(ks, p1)
    assert got == want1
    r1, r2 = msm.pippenger_double_msm_packed_stream(
        g1, g2, h1, h2, sc, c=4, lanes=8, chunk_log=5, device="cpu")
    assert (_host1(g1, r1), _host1(g2, r2)) == (
        want1, g2.host.naive_msm(ks, p2))


def test_streamed_msm_defaults_to_the_card():
    """With no device named, a streamed MSM stages to the card and raises
    where there is none, instead of running on the CPU."""
    g = bn254.G1
    h = msm.points_to_packed(g, g.points_to_device(_points(g, 68, 8), "cpu"))
    with pytest.raises(RuntimeError, match="CUDA"):
        msm.pippenger_msm_packed_stream(g, h, _dev(_scalars(69, 12)[:8]))


def test_packed_msm_runs_where_the_scalars_lie():
    """A packed MSM runs on the scalars' device and stages a base only from
    host memory: a base on another device (here "meta") is refused rather
    than the work moved to it or the scalars to the base."""
    g1, g2 = bn254.G1, bn254.G2
    sc = _dev(_scalars(70, 16))
    h1 = msm.points_to_packed(g1, g1.points_to_device(_points(g1, 71, 16),
                                                      "cpu"))
    h2 = msm.points_to_packed(g2, g2.points_to_device(_points(g2, 72, 16),
                                                      "cpu"))
    with pytest.raises(ValueError, match="base lies on meta"):
        msm.pippenger_msm_packed(g1, h1.to("meta"), sc)
    with pytest.raises(ValueError, match="base lies on meta"):
        msm.pippenger_double_msm_packed(g1, g2, h1, h2.to("meta"), sc,
                                        c=4, lanes=8)
