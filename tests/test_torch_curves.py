"""The BN254a groups of the PyTorch port (curves/bn254.py over
curves/group_ops.py, the plain kernels on the CPU) against the JAX
reference's host curve in python ints: the cases of tests/test_curves.py
(host round trip, add and double, the add's edge cases, mixed add,
scalar multiplication, the tree reduction) and ``normalize_z1``, G1
and G2, with the reference's random points; and the port's host curve against the
reference's.  The reference's device groups are not called: their XLA:CPU
compiles are what tests/test_curves.py pays for; only ``normalize_z1``
runs on both sides (one compile of 1-6 s a group).  Tolerance: exact."""

import numpy as np
import pytest
import torch

from octopuszk_tpu.curves import bn254 as rbn254
from octopuszk_tpu.fields.spec import FR as RFR

from octopuszk_tpu_torch.curves import bn254, group_ops
from octopuszk_tpu_torch.utils.bigint import ints_to_words

torch.set_num_threads(1)

GROUPS = {"G1": (bn254.G1, rbn254.G1), "G2": (bn254.G2, rbn254.G2)}
N = 8


def _rand_points(rng, rgrp, n):
    gen = rgrp.generator_affine
    return [rgrp.host.mul(gen, rng.randrange(1, RFR.p)) for _ in range(n)]


@pytest.mark.parametrize("name", sorted(GROUPS))
def test_roundtrip_and_host_curve(rng, name):
    grp, rgrp = GROUPS[name]
    assert grp.generator_affine == rgrp.generator_affine
    pts = _rand_points(rng, rgrp, N) + [None]
    assert grp.points_to_host(grp.points_to_device(pts, "cpu")) == pts
    k = rng.randrange(RFR.p)
    assert grp.host.mul(pts[0], k) == rgrp.host.mul(pts[0], k)
    assert grp.host.add(pts[0], pts[1]) == rgrp.host.add(pts[0], pts[1])
    assert grp.host.neg(pts[2]) == rgrp.host.neg(pts[2])
    assert all(grp.host.is_on_curve(p) for p in pts[:-1])


@pytest.mark.parametrize("name", sorted(GROUPS))
def test_add_double(rng, name):
    grp, rgrp = GROUPS[name]
    ps = _rand_points(rng, rgrp, N)
    qs = _rand_points(rng, rgrp, N)
    a, b = grp.points_to_device(ps, "cpu"), grp.points_to_device(qs, "cpu")
    assert grp.points_to_host(grp.add(a, b)) == [
        rgrp.host.add(p, q) for p, q in zip(ps, qs)]
    assert grp.points_to_host(grp.double(a)) == [
        rgrp.host.add(p, p) for p in ps]


@pytest.mark.parametrize("name", sorted(GROUPS))
def test_add_edge_cases(rng, name):
    grp, rgrp = GROUPS[name]
    p = _rand_points(rng, rgrp, 1)[0]
    ps = [p, None, p, p, None]
    qs = [None, p, p, rgrp.host.neg(p), None]
    a, b = grp.points_to_device(ps, "cpu"), grp.points_to_device(qs, "cpu")
    assert grp.points_to_host(grp.add(a, b)) == [
        p, p, rgrp.host.add(p, p), None, None]


@pytest.mark.parametrize("name", sorted(GROUPS))
def test_mixed_add(rng, name):
    grp, rgrp = GROUPS[name]
    ps = _rand_points(rng, rgrp, 4)
    qs = _rand_points(rng, rgrp, 3) + [None]
    a = grp.points_to_device(ps, "cpu")
    x, y, inf = grp.to_affine(grp.points_to_device(qs, "cpu"))
    assert grp.points_to_host(grp.mixed_add(a, (x, y), inf)) == [
        rgrp.host.add(p, q) for p, q in zip(ps, qs)]


@pytest.mark.parametrize("name", sorted(GROUPS))
def test_scalar_mul(rng, name):
    grp, rgrp = GROUPS[name]
    ps = _rand_points(rng, rgrp, 4)
    ks = [rng.randrange(RFR.p) for _ in range(3)] + [0]
    a = grp.points_to_device(ps, "cpu")
    s = torch.from_numpy(ints_to_words(ks).copy())
    assert grp.points_to_host(grp.scalar_mul(a, s)) == [
        rgrp.host.mul(p, k) for p, k in zip(ps, ks)]


@pytest.mark.parametrize("name", sorted(GROUPS))
def test_tree_reduce(rng, name):
    grp, rgrp = GROUPS[name]
    ps = _rand_points(rng, rgrp, 7) + [None]
    got = grp.tree_reduce(grp.points_to_device(ps, "cpu"), 8)
    acc = None
    for p in ps:
        acc = rgrp.host.add(acc, p)
    assert grp.points_to_host(
        group_ops._map_coords(got, lambda c: c[..., None])) == [acc]


@pytest.mark.parametrize("name", sorted(GROUPS))
def test_normalize_z1(rng, name):
    """normalize_z1 on doubled points (Z not 1) and the identity, exactly
    the reference's words, the identity as (0, 1, 0)."""
    import jax
    import jax.numpy as jnp
    from octopuszk_tpu.curves import group_ops as rgroup_ops
    from octopuszk_tpu_torch import convert
    grp, rgrp = GROUPS[name]
    ps = _rand_points(rng, rgrp, 3) + [None]
    p = grp.double(grp.points_to_device(ps, "cpu"))
    got = group_ops.normalize_z1(grp.ops, p)
    rp = jax.tree_util.tree_map(jnp.asarray, convert.points_to_ref(p))
    want = jax.jit(lambda q: rgroup_ops.normalize_z1(rgrp.ops, q))(rp)
    want = convert.points_from_ref(
        jax.tree_util.tree_map(np.asarray, want), "cpu")
    assert all(torch.equal(a, b) for a, b in zip(
        group_ops.flatten_coords(got), group_ops.flatten_coords(want)))
    assert grp.points_to_host(got) == [rgrp.host.add(q, q) for q in ps]
    ident = group_ops.infinity(grp.ops, (1,), "cpu")
    assert all(torch.equal(a[..., -1:], b) for a, b in zip(
        group_ops.flatten_coords(got), group_ops.flatten_coords(ident)))
