"""The plain PyTorch version of every CUDA kernel (ops/kernels.py
``*_plain``, which is also what each wrapper runs for a CPU tensor) against
the JAX function that the Pallas kernel traces (kernel h: the reference's
full add, looped over the rows as its Pallas scan does).

The field kernels and the G1 point kernels run the reference's Pallas
kernels in interpret mode at one block, as tests/test_ntt.py and
tests/test_msm_large.py do; G2 and the scans use the plain references
``group_ops.add / double / mixed_add`` that the same kernels trace.  Inputs
come from seeded generators and go to both sides; tolerance: exact."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from octopuszk_tpu.curves import bn254 as rbn, group_ops as rjac
from octopuszk_tpu.fields import spec as rspec
from octopuszk_tpu.ops import msm as rmsm, pallas_ops
from octopuszk_tpu.utils.bigint import ints_to_limbs

from octopuszk_tpu_torch import convert
from octopuszk_tpu_torch.curves import bn254, group_ops as jac
from octopuszk_tpu_torch.fields import spec as tspec
from octopuszk_tpu_torch.ops import kernels, msm
from octopuszk_tpu_torch.utils.bigint import ints_to_words

# The port's CPU path is many small tensor ops.  Several test processes
# share the cores, and torch's intra-op thread pools would oversubscribe
# them (each op many times slower), so each process keeps one thread.
torch.set_num_threads(1)

N = 40
SPECS = {"fr": (rspec.FR, tspec.FR), "fq": (rspec.FQ, tspec.FQ)}
GROUPS = {"G1": (rbn.G1, bn254.G1), "G2": (rbn.G2, bn254.G2)}


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("OCTOPUSZK_PALLAS", "interpret")
    pallas_ops.reset_mode_caches()
    yield
    monkeypatch.delenv("OCTOPUSZK_PALLAS")
    pallas_ops.reset_mode_caches()


def _field_inputs(p, seed, count):
    rng = random.Random(seed)
    out = []
    for k in range(count):
        vals = [0, 1, p - 1] + [rng.randrange(p) for _ in range(N - 3)]
        rng.shuffle(vals)
        out.append((jnp.asarray(ints_to_limbs(vals, 16)),
                    torch.from_numpy(ints_to_words(vals).copy())))
    return out


def _same(ref, got):
    np.testing.assert_array_equal(np.asarray(ref), convert.field_to_ref(got))


def _same_point(ref, got):
    for r, g in zip(rjac._map_coords(ref, np.asarray),
                    convert.points_to_ref(got)):
        np.testing.assert_array_equal(r, g)


@pytest.mark.parametrize("field", sorted(SPECS))
def test_field_kernels(field, interpret):
    rs, ts = SPECS[field]
    (ra, ta), (rb, tb), (rc, tc) = _field_inputs(rs.p, 1, 3)
    _same(pallas_ops.mont_mul(rs, ra, rb), kernels.mont_mul_plain(ts, ta, tb))
    _same(pallas_ops.mul_sub(rs, ra, rb, rc),
          kernels.mul_sub_plain(ts, ta, tb, tc))
    for dif in (True, False):
        want = pallas_ops.butterfly(rs, ra, rb, rc, dif)
        got = kernels.butterfly_plain(ts, ta, tb, tc, dif)
        _same(want[0], got[0])
        _same(want[1], got[1])
    # the wrappers take the plain version for a CPU tensor
    assert torch.equal(kernels.mont_mul(ts, ta, tb),
                       kernels.mont_mul_plain(ts, ta, tb))
    assert torch.equal(kernels.mul_sub(ts, ta, tb, tc),
                       kernels.mul_sub_plain(ts, ta, tb, tc))
    assert kernels.LAUNCHES["mont_mul"] == 0


def _points(group, seed, n=N):
    """Host points with the special cases first: identity, generator,
    a repeated point and an inverse pair."""
    rng = random.Random(seed)
    g = group.generator_affine
    pts = [group.host.mul(g, rng.randrange(1, 1 << 64)) for _ in range(n)]
    pts[0] = None
    pts[1] = g
    return pts


def _pair(rg, tg, pts):
    return (rg.points_to_device(pts), tg.points_to_device(pts, "cpu"))


@pytest.fixture(scope="module", params=sorted(GROUPS))
def point_inputs(request):
    rg, tg = GROUPS[request.param]
    ps = _points(tg, 2)
    qs = _points(tg, 3)
    qs[0], qs[1] = tg.generator_affine, None    # identity on either side
    qs[2] = ps[2]                               # equal points
    qs[3] = tg.host.neg(ps[3])                  # inverse points
    qs[4] = None
    ps[4] = None                                # both the identity
    return request.param, rg, tg, ps, qs


def test_add_points(point_inputs, interpret):
    name, rg, tg, ps, qs = point_inputs
    (rp, tp), (rq, tq) = _pair(rg, tg, ps), _pair(rg, tg, qs)
    if name == "G1":
        want = pallas_ops.add_points("G1", rp, rq)
    else:
        want = rjac.add(rg.ops, rp, rq)
    got = kernels.add_points_plain(name, tp, tq)
    _same_point(want, got)
    assert tg.points_to_host(got) == [
        tg.host.add(a, b) for a, b in zip(ps, qs)]
    _same_point(want, jac.add(tg.ops, tp, tq))


def test_double_points(point_inputs, interpret):
    name, rg, tg, ps, _ = point_inputs
    rp, tp = _pair(rg, tg, ps)
    if name == "G1":
        want = pallas_ops.double_points("G1", rp)
    else:
        want = rjac.double(rg.ops, rp)
    got = kernels.double_points_plain(name, tp)
    _same_point(want, got)
    _same_point(want, jac.double(tg.ops, tp))


def test_mixed_add(point_inputs):
    name, rg, tg, ps, qs = point_inputs
    (rp, tp), (rq, tq) = _pair(rg, tg, ps), _pair(rg, tg, qs)
    rx, ry, rinf = rjac.to_affine(rg.ops, rq)
    tx, ty, tinf = jac.to_affine(tg.ops, tq)
    _same_point((rx, ry), (tx, ty))
    assert np.asarray(rinf).tolist() == tinf.tolist()
    want = rjac.mixed_add(rg.ops, rp, (rx, ry), rinf)
    _same_point(want, jac.mixed_add(tg.ops, tp, (tx, ty), tinf))


@pytest.mark.parametrize("gname", sorted(GROUPS))
def test_scans(gname):
    """Both scans against a Python loop of the reference's mixed_add, at
    rows = 4, lanes = 8, batch = 2, with identity rows, a repeated point
    (the running sum meets itself) and an inverse pair among the inputs."""
    rg, tg = GROUPS[gname]
    rows, lanes, batch = 4, 8, 2
    pts = _points(tg, 5, 24)
    pts[5] = None
    packed = msm.points_to_packed(tg, tg.points_to_device(pts, "cpu"))
    rpacked = rmsm.points_to_packed(rg, rg.points_to_device(pts), pad_to=24)
    np.testing.assert_array_equal(np.asarray(rpacked),
                                  convert.packed_to_ref(packed))
    assert torch.equal(convert.packed_from_ref(
        np.asarray(rpacked), tg, "cpu"), packed)

    rng = np.random.default_rng(6)
    order = rng.integers(0, 24, size=(batch, rows, lanes))
    negb = rng.integers(0, 2, size=(batch, rows, lanes))
    order[0, :, 0] = [7, 7, 7, 7]           # P, 2P, 3P, 4P
    negb[0, :, 0] = 0
    order[0, :, 1] = [8, 8, 9, 0]           # P, P - P = identity, Q, identity
    negb[0, :, 1] = [0, 1, 0, 0]
    order[1, :, 2] = [0, 5, 0, 5]           # identity rows only
    idx2 = torch.from_numpy(((order << 1) | negb).astype(np.int32))
    # a strided view, as ops/msm.py hands over
    idx2 = idx2.transpose(1, 2).contiguous().transpose(1, 2)

    prefix = kernels.scan_accumulate_mixed_plain(gname, packed, idx2)
    totals = kernels.scan_accumulate_mixed_total_plain(gname, packed, idx2)
    assert torch.equal(jac.flatten_coords(prefix)[0][:, :, rows - 1],
                       jac.flatten_coords(totals)[0])
    assert all(torch.equal(a, b) for a, b in zip(
        jac.flatten_coords(kernels.scan_accumulate_mixed(gname, packed, idx2)),
        jac.flatten_coords(prefix)))

    # the reference: gather + negate as msm._gather_packed, then mixed_add
    for b in range(batch):
        carry = rjac.infinity(rg.ops, (lanes,))
        for r in range(rows):
            coords = rmsm._gather_packed(
                rg, rpacked, jnp.asarray(order[b, r].astype(np.int32)),
                jnp.asarray(negb[b, r] != 0))
            cd = rg.coord_dim
            q = ((coords[0], coords[1]) if cd == 1 else
                 ((coords[0], coords[1]), (coords[2], coords[3])))
            ymax = coords[cd] if cd == 1 else coords[2] | coords[3]
            inf = jnp.max(ymax, axis=0) == 0
            carry = rjac.mixed_add(rg.ops, carry, q, q_inf_mask=inf)
            _same_point(carry, jac._map_coords(prefix, lambda c: c[:, b, r]))
        _same_point(carry, jac._map_coords(totals, lambda c: c[:, b]))
    # lane 0 of batch 0 sums P four times
    lane0 = jac._map_coords(totals, lambda c: c[:, 0, :1])
    assert tg.points_to_host(lane0) == [tg.host.mul(pts[7], 4)]


@pytest.mark.parametrize("gname", sorted(GROUPS))
def test_scan_accumulate(gname):
    """(h) against a Python loop of the reference's full add over the same
    gathered rows, at rows = 4, lanes = 8, batch = 2, with identity rows, a
    repeated point (the complete add doubles) and an inverse pair."""
    rg, tg = GROUPS[gname]
    rows, lanes, batch = 4, 8, 2
    pts = _points(tg, 7, 24)                    # pts[0] is the identity
    pts[9] = tg.host.neg(pts[8])
    rpts, tpts = _pair(rg, tg, pts)
    rng = np.random.default_rng(8)
    order = rng.integers(0, 24, size=(batch, rows, lanes))
    order[0, :, 0] = [7, 7, 7, 7]           # P, 2P, 3P, 4P
    order[0, :, 1] = [8, 9, 0, 8]           # P, P - P, identity, P
    order[1, :, 2] = [0, 0, 0, 0]           # identity rows only
    # a strided view, as ops/msm.py hands over
    idx = torch.from_numpy(order.astype(np.int32)).transpose(1, 2) \
        .contiguous().transpose(1, 2)

    prefix = kernels.scan_accumulate_plain(gname, tpts, idx)
    assert all(torch.equal(a, b) for a, b in zip(
        jac.flatten_coords(kernels.scan_accumulate(gname, tpts, idx)),
        jac.flatten_coords(prefix)))
    assert kernels.LAUNCHES["scan_accumulate"] == 0

    for b in range(batch):
        carry = rjac.infinity(rg.ops, (lanes,))
        for r in range(rows):
            at = jnp.asarray(order[b, r].astype(np.int32))
            carry = rjac.add(rg.ops, carry,
                             rjac._map_coords(rpts, lambda c: c[..., at]))
            _same_point(carry, jac._map_coords(prefix, lambda c: c[:, b, r]))
    host = tg.points_to_host(jac._map_coords(
        prefix, lambda c: c[:, 0, :, :2].reshape(8, -1)))
    p7, p8 = pts[7], pts[8]
    assert host[0::2] == [tg.host.mul(p7, k) for k in (1, 2, 3, 4)]
    assert host[1::2] == [p8, None, None, p8]


def test_wrappers_reject_wrong_operands():
    a = torch.zeros((8, 4), dtype=torch.int32)
    with pytest.raises(TypeError):
        kernels.mont_mul(tspec.FR, a.to(torch.int64), a)
    with pytest.raises(TypeError):
        kernels.mont_mul(tspec.FR, a[:7], a[:7])
    with pytest.raises(ValueError):
        kernels.add_points("G3", (a, a, a), (a, a, a))
    with pytest.raises(TypeError):
        kernels.scan_accumulate_mixed(
            "G1", torch.zeros((4, 15), dtype=torch.int32),
            torch.zeros((1, 1, 1), dtype=torch.int32))
    with pytest.raises(TypeError):
        kernels.scan_accumulate_mixed(
            "G1", torch.zeros((4, 16), dtype=torch.int32),
            torch.zeros((1, 1), dtype=torch.int32))
    with pytest.raises(TypeError):
        kernels.scan_accumulate("G1", (a, a, a),
                                torch.zeros((1, 1), dtype=torch.int32))
    with pytest.raises(TypeError):
        kernels.scan_accumulate("G1", (a[:, None], a[:, None], a[:, None]),
                                torch.zeros((1, 1, 1), dtype=torch.int32))


def test_constants_header_matches_spec():
    """The header the CUDA build is given holds the spec's constants."""
    text = kernels.constants_header()
    for tag, ts in (("FR", tspec.FR), ("FQ", tspec.FQ)):
        words = ", ".join(f"0x{(ts.p >> (32 * k)) & 0xFFFFFFFF:08x}u"
                          for k in range(8))
        assert f"#define {tag}_P_WORDS {{{words}}}" in text
        assert f"#define {tag}_N0INV 0x{ts.n0inv32:08x}u" in text
