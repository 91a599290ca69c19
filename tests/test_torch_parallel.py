"""parallel/ of the PyTorch port against the JAX reference's parallel/ on
the CPU: the mesh and its collectives, the distributed NTT, the
distributed MSMs and distributed BACE.  The port's meshes are
``make_mesh(d, device="cpu")``; the reference's are the first d devices
of the 8-device CPU mesh that tests/conftest.py makes.  Field values
compare word for word (canonical), points as affine host ints (sort tie
order differs between the frameworks)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from octopuszk_tpu.curves import bn254 as rbn
from octopuszk_tpu.fields.spec import FR as RFR, NUM_LIMBS
from octopuszk_tpu.parallel import (
    dbace as rdbace, dmsm as rdmsm, dntt as rdntt, mesh as rpmesh)
from octopuszk_tpu.utils.bigint import ints_to_limbs

from octopuszk_tpu_torch import convert
from octopuszk_tpu_torch.curves import bn254, group_ops as jac
from octopuszk_tpu_torch.fields.spec import FR
from octopuszk_tpu_torch.models.bace import prover as bprover
from octopuszk_tpu_torch.models.bace import verifier as bverifier
from octopuszk_tpu_torch.models.bace.circuit import (
    Circuit, ConstantGate, InputGate, ProductGate, SumGate)
from octopuszk_tpu_torch.ops import kernels, msm, ntt
from octopuszk_tpu_torch.parallel import dbace, dmsm, dntt, mesh as pmesh

# The port's CPU path is many small tensor ops.  Several test processes
# share the cores, and torch's intra-op thread pools would oversubscribe
# them (each op many times slower), so each process keeps one thread.
torch.set_num_threads(1)

P = FR.p
KINDS = {"ntt": (False, False), "intt": (True, False),
         "coset_ntt": (False, True), "coset_intt": (True, True)}
SERIAL = {"ntt": ntt.ntt, "intt": ntt.intt, "coset_ntt": ntt.coset_ntt,
          "coset_intt": ntt.coset_intt}


@pytest.fixture(scope="module")
def rmeshes():
    assert len(jax.devices()) == 8
    return {d: rpmesh.make_mesh(jax.devices()[:d]) for d in (2, 4)}


def _mesh(d):
    return pmesh.make_mesh(d, device="cpu")


def _ref_mont(xs):
    """Host ints -> the reference's Montgomery limbs (numpy)."""
    return ints_to_limbs([RFR.to_mont(x) for x in xs], NUM_LIMBS)


def _ref_ints(xs):
    return ints_to_limbs(xs, NUM_LIMBS)


def _host(grp, p):
    return grp.points_to_host(jac._map_coords(p, lambda c: c[..., None]))[0]


def _rhost(grp, p):
    from octopuszk_tpu.curves import group_ops as rjac
    return grp.points_to_host(rjac._map_coords(p, lambda c: c[..., None]))[0]


def _rand_points(rng, grp, n):
    return [grp.host.mul(grp.generator_affine, rng.randrange(1, P))
            for _ in range(n)]


# ---------------------------------------------------------------------------
# the mesh and its collectives
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", [1, 2, 4])
def test_make_mesh_on_the_cpu(d):
    mesh = _mesh(d)
    assert mesh.size == d and mesh.devices == (torch.device("cpu"),) * d


def test_make_mesh_asks_for_the_card():
    """No CUDA device: the default mesh raises; it never falls back to the
    CPU."""
    with pytest.raises(RuntimeError, match="CUDA"):
        pmesh.make_mesh(4)
    with pytest.raises(ValueError):
        pmesh.make_mesh(0, device="cpu")


@pytest.mark.parametrize("d", [1, 2, 4])
def test_shard_unshard_and_gather(d, nprng):
    x = torch.from_numpy(nprng.integers(-2**31, 2**31, (8, 32),
                                        dtype=np.int64).astype(np.int32))
    xs = pmesh.shard_vector(_mesh(d), x)
    assert [tuple(s.shape) for s in xs] == [(8, 32 // d)] * d
    assert all(s.is_contiguous() for s in xs)
    assert torch.equal(torch.cat(xs, dim=1), x)
    assert torch.equal(pmesh.unshard(xs), x)
    assert all(torch.equal(g, x) for g in pmesh.all_gather(xs, axis=1))
    with pytest.raises(ValueError, match="do not split"):
        pmesh.shard_vector(_mesh(3), x)


@pytest.mark.parametrize("d", [2, 4])
@pytest.mark.parametrize("axes", [(2, 1), (1, 2)])
def test_all_to_all_equals_reference(d, axes, nprng, rmeshes):
    """The tiled all_to_all of the reference's shard_map bodies, on a
    [d * 4, 8] view of each shard's block."""
    from jax.sharding import PartitionSpec as RP
    split_axis, concat_axis = axes
    g = nprng.integers(0, 1 << 30, (3, 4 * d, 8 * d), dtype=np.int32)
    rmesh = rmeshes[d]

    @jax.jit
    def ref(x):
        return jax.shard_map(
            lambda b: jax.lax.all_to_all(b, rpmesh.AXIS, split_axis,
                                         concat_axis, tiled=True),
            mesh=rmesh, in_specs=RP(None, None, rpmesh.AXIS),
            out_specs=RP(None, None, rpmesh.AXIS))(x)

    want = np.asarray(ref(jnp.asarray(g)))
    xs = pmesh.shard_vector(_mesh(d), torch.from_numpy(g))
    got = pmesh.all_to_all(xs, split_axis, concat_axis)
    np.testing.assert_array_equal(
        np.concatenate([t.numpy() for t in got], axis=2), want)


@pytest.mark.parametrize("d", [1, 2, 4])
def test_psum_is_exact(d, nprng):
    parts = [torch.from_numpy(nprng.integers(0, 1 << 16, (16, 5)))
             for _ in range(d)]
    assert torch.equal(pmesh.psum(parts), sum(parts))


def test_replicate_and_shard_points():
    mesh = _mesh(4)
    g = bn254.G2
    pts = g.points_to_device([g.host.mul(g.generator_affine, k)
                              for k in range(1, 9)], "cpu")
    shards = pmesh.shard_point_batch(mesh, pts)
    assert sum((g.points_to_host(s) for s in shards), []) == \
        g.points_to_host(pts)
    rep = pmesh.replicate_point(mesh, pts)
    assert all(g.points_to_host(r) == g.points_to_host(pts) for r in rep)


# ---------------------------------------------------------------------------
# wrappers: operands on two devices raise on either path
# ---------------------------------------------------------------------------

def _meta(t):
    return torch.empty_like(t, device="meta")


@pytest.mark.parametrize("wrapper", [
    "mont_mul", "mul_sub", "butterfly", "ntt_block", "add_points",
    "window_table", "scan_accumulate_mixed", "scan_accumulate",
    "row_gather"])
def test_operands_on_two_devices_raise(wrapper):
    """The device check comes before the choice between the plain version
    and the kernel: a CPU operand beside one on another device (here the
    meta device) raises ValueError, as a CPU operand beside a CUDA one
    does."""
    a = torch.zeros((8, 4), dtype=torch.int32)
    m = _meta(a)
    pt = (a, a, a)
    mpt = (m, m, m)
    calls = {
        "mont_mul": lambda: kernels.mont_mul(FR, a, m),
        "mul_sub": lambda: kernels.mul_sub(FR, a, a, m),
        "butterfly": lambda: kernels.butterfly(FR, a, m, a, True),
        "ntt_block": lambda: kernels.ntt_block(
            FR, a.reshape(8, 4, 1), _meta(a[:, :2]), True),
        "add_points": lambda: kernels.add_points("G1", pt, mpt),
        "window_table": lambda: kernels.window_table(
            "G1", tuple(c[:, 0] for c in pt), mpt, 2, 2),
        "scan_accumulate_mixed": lambda: kernels.scan_accumulate_mixed(
            "G1", torch.zeros((4, 16), dtype=torch.int32),
            _meta(torch.zeros((1, 2, 2), dtype=torch.int32))),
        "scan_accumulate": lambda: kernels.scan_accumulate(
            "G1", pt, _meta(torch.zeros((1, 2, 2), dtype=torch.int32))),
        "row_gather": lambda: kernels.row_gather(
            torch.zeros((4, 16), dtype=torch.int32),
            _meta(torch.zeros(2, dtype=torch.int32))),
    }
    with pytest.raises(ValueError, match="different devices"):
        calls[wrapper]()


def test_launch_runs_on_the_operands_device(monkeypatch):
    """``_launch`` makes the operands' card current for the call and hands
    the entry point that card's current stream."""
    seen = []

    class FakeDevice:
        def __init__(self, device):
            seen.append(("device", device))

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    class FakeStream:
        cuda_stream = 1234

    monkeypatch.setattr(torch.cuda, "device", FakeDevice)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: seen.append(("stream", device))
                        or FakeStream())
    dev = torch.device("cuda", 3)
    rc = kernels._launch(lambda *args: seen.append(("args", args[:-1],
                                                    args[-1].value)) or 0,
                         dev, 7, 8)
    assert rc == 0
    assert seen == [("device", dev), ("stream", dev), ("args", (7, 8), 1234)]


# ---------------------------------------------------------------------------
# the distributed NTT
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", [2, 4])
@pytest.mark.parametrize("n", [64, 256])
@pytest.mark.parametrize("kind", ["ntt", "intt", "coset_ntt"])
def test_distributed_ntt_equals_reference(rng, rmeshes, d, n, kind):
    """Forward, inverse and coset against the reference's distributed NTT
    (6-12 s of XLA:CPU compile each); the coset iNTT is in the next test,
    against the port's serial transform."""
    inverse, coset = KINDS[kind]
    limbs = _ref_mont([rng.randrange(P) for _ in range(n)])
    rmesh = rmeshes[d]
    want = np.asarray(rdntt.distributed_ntt(
        rmesh, RFR, rpmesh.shard_vector(rmesh, jnp.asarray(limbs)),
        inverse=inverse, coset=coset))
    mesh = _mesh(d)
    got = dntt.distributed_ntt(
        mesh, FR, pmesh.shard_vector(mesh, convert.field_from_ref(limbs,
                                                                  "cpu")),
        inverse=inverse, coset=coset)
    assert [tuple(g.shape) for g in got] == [(8, n // d)] * d
    np.testing.assert_array_equal(convert.field_to_ref(pmesh.unshard(got)),
                                  want)


@pytest.mark.parametrize("d", [1, 2, 4])
@pytest.mark.parametrize("n", [64, 256])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_distributed_ntt_equals_serial(rng, d, n, kind):
    """Every direction and coset at d = 1 (the serial transform itself),
    2 and 4 against the port's serial transform."""
    inverse, coset = KINDS[kind]
    x = convert.field_from_ref(_ref_mont([rng.randrange(P)
                                          for _ in range(n)]), "cpu")
    mesh = _mesh(d)
    got = dntt.distributed_ntt(mesh, FR, pmesh.shard_vector(mesh, x),
                               inverse=inverse, coset=coset)
    assert torch.equal(pmesh.unshard(got), SERIAL[kind](FR, x))


def test_distributed_ntt_sizes():
    assert dntt._split_rc(64, 4) == (8, 8)
    assert dntt._split_rc(128, 4) == (16, 8)
    assert dntt._split_rc(16, 4) == (4, 4)
    with pytest.raises(ValueError, match="n >= d"):
        dntt._split_rc(8, 4)
    with pytest.raises(ValueError, match="power-of-two"):
        dntt._split_rc(48, 4)


def test_distributed_ntt_tables_are_kept(rng):
    """The shards' twiddle and coset tables are built once per field,
    size, shard, direction and device, and found again."""
    mesh = _mesh(4)
    x = pmesh.shard_vector(mesh, convert.field_from_ref(
        _ref_mont([rng.randrange(P) for _ in range(64)]), "cpu"))
    dntt.distributed_ntt(mesh, FR, x, coset=True)
    keys = {k for k in ntt._TABLES if k[0].startswith("dist-")}
    assert {(k[0], k[5] if k[0] == "dist-4-step" else k[4])
            for k in keys} >= {("dist-4-step", s) for s in range(4)} | {
        ("dist-coset", s) for s in range(4)}
    before = dict(ntt._TABLES)
    launches = []
    real = kernels.mont_mul
    try:
        kernels.mont_mul = lambda *a: launches.append(1) or real(*a)
        dntt.distributed_ntt(mesh, FR, x, coset=True)
    finally:
        kernels.mont_mul = real
    assert ntt._TABLES.keys() == before.keys()
    # the coset powers and the twiddles of each of the 4 shards: 8 products
    assert len(launches) == 8


# ---------------------------------------------------------------------------
# the distributed MSMs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", [1, 2, 4])
def test_distributed_pippenger(rng, d):
    """Kernel h per shard, then the tree across the shards (n = 32, c = 4,
    two lanes, as tests/test_parallel.py), against python-int arithmetic,
    which the reference's distributed_pippenger equals there (its compile
    alone takes 107 s on XLA:CPU at d = 2, the reference's serial
    pippenger_msm's about two minutes)."""
    grp = bn254.G1
    n = 32
    ks = [rng.randrange(P) for _ in range(n)]
    ks[0] = 0
    pts = _rand_points(rng, grp, n)
    pts[1] = None
    mesh = _mesh(d)
    got = dmsm.distributed_pippenger(
        mesh, grp, pmesh.shard_point_batch(mesh, grp.points_to_device(
            pts, "cpu")),
        pmesh.shard_vector(mesh, convert.field_from_ref(_ref_ints(ks),
                                                        "cpu")), 4, 2)
    assert _host(grp, got) == grp.host.naive_msm(ks, pts)


@pytest.fixture(scope="module")
def packed_case():
    """64 G1 points (one the identity) and scalars (one zero), the
    reference's distributed pack at d = 2 and its distributed packed MSM
    (the default dispatch, naive at this size: with c and lanes pinned its
    compile takes 116 s on XLA:CPU), and the host oracle."""
    import random
    rng = random.Random(77)
    grp, rgrp = bn254.G1, rbn.G1
    n = 64
    ks = [rng.randrange(P) for _ in range(n)]
    ks[0] = 0
    pts = _rand_points(rng, grp, n)
    pts[1] = None
    rmesh = rpmesh.make_mesh(jax.devices()[:2])
    rpacked = rdmsm.distributed_pack(rmesh, rgrp, rpmesh.shard_point_batch(
        rmesh, rgrp.points_to_device(pts)))
    rs = rpmesh.shard_vector(rmesh, jnp.asarray(_ref_ints(ks)))
    want = _rhost(rgrp, rdmsm.distributed_pippenger_packed(
        rmesh, rgrp, rpacked, rs))
    assert want == grp.host.naive_msm(ks, pts)
    return ks, pts, np.asarray(rpacked), want


@pytest.mark.parametrize("d", [2, 4])
def test_distributed_pack_equals_reference(packed_case, d):
    ks, pts, rpacked, _ = packed_case
    grp = bn254.G1
    mesh = _mesh(d)
    packed = dmsm.distributed_pack(mesh, grp, pmesh.shard_point_batch(
        mesh, grp.points_to_device(pts, "cpu")))
    assert [tuple(p.shape) for p in packed] == [(64 // d, 16)] * d
    assert torch.equal(torch.cat(packed), convert.packed_from_ref(
        rpacked, grp, "cpu"))


@pytest.mark.parametrize("how,d", [("pinned", 2), ("naive", 2),
                                   ("naive", 4), ("pippenger", 4)])
def test_distributed_pippenger_packed(packed_case, d, how, monkeypatch):
    """The reference's packed base, sharded by rows: with c and lanes
    pinned, by the default dispatch (the naive double-and-add at this
    size) and with ``NAIVE_THRESHOLD`` at 0 (the Pippenger pipeline, c and
    lanes chosen as the reference chooses them)."""
    ks, _, rpacked, want = packed_case
    grp = bn254.G1
    mesh = _mesh(d)
    packed = pmesh.shard_vector(mesh, convert.packed_from_ref(
        rpacked, grp, "cpu"), axis=0)
    scal = pmesh.shard_vector(mesh, convert.field_from_ref(_ref_ints(ks),
                                                           "cpu"))
    kw = {"c": 8, "lanes": 8} if how == "pinned" else {}
    if how == "pippenger":
        monkeypatch.setattr(msm, "NAIVE_THRESHOLD", 0)
    got = dmsm.distributed_pippenger_packed(mesh, grp, packed, scal, **kw)
    assert _host(grp, got) == want


@pytest.fixture(scope="module")
def fixed_case(rmeshes):
    """16 scalars and a base, the reference's distributed fixed-base MSM
    at d = 2 (35 s of XLA:CPU compile)."""
    import random
    rng = random.Random(81)
    grp, rgrp = bn254.G1, rbn.G1
    ks = [rng.randrange(P) for _ in range(16)]
    base = _rand_points(rng, grp, 1)[0]
    rmesh = rmeshes[2]
    want = rgrp.points_to_host(rdmsm.distributed_fixed_base_msm(
        rmesh, rgrp, rpmesh.replicate_point(rmesh,
                                            rgrp.point_to_device(base)),
        rpmesh.shard_vector(rmesh, jnp.asarray(_ref_ints(ks)))))
    return ks, base, want


@pytest.mark.parametrize("d", [1, 2, 4])
def test_distributed_fixed_base_equals_reference(fixed_case, d):
    grp = bn254.G1
    ks, base, want = fixed_case
    mesh = _mesh(d)
    tables = {}
    got = dmsm.distributed_fixed_base_msm(
        mesh, grp, pmesh.replicate_point(mesh, grp.point_to_device(base,
                                                                   "cpu")),
        pmesh.shard_vector(mesh, convert.field_from_ref(_ref_ints(ks),
                                                        "cpu")),
        tables=tables)
    assert len(got) == d and len(tables) == 1     # one table per device
    assert sum((grp.points_to_host(p) for p in got), []) == want == [
        grp.host.mul(base, k) for k in ks]


@pytest.fixture(scope="module")
def double_case():
    """128 scalars against G1 and G2 points (the identity at 1, a zero
    scalar at 0), as tests/test_parallel.py; the host oracle."""
    import random
    rng = random.Random(78)
    n = 128
    ks = [rng.randrange(P) for _ in range(n)]
    ks[0] = 0
    p1 = _rand_points(rng, bn254.G1, n)
    p2 = _rand_points(rng, bn254.G2, n)
    p1[1] = p2[1] = None
    return ks, p1, p2, (bn254.G1.host.naive_msm(ks, p1),
                        bn254.G2.host.naive_msm(ks, p2))


def test_distributed_double_msm(double_case):
    """The fused double MSM through the Pippenger pipeline, c and lanes
    pinned, two chunk rounds per shard, against python-int arithmetic,
    which the reference's fused double MSM equals in tests/test_parallel.py
    (its distributed packed MSM alone compiles for 116 s on XLA:CPU with c
    and lanes pinned).  The default dispatch at this size, naive, is every
    distributed prove's in tests/test_torch_dgroth16_crs.py."""
    ks, p1, p2, want = double_case
    g1, g2 = bn254.G1, bn254.G2
    mesh = _mesh(2)
    pk1 = dmsm.distributed_pack(mesh, g1, pmesh.shard_point_batch(
        mesh, g1.points_to_device(p1, "cpu")))
    pk2 = dmsm.distributed_pack(mesh, g2, pmesh.shard_point_batch(
        mesh, g2.points_to_device(p2, "cpu")))
    scal = pmesh.shard_vector(mesh, convert.field_from_ref(_ref_ints(ks),
                                                           "cpu"))
    # 64 rows a shard: two chunks of 32
    r1, r2 = dmsm.distributed_pippenger_double_packed(
        mesh, g1, g2, pk1, pk2, scal, c=8, lanes=8, chunk_log=5)
    assert (_host(g1, r1), _host(g2, r2)) == want


# ---------------------------------------------------------------------------
# distributed BACE
# ---------------------------------------------------------------------------

def _bace_circuit():
    x0, x1, x2 = InputGate(0), InputGate(1), InputGate(2)
    return Circuit(3, ProductGate(SumGate(ProductGate(x0, x1), x2),
                                  SumGate(x0, ConstantGate(7))))


@pytest.fixture(scope="module")
def bace_case():
    """K = 64 instances of a three-input circuit; the reference's
    distributed proof at d = 2, its verdicts on it and on a tampered one,
    and its results."""
    import random
    rng = random.Random(79)
    K = 64
    c_ref = _ref_circuit()
    limbs = _ref_mont([rng.randrange(P) for _ in range(3 * K)])
    rmesh = rpmesh.make_mesh(jax.devices()[:2])
    rproof = rdbace.distributed_compute_proof(rmesh, RFR, c_ref,
                                              jnp.asarray(limbs), K)
    return K, limbs, np.asarray(rproof)


def _ref_circuit():
    from octopuszk_tpu.models.bace.circuit import (
        Circuit as RC, ConstantGate as RK, InputGate as RI,
        ProductGate as RPG, SumGate as RS)
    x0, x1, x2 = RI(0), RI(1), RI(2)
    return RC(3, RPG(RS(RPG(x0, x1), x2), RS(x0, RK(7))))


@pytest.mark.parametrize("d", [1, 2, 4])
def test_distributed_bace_proof_equals_reference(bace_case, d):
    K, limbs, rproof = bace_case
    mesh = _mesh(d)
    inputs = convert.field_from_ref(limbs, "cpu")
    proof = dbace.distributed_compute_proof(mesh, FR, _bace_circuit(),
                                            inputs, K)
    assert len(proof) == d
    np.testing.assert_array_equal(convert.field_to_ref(pmesh.unshard(proof)),
                                  rproof)
    assert torch.equal(pmesh.unshard(proof), bprover.compute_proof(
        FR, _bace_circuit(), inputs, K))


@pytest.mark.parametrize("d", [2, 4])
def test_distributed_bace_verifier(bace_case, d):
    """Accepts the proof, rejects one with a coefficient changed, and
    reads the results the serial verifier reads."""
    K, limbs, rproof = bace_case
    mesh = _mesh(d)
    inputs = convert.field_from_ref(limbs, "cpu")
    c = _bace_circuit()
    proof = pmesh.shard_vector(mesh, convert.field_from_ref(rproof, "cpu"))
    assert dbace.distributed_verify_proof(mesh, FR, c, proof, inputs, K,
                                          seed=7)
    bad = [p.clone() for p in proof]
    bad[0][0, 3] ^= 1
    assert not dbace.distributed_verify_proof(mesh, FR, c, bad, inputs, K,
                                              seed=7)
    whole = pmesh.unshard(proof)
    assert torch.equal(dbace.distributed_get_result(mesh, FR, c, proof, K),
                       bverifier.get_result(FR, c, whole, K))


def test_distributed_bace_verifier_and_result_equal_reference(bace_case):
    """The reference's distributed verifier and get_result at d = 2 on the
    same proof."""
    K, limbs, rproof = bace_case
    rmesh = rpmesh.make_mesh(jax.devices()[:2])
    rc = _ref_circuit()
    rsharded = rpmesh.shard_vector(rmesh, jnp.asarray(rproof))
    assert rdbace.distributed_verify_proof(rmesh, RFR, rc, rsharded,
                                           jnp.asarray(limbs), K, seed=7)
    want = np.asarray(rdbace.distributed_get_result(rmesh, RFR, rc, rsharded,
                                                    K))
    mesh = _mesh(2)
    got = dbace.distributed_get_result(
        mesh, FR, _bace_circuit(),
        pmesh.shard_vector(mesh, convert.field_from_ref(rproof, "cpu")), K)
    np.testing.assert_array_equal(convert.field_to_ref(got), want)


def test_distributed_bace_small_k_takes_the_serial_intt():
    """K below d^2: the columns' iNTT is serial, the rest distributed; the
    proof still equals the serial prover's."""
    import random
    rng = random.Random(80)
    K = 8
    inputs = convert.field_from_ref(
        _ref_mont([rng.randrange(P) for _ in range(3 * K)]), "cpu")
    mesh = _mesh(4)
    proof = dbace.distributed_compute_proof(mesh, FR, _bace_circuit(),
                                            inputs, K)
    assert torch.equal(pmesh.unshard(proof), bprover.compute_proof(
        FR, _bace_circuit(), inputs, K))
    assert dbace.distributed_verify_proof(mesh, FR, _bace_circuit(), proof,
                                          inputs, K)
