"""The chains of (b) mont_mul and (d) add_points launches that run as one
kernel launch each (ops/kernels.py ``mont_pow``, ``inv``, ``batch_inv_rows``,
``window_table``, ``combine_windows``, ``lane_row_sums``, ``tree_sum``,
``prefix_sum``): their plain versions (what a wrapper runs for a CPU
tensor) against the JAX reference's functions word for word, the full
Fermat inversions against python ints, the callers' wrapper calls counted
(each loop is one call now), and bad operands refused.

The reference's point functions (``_window_table``, ``_scan_sum``,
``_hs_prefix``, ``tree_reduce``, ``_combine_windows``) run in one jitted
call per group on its plain XLA formula path, as its own tests run them on
the CPU.  Inputs come from seeded generators and go to both sides;
tolerance: exact."""

import functools
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from octopuszk_tpu.curves import bn254 as rbn, group_ops as rjac
from octopuszk_tpu.fields import fp as rfp, spec as rspec
from octopuszk_tpu.ops import msm as rmsm
from octopuszk_tpu.utils.bigint import ints_to_limbs

from octopuszk_tpu_torch import convert
from octopuszk_tpu_torch.curves import bn254, group_ops as jac
from octopuszk_tpu_torch.fields import fp, fp2, spec as tspec
from octopuszk_tpu_torch.ops import kernels, msm
from octopuszk_tpu_torch.utils.bigint import ints_to_words, words_to_ints

# The port's CPU path is many small tensor ops.  Several test processes
# share the cores, and torch's intra-op thread pools would oversubscribe
# them (each op many times slower), so each process keeps one thread.
torch.set_num_threads(1)

SPECS = {"fr": (rspec.FR, tspec.FR), "fq": (rspec.FQ, tspec.FQ)}
GROUPS = {"G1": (rbn.G1, bn254.G1), "G2": (rbn.G2, bn254.G2)}

# sizes of the point chains: a table of 3 windows of 3 bits; 37 points
# summed over 8 lanes (5 rows, 3 of padding); a prefix and a tree over 13
# points (odd: the tree adds the identity past the end); 4 windows
# combined with c = 5
W, OUTERC = 3, 3
SCAN_N, SCAN_WIDTH = 37, 8
FOLD_N = 13
NUM_WIN, C = 4, 5


def _field_both(vals):
    ref = jnp.asarray(ints_to_limbs(vals, 16))
    return ref, torch.from_numpy(ints_to_words(vals).copy())


def _same_field(ref, got):
    np.testing.assert_array_equal(np.asarray(ref), convert.field_to_ref(got))


def _same_points(ref, got):
    refs = [np.asarray(x) for x in jax.tree_util.tree_leaves(ref)]
    gots = jac.flatten_coords(convert.points_to_ref(got))
    assert len(refs) == len(gots)
    for r, g in zip(refs, gots):
        np.testing.assert_array_equal(r, g)


def _same_words(a, b):
    fa, fb = jac.flatten_coords(a), jac.flatten_coords(b)
    assert len(fa) == len(fb)
    for x, y in zip(fa, fb):
        assert torch.equal(x, y)


def _host_points(group, seed, n):
    rng = random.Random(seed)
    pts = [group.host.mul(group.generator_affine, rng.randrange(1, 1 << 64))
           for _ in range(n)]
    pts[1] = None                                # the identity
    return pts


@functools.lru_cache(maxsize=None)
def _inputs(gname):
    """Host points of every chain's input, seeded per group."""
    rg = GROUPS[gname][0]
    return {"base": rg.host.mul(rg.generator_affine, 12345),
            "scan": _host_points(rg, 21, SCAN_N),
            "fold": _host_points(rg, 22, FOLD_N),
            "wins": _host_points(rg, 23, NUM_WIN)}


def _port_inputs(gname):
    tg, h = GROUPS[gname][1], _inputs(gname)
    return {"base": tg.point_to_device(h["base"], "cpu"),
            **{k: tg.points_to_device(h[k], "cpu")
               for k in ("scan", "fold", "wins")}}


@functools.lru_cache(maxsize=None)
def _reference(gname):
    """The reference's five point functions on the inputs, one jitted call
    (one compile) per group; numpy leaves."""
    rg, h = GROUPS[gname][0], _inputs(gname)
    base = rjac._map_coords(rg.points_to_device([h["base"]]),
                            lambda c: c[..., 0])
    scan, fold, wins = (rg.points_to_device(h[k])
                        for k in ("scan", "fold", "wins"))

    @jax.jit
    def run(base, scan, fold, wins):
        return {"window_table": rmsm._window_table(rg, base, W, OUTERC),
                "scan_sum": rmsm._scan_sum(rg, scan, SCAN_N, SCAN_WIDTH),
                "hs_prefix": rmsm._hs_prefix(rg, fold, FOLD_N),
                "tree_reduce": rjac.tree_reduce(rg.ops, fold, FOLD_N),
                "combine_windows": rmsm._combine_windows(rg, wins, C)}

    return jax.tree_util.tree_map(np.asarray, run(base, scan, fold, wins))


@pytest.fixture
def spies(monkeypatch):
    """Counts the calls of every kernel wrapper (by name) while a test
    runs; the wrappers still run."""
    calls = dict.fromkeys(kernels.KERNEL_NAMES, 0)

    def wrap(name):
        real = getattr(kernels, name)

        def spy(*args, **kwargs):
            calls[name] += 1
            return real(*args, **kwargs)
        return spy

    for name in kernels.KERNEL_NAMES:
        monkeypatch.setattr(kernels, name, wrap(name))
    return calls


def _called(calls):
    return {k: v for k, v in calls.items() if v}


# ---------------------------------------------------------------------------
# (b): mont_pow, batch_inv_rows
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("e", [0, 1, 0b1011001, (1 << 40) + 3])
@pytest.mark.parametrize("field", sorted(SPECS))
def test_mont_pow_against_reference(field, e):
    rs, ts = SPECS[field]
    rng = random.Random(31)
    vals = [0, 1, ts.p - 1] + [rng.randrange(ts.p) for _ in range(9)]
    ra, ta = _field_both(vals)
    _same_field(rfp.pow_const(rs, ra, e), kernels.mont_pow_plain(ts, ta, e))


@pytest.mark.parametrize("field", sorted(SPECS))
def test_fermat_inversion_against_python_ints(field, spies):
    """fp.inv is one call of ``inv`` (whose plain version is the q - 2 (r -
    2) chain) and equals pow(x, p - 2, p); inv(0) = 0."""
    ts = SPECS[field][1]
    rng = random.Random(32)
    raw = [0, 1, 2, ts.p - 1] + [rng.randrange(ts.p) for _ in range(4)]
    a = torch.from_numpy(ints_to_words([ts.to_mont(v) for v in raw]).copy())
    got = fp.inv(ts, a)
    assert _called(spies) == {"inv": 1}
    want = [pow(v, ts.p - 2, ts.p) for v in raw]
    assert [ts.from_mont(v) for v in words_to_ints(got.numpy())] == want
    _same_words(got, kernels.mont_pow_plain(ts, a, ts.p_minus_2))


@pytest.mark.parametrize("field", sorted(SPECS))
def test_batch_inv_rows_against_reference(field, spies):
    """n = 301 with zeros: the plain version over 64 lanes (not a
    multiple), then fp.batch_inv_rows with and without the reference's lane
    argument (the wrapper's own lane count either way): one batch_inv_rows
    call each, the reference's words."""
    rs, ts = SPECS[field]
    rng = random.Random(33)
    vals = [rng.randrange(ts.p) for _ in range(301)]
    for i in (0, 5, 64, 300):
        vals[i] = 0
    ra, ta = _field_both(vals)
    want = rfp.batch_inv_rows(rs, ra, 64)
    _same_field(want, kernels.batch_inv_rows_plain(ts, ta, 64))
    _same_field(want, fp.batch_inv_rows(ts, ta, 64))
    _same_field(want, fp.batch_inv_rows(ts, ta))
    assert _called(spies) == {"batch_inv_rows": 2}


def test_fp2_inversions_are_one_call(spies):
    """fp2.inv reaches one inv, fp2.batch_inv_rows one batch_inv_rows
    (through the norm); both invert."""
    ts = tspec.FQ
    rng = random.Random(34)
    comps = [[rng.randrange(ts.p) for _ in range(6)] for _ in range(2)]
    comps[0][2] = comps[1][2] = 0                # zero -> zero
    a = tuple(torch.from_numpy(ints_to_words(c).copy()) for c in comps)
    inv1 = fp2.inv(ts, a)
    assert _called(spies)["inv"] == 1
    spies.update(dict.fromkeys(spies, 0))
    inv2 = fp2.batch_inv_rows(ts, a)
    assert spies["batch_inv_rows"] == 1 and spies["inv"] == 0
    _same_words(inv1, inv2)
    prod = fp2.mul(ts, a, inv2)
    one = [ts.r_mod_p] * 6
    one[2] = 0
    assert words_to_ints(prod[0].numpy()) == one
    assert not prod[1].any()


def test_points_to_packed_is_one_inversion(spies):
    tg = bn254.G2
    pts = tg.points_to_device(_host_points(tg, 35, 9), "cpu")
    packed = msm.points_to_packed(tg, pts)
    assert spies["batch_inv_rows"] == 1
    assert spies["mont_pow"] == 0 and spies["inv"] == 0
    back = tg.points_to_host(msm.packed_to_points(tg, packed))
    assert back == tg.points_to_host(pts)


def test_lagrange_is_one_batch_inversion(spies):
    """ntt.lagrange_coeffs inverts t - omega^i with one batch_inv_rows call
    (it took 2 log2 n mont_mul calls and a Fermat chain through
    fp.batch_inv), and t^n with one mont_pow; its values equal
    (t^n - 1) / n * omega^i / (t - omega^i) in python ints."""
    from octopuszk_tpu_torch.ops import ntt
    ts, n, t = tspec.FR, 64, 123456789
    got = ntt.lagrange_coeffs(
        ts, n, torch.from_numpy(ints_to_words([ts.to_mont(t)]).copy())[:, 0])
    assert spies["batch_inv_rows"] == 1 and spies["mont_pow"] == 1
    assert spies["inv"] == 0
    p, w = ts.p, ts.rou_of_order(n)
    zt = (pow(t, n, p) - 1) * pow(n, -1, p) % p
    want = [zt * pow(w, i, p) * pow(t - pow(w, i, p), -1, p) % p
            for i in range(n)]
    assert [ts.from_mont(v) for v in words_to_ints(got.numpy())] == want


# ---------------------------------------------------------------------------
# (d): window_table, lane_row_sums + tree_sum, prefix_sum, combine_windows
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("gname", sorted(GROUPS))
def test_window_table_against_reference(gname, spies):
    tg = GROUPS[gname][1]
    got = msm._window_table(tg, _port_inputs(gname)["base"], W, OUTERC)
    assert _called(spies) == {"double_points": 1, "window_table": 1}
    _same_points(_reference(gname)["window_table"], got)


@pytest.mark.parametrize("gname", sorted(GROUPS))
def test_scan_sum_against_reference(gname, spies):
    tg = GROUPS[gname][1]
    got = msm._scan_sum(tg, _port_inputs(gname)["scan"], SCAN_N, SCAN_WIDTH)
    assert _called(spies) == {"lane_row_sums": 1, "tree_sum": 1}
    _same_points(_reference(gname)["scan_sum"], got)


@pytest.mark.parametrize("gname", sorted(GROUPS))
def test_hs_prefix_against_reference(gname, spies):
    tg = GROUPS[gname][1]
    got = msm._hs_prefix(tg, _port_inputs(gname)["fold"], FOLD_N)
    assert _called(spies) == {"prefix_sum": 1}
    _same_points(_reference(gname)["hs_prefix"], got)


@pytest.mark.parametrize("gname", sorted(GROUPS))
def test_tree_reduce_against_reference(gname, spies):
    tg = GROUPS[gname][1]
    got = jac.tree_reduce(tg.ops, _port_inputs(gname)["fold"], FOLD_N)
    assert _called(spies) == {"tree_sum": 1}
    _same_points(_reference(gname)["tree_reduce"], got)


@pytest.mark.parametrize("gname", sorted(GROUPS))
def test_combine_windows_against_reference(gname, spies):
    tg = GROUPS[gname][1]
    got = msm._combine_windows(tg, _port_inputs(gname)["wins"], C)
    assert _called(spies) == {"combine_windows": 1}
    _same_points(_reference(gname)["combine_windows"], got)


@pytest.mark.parametrize("gname", sorted(GROUPS))
def test_batched_chains_match_per_row(gname):
    """A leading batch axis rides through each point chain: row b of the
    batched call equals the call on row b alone."""
    tg = GROUPS[gname][1]
    pts = tg.points_to_device(_host_points(tg, 36, 2 * 7), "cpu")
    rows = jac._map_coords(pts, lambda c: c.reshape(8, 2, 7))
    one = [jac._map_coords(rows, lambda c, b=b: c[:, b]) for b in range(2)]
    for fn in (lambda p: kernels.lane_row_sums(gname, p, 3),
               lambda p: kernels.tree_sum(gname, p),
               lambda p: kernels.prefix_sum(gname, p),
               lambda p: kernels.combine_windows(gname, p, 2)):
        both = fn(rows)
        for b in range(2):
            _same_words(jac._map_coords(both, lambda c: c[:, b]), fn(one[b]))


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

def test_new_wrappers_refuse_bad_operands():
    ts = tspec.FQ
    a = torch.zeros((8, 4), dtype=torch.int32)
    with pytest.raises(ValueError):
        kernels.mont_pow(ts, a, -1)
    with pytest.raises(ValueError):
        kernels.mont_pow(ts, a, 1 << 256)
    with pytest.raises(TypeError):
        kernels.mont_pow(ts, a.to(torch.int64), 3)
    with pytest.raises(TypeError):
        kernels.inv(ts, a.to(torch.int64))
    with pytest.raises(TypeError):
        kernels.inv(ts, a[:7])
    with pytest.raises(TypeError):
        kernels.batch_inv_rows(ts, a[:, :, None])
    with pytest.raises(TypeError):
        kernels.batch_inv_rows(ts, a[:7])
    with pytest.raises(TypeError):
        kernels.batch_inv_rows(ts, a.to(torch.int64))

    g1 = bn254.G1
    pts = g1.points_to_device(_host_points(g1, 37, 4), "cpu")
    base = g1.point_to_device(None, "cpu")
    powers = jac._map_coords(pts, lambda c: c[:, :2])
    with pytest.raises(TypeError):               # too few powers for 3 x 1
        kernels.window_table("G1", base, powers, 1, 4)
    with pytest.raises(TypeError):               # base is not one point
        kernels.window_table("G1", pts, pts, 1, 2)
    with pytest.raises(ValueError):
        kernels.window_table("G1", base, powers, 0, 1)
    with pytest.raises(ValueError):              # base on another device
        kernels.window_table("G1", jac._map_coords(base, lambda c: c.to(
            "meta")), powers, 1, 2)
    with pytest.raises(TypeError):               # a G2 point as G1
        kernels.tree_sum("G1", bn254.G2.points_to_device([None], "cpu"))
    with pytest.raises(ValueError):
        kernels.prefix_sum("G3", pts)
    with pytest.raises(TypeError):               # no last batch axis
        kernels.tree_sum("G1", jac._map_coords(pts, lambda c: c[:, 0]))
    with pytest.raises(ValueError):
        kernels.tree_sum("G1", jac._map_coords(pts, lambda c: c[:, :0]))
    with pytest.raises(ValueError):
        kernels.lane_row_sums("G1", pts, 5)
    with pytest.raises(ValueError):
        kernels.combine_windows("G1", pts, -1)
    with pytest.raises(ValueError):
        kernels.combine_windows("G1", jac._map_coords(pts, lambda c: c[:, :0]),
                                3)
    with pytest.raises(TypeError):
        kernels.combine_windows("G1", tuple(c.to(torch.int64) for c in pts), 3)
