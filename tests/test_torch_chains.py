"""Doubling chains: ``kernels.double_points(g, p, times, every_step)`` (one
launch per chain on the card; its plain version on the CPU) against the
JAX reference's double applied ``times`` times and the python-int host
oracle, and the three chains of ops/msm.py (``_abel``,
``_combine_windows``, ``_window_table``) against the one-double-per-call
loops they replace, word for word, with the wrapper calls counted.

The reference's G1 double is its Pallas kernel in interpret mode, as in
tests/test_torch_kernels.py; on G2 it is ``group_ops.double``, the formula
that kernel traces.  Inputs come from seeded generators and go to both
sides; tolerance: exact."""

import functools
import random

import jax
import numpy as np
import pytest
import torch

from octopuszk_tpu.curves import bn254 as rbn, group_ops as rjac
from octopuszk_tpu.ops import pallas_ops

from octopuszk_tpu_torch import convert
from octopuszk_tpu_torch.curves import bn254, group_ops as jac
from octopuszk_tpu_torch.ops import kernels, msm

# The port's CPU path is many small tensor ops.  Several test processes
# share the cores, and torch's intra-op thread pools would oversubscribe
# them (each op many times slower), so each process keeps one thread.
torch.set_num_threads(1)

GROUPS = {"G1": (rbn.G1, bn254.G1), "G2": (rbn.G2, bn254.G2)}


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("OCTOPUSZK_PALLAS", "interpret")
    pallas_ops.reset_mode_caches()
    yield
    monkeypatch.delenv("OCTOPUSZK_PALLAS")
    pallas_ops.reset_mode_caches()


def _host_points(group, seed, n):
    rng = random.Random(seed)
    pts = [group.host.mul(group.generator_affine, rng.randrange(1, 1 << 64))
           for _ in range(n)]
    pts[0] = None                                # the identity
    return pts


def _same_words(a, b):
    fa, fb = jac.flatten_coords(a), jac.flatten_coords(b)
    assert len(fa) == len(fb)
    for x, y in zip(fa, fb):
        assert torch.equal(x, y)


def _one_by_one(gname, p, times):
    """The chain as it was run before: one double per wrapper call."""
    for _ in range(times):
        p = kernels.double_points(gname, p)
    return p


@pytest.fixture
def counted(monkeypatch):
    """Counts the calls of kernels.double_points with their ``times``."""
    calls = []
    real = kernels.double_points

    def spy(gname, p, times=1, every_step=False):
        calls.append(times)
        return real(gname, p, times, every_step)

    monkeypatch.setattr(kernels, "double_points", spy)
    return calls


@functools.lru_cache(maxsize=None)
def _reference_double(gname):
    """The reference's double, jitted: one compile serves every call."""
    rg = GROUPS[gname][0]
    return jax.jit(lambda p: pallas_ops.double_points("G1", p)
                   if gname == "G1" else rjac.double(rg.ops, p))


@pytest.mark.parametrize("times", [1, 3])
@pytest.mark.parametrize("gname", sorted(GROUPS))
def test_chain_against_reference(gname, times, interpret):
    rg, tg = GROUPS[gname]
    pts = _host_points(tg, 7, 12)
    rp, tp = rg.points_to_device(pts), tg.points_to_device(pts, "cpu")
    for _ in range(times):
        rp = _reference_double(gname)(rp)
    got = kernels.double_points_plain(gname, tp, times=times)
    for r, g in zip(rjac._map_coords(rp, np.asarray),
                    convert.points_to_ref(got)):
        np.testing.assert_array_equal(r, g)
    # the wrapper takes the plain version for a CPU tensor, launches none
    kernels.reset_launch_counts()
    _same_words(kernels.double_points(gname, tp, times=times), got)
    assert kernels.LAUNCHES["double_points"] == 0


@pytest.mark.parametrize("gname", sorted(GROUPS))
def test_long_chains_against_host(gname):
    """The window table's chain (255 steps, every step kept) and the window
    combine's (17 steps) on one point, against the reference's python-int
    doublings (its host oracle)."""
    rg, tg = GROUPS[gname]
    rng = random.Random(8)
    p_host = rg.host.mul(rg.generator_affine, rng.randrange(1, 1 << 64))
    p = tg.point_to_device(p_host, "cpu")                  # shape [8]
    steps = kernels.double_points(gname, p, times=255, every_step=True)
    assert jac.leaf(steps).shape == (8, 255)
    want, host = [], p_host
    for _ in range(255):
        host = rg.host.add(host, host)
        want.append(host)
    assert tg.points_to_host(steps) == want
    last17 = kernels.double_points(gname, p, times=17)
    assert jac.leaf(last17).shape == (8,)
    _same_words(last17, jac._map_coords(steps, lambda c: c[..., 16]))


@pytest.mark.parametrize("gname", sorted(GROUPS))
def test_every_step_stacks_single_steps(gname):
    tg = GROUPS[gname][1]
    p = tg.points_to_device(_host_points(tg, 9, 5), "cpu")
    steps = kernels.double_points(gname, p, times=4, every_step=True)
    assert jac.leaf(steps).shape == (8, 5, 4)
    q = p
    for j in range(4):
        q = kernels.double_points(gname, q)
        _same_words(jac._map_coords(steps, lambda c: c[..., j]), q)
    _same_words(kernels.double_points(gname, p, times=4), q)


def test_times_below_one_is_refused():
    p = bn254.G1.points_to_device([None], "cpu")
    with pytest.raises(ValueError):
        kernels.double_points("G1", p, times=0)


@pytest.mark.parametrize("gname", sorted(GROUPS))
def test_abel(gname, counted):
    tg = GROUPS[gname][1]
    pts = tg.points_to_device(_host_points(tg, 10, 10), "cpu")
    cum = jac._map_coords(pts, lambda c: c.reshape(8, 2, 5))  # 2 windows
    for doublings, minus_last in ((3, False), (4, True)):
        counted.clear()
        got = msm._abel(tg, cum, doublings, minus_last)
        assert counted == [doublings]
        last = jac._map_coords(cum, lambda a: a[..., 4])
        rest = jac._map_coords(cum, lambda a: a[..., :4])
        shifted = _one_by_one(gname, last, doublings)
        if minus_last:
            shifted = tg.add(shifted, tg.negate(last))
        want = tg.add(shifted, tg.negate(msm._scan_sum(tg, rest, 4)))
        _same_words(got, want)


@pytest.mark.parametrize("gname", sorted(GROUPS))
def test_combine_windows(gname, counted):
    tg = GROUPS[gname][1]
    num_win, c = 4, 5
    wins = tg.points_to_device(_host_points(tg, 11, num_win), "cpu")
    got = msm._combine_windows(tg, wins, c)
    assert counted == []        # one combine_windows call, no chain of doubles
    acc = tg.infinity((), "cpu")    # from the identity, as the reference
    for idx in range(num_win - 1, -1, -1):
        acc = tg.add(_one_by_one(gname, acc, c),
                     jac._map_coords(wins, lambda a: a[..., idx]))
    _same_words(got, acc)


@pytest.mark.parametrize("gname", sorted(GROUPS))
def test_window_table(gname, counted):
    tg = GROUPS[gname][1]
    w, outerc = 3, 3
    base_host = tg.host.mul(tg.generator_affine, 12345)
    base = tg.point_to_device(base_host, "cpu")
    got = msm._window_table(tg, base, w, outerc)
    assert counted == [outerc * w]
    # the table as it was built before: one double per bit-step
    B, rows, g = 1 << w, [], base
    iota = torch.arange(B)
    counted.clear()
    for _ in range(outerc):
        row = tg.infinity((B,), "cpu")
        for b in range(w):
            has_bit = ((iota >> b) & 1) == 1
            row = tg.select(has_bit, tg.add(
                row, jac._map_coords(g, lambda c: c[..., None])), row)
            g = kernels.double_points(gname, g)
        rows.append(row)
    for win, row in enumerate(rows):
        _same_words(jac._map_coords(got, lambda c: c[:, win]), row)
    # and the entries are the multiples d * 2^(w * win) of the base
    flat = jac._map_coords(got, lambda c: c.reshape(8, outerc * B))
    want = [tg.host.mul(base_host, d << (w * win))
            for win in range(outerc) for d in range(B)]
    assert tg.points_to_host(flat) == want
