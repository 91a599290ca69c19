"""Distributed MSMs over a mesh.

Port of ``octopuszk_tpu/parallel/dmsm.py``: each shard runs the serial
MSM over its block of points and scalars (``ops/msm.py``, on the shard's
device), then the shards' partial points are gathered on the first
shard's device and reduced there as the reference reduces them (stacked on
a last axis, padded with the identity to a power of two, one
``tree_reduce``; or, for the double MSM's window batches, a pairwise tree
of adds).  The fixed-base MSM is embarrassingly parallel: the window table
is built once per device, and the shards of one device are evaluated as one
batch (so are their naive double-and-add MSMs below the Pippenger
threshold): the same products, in fewer passes.

A sharded point batch, packed base or scalar vector is the list of its
per-shard tensors (``parallel/mesh.py``); a packed base has one point per
row, so a base of n points has n/d rows on each shard.  A result point
lies on the first shard's device (the reference's replicated point).
"""

from __future__ import annotations

import torch

from octopuszk_tpu_torch.curves import group_ops as jac
from octopuszk_tpu_torch.ops import msm
from octopuszk_tpu_torch.parallel import mesh as pmesh


def _gather_points(group, parts, device):
    """Single points (one per shard) stacked on a new last axis on
    ``device``: a batch [8, d]."""
    flats = [jac.flatten_coords(p) for p in parts]
    comps = [torch.stack([pmesh.place(f[k], device) for f in flats], dim=-1)
             for k in range(len(flats[0]))]
    return jac.rebuild_coords(comps, group.coord_dim)


def _reduce_partials(group, parts):
    """The shards' partial points summed on the first shard's device:
    gathered, padded with the identity to a power of two, one tree
    reduce."""
    device = jac.leaf(parts[0]).device
    gathered = _gather_points(group, parts, device)
    m = 1 << max(0, (len(parts) - 1).bit_length())
    gathered, _ = msm._pad_pow2_to(group, gathered, m)
    return group.tree_reduce(gathered, m)


def _pairwise_sum(group, parts):
    """Point batches of the same shape, one per shard, summed on the first
    shard's device by a pairwise tree of adds (an odd one out carried
    up)."""
    device = jac.leaf(parts[0]).device
    parts = [jac._map_coords(p, lambda c: pmesh.place(c, device))
             for p in parts]
    while len(parts) > 1:
        nxt = [group.add(parts[i], parts[i + 1])
               for i in range(0, len(parts) - 1, 2)]
        if len(parts) % 2:
            nxt.append(parts[-1])
        parts = nxt
    return parts[0]


def distributed_pippenger(mesh, group, points, scalars_raw,
                          c: int | None = None, lanes: int | None = None):
    """sum_i [s_i] P_i over sharded projective points and scalars: the
    sort-based Pippenger (kernel h) per shard, then the reduction.
    Returns one point."""
    local_n = scalars_raw[0].shape[-1]
    if c is None:
        c = msm._choose_c(max(2, local_n))
    if lanes is None:
        lanes = msm._choose_lanes(local_n)
    return _reduce_partials(group, [
        msm.pippenger_msm(group, p, s, c, lanes)
        for p, s in zip(points, scalars_raw)])


def _by_device(tensors):
    """Shard indices grouped by the device their tensor lies on, in shard
    order."""
    groups = {}
    for i, t in enumerate(tensors):
        groups.setdefault(t.device, []).append(i)
    return groups.values()


def _naive_packed(group, packed, scalars_raw):
    """Each shard's double-and-add MSM; the shards of one device run as one
    batch [8, shards, local] (the same products and per-shard tree reduce,
    in one pass) before the reduction across shards."""
    local = packed[0].shape[0]
    parts = [None] * len(packed)
    for idx in _by_device(scalars_raw):
        pts = msm.packed_to_points(group, torch.cat([packed[i] for i in idx]))
        scal = torch.cat([scalars_raw[i] for i in idx], dim=1)
        prods = jac._map_coords(group.scalar_mul(pts, scal),
                                lambda c: c.reshape(c.shape[0], len(idx),
                                                    local))
        sums = group.tree_reduce(prods, local)                  # [8, shards]
        for k, i in enumerate(idx):
            parts[i] = jac._map_coords(sums, lambda c: c[:, k])
    return _reduce_partials(group, parts)


def distributed_pippenger_packed(mesh, group, packed, scalars_raw,
                                 c: int | None = None,
                                 lanes: int | None = None,
                                 chunk_log: int = 22):
    """MSM over a sharded packed base (rows) and co-sharded scalars: the
    signed-digit Pippenger with the mixed-add scans per shard, then the
    reduction.  At or below ``msm.NAIVE_THRESHOLD`` points per shard (read
    at call time) each shard runs the naive double-and-add instead, unless
    the caller pins ``c`` or ``lanes``."""
    local_n = packed[0].shape[0]
    if c is None and lanes is None and local_n <= msm.NAIVE_THRESHOLD:
        return _naive_packed(group, packed, scalars_raw)
    if c is None:
        c = msm._choose_c_large(min(local_n, 1 << chunk_log))
    if lanes is None:
        num_chunks = max(1, -(-local_n // (1 << chunk_log)))
        lanes = min(1 << max(0, (local_n // num_chunks).bit_length() - 1),
                    4096)
    return _reduce_partials(group, [
        msm.pippenger_msm_packed(group, p, s, c, lanes, chunk_log)
        for p, s in zip(packed, scalars_raw)])


def distributed_pack(mesh, group, points):
    """Sharded projective points -> sharded packed affine rows, each shard
    its own (the batched inversion is local: no communication)."""
    return [msm.points_to_packed(group, p) for p in points]


def distributed_fixed_base_msm(mesh, group, base_point, scalars_raw,
                               w: int | None = None, tables=None):
    """[s_i] G for sharded scalars; ``base_point``: the point replicated
    (``mesh.replicate_point``), one copy per shard.  The result stays
    sharded.  ``tables``: a dict kept by the caller for this base point,
    in which the window table of each device and batch size is built once
    and found again (one table per device, whatever the shards on it)."""
    local_n = scalars_raw[0].shape[-1]
    tables = {} if tables is None else tables
    out = [None] * len(scalars_raw)
    for idx in _by_device(scalars_raw):
        # the shards of one device as one batch: the evaluation is
        # elementwise, so each shard's points are those of its own call
        key = (group.name, local_n, w, scalars_raw[idx[0]].device)
        if key not in tables:
            tables[key] = msm.fixed_base_table(group, base_point[idx[0]],
                                               local_n, w)
        pts = msm.fixed_base_msm(
            group, base_point[idx[0]],
            torch.cat([scalars_raw[i] for i in idx], dim=1),
            table=tables[key])
        for k, i in enumerate(idx):
            out[i] = jac._map_coords(
                pts, lambda c: c[..., k * local_n:(k + 1) * local_n])
    return out


def distributed_pippenger_double_packed(mesh, g1, g2, packed1, packed2,
                                        scalars_raw, c: int | None = None,
                                        lanes: int | None = None,
                                        chunk_log: int = 22):
    """One scalar vector against sharded packed G1 and G2 bases: per chunk
    round, each shard extracts and sorts its digits once and runs both
    groups' window pipelines from them; the shards' window batches are
    summed by a pairwise tree, the rounds added, and the windows combined
    once per group.  Returns (G1 point, G2 point)."""
    local_n = packed1[0].shape[0]
    if packed2[0].shape[0] != local_n:
        raise ValueError(f"bases of {local_n} and {packed2[0].shape[0]} "
                         "rows per shard")
    if c is None and lanes is None and local_n <= msm.NAIVE_THRESHOLD:
        return (_naive_packed(g1, packed1, scalars_raw),
                _naive_packed(g2, packed2, scalars_raw))
    num_chunks, lanes, chunk_m, m_total = msm._plan_packed(local_n, lanes,
                                                           chunk_log)
    if m_total != local_n:
        raise ValueError(f"{local_n} rows per shard do not tile into "
                         f"{num_chunks} chunks of {lanes} lanes")
    rows = chunk_m // lanes
    if c is None:
        c = msm._choose_c_large(chunk_m)
    num_win = -(-255 // c)
    groups = (g1, g2)
    acc = [None, None]
    for k in range(num_chunks):
        lo, hi = k * chunk_m, (k + 1) * chunk_m
        wins = ([], [])
        for p1, p2, s in zip(packed1, packed2, scalars_raw):
            s = msm._pad_scalars(s, local_n)
            d_sorted, idx2s = msm._sorted_digits(s[:, lo:hi], num_win, c)
            for gi, packed in enumerate((p1, p2)):
                chunk = pmesh.place(packed[lo:hi], s.device)
                wins[gi].append(msm._window_msm_mixed(
                    groups[gi], chunk, d_sorted, idx2s, c, lanes, rows))
        for gi, g in enumerate(groups):
            w = _pairwise_sum(g, wins[gi])
            acc[gi] = w if acc[gi] is None else g.add(acc[gi], w)
    return tuple(msm._combine_windows(g, a, c) for g, a in zip(groups, acc))
