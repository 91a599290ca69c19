"""Multi-scalar multiplication (fixed-base and variable-base).

* **Fixed-base batch MSM** (``fixed_base_msm``): one base point G, many
  scalars; returns [s_i]G for each i.  The window table is built on the
  device by doubling; large batches pack the table into affine rows and
  evaluate with one ``scan_accumulate_mixed_total`` launch (one lane per
  scalar, one row per window).  ``fixed_base_msm_packed`` (setup's) runs
  it in chunks of 2^FIXED_CHUNK_LOG scalars into packed affine rows.

* **Variable-base Pippenger over a packed base** (``pippenger_msm_packed``,
  ``pippenger_double_msm_packed``): signed windowed digits, one stable sort
  per window (all windows of a chunk in one call), then bucket accumulation
  as a two-level segmented prefix scan:
    1. lane-parallel serial scan over rows (``scan_accumulate_mixed``, all
       windows in one launch; the kernel gathers the sorted rows itself);
    2. bucket sums are differences of prefix values at segment ends;
    3. Abel summation turns sum_b b * S_b into one doubling chain and one
       plain sum over the bucket axis;
    4. window results combine MSB-first with c doublings per window.

* **Variable-base Pippenger over an unpacked point batch**
  (``pippenger_msm``): unsigned c-bit digits, one stable argsort per window
  (all windows in one call), then the same two-level segmented prefix scan
  with the full projective add (``scan_accumulate``, which repacks the
  points into rows once and reads them through the sorted order itself).  ``pippenger_msm_large`` packs an
  unpacked batch and runs the packed pipeline.

* **Host-streamed packed MSMs**: the packed MSMs run on the scalars'
  device and stage a base kept in host memory there one chunk at a time;
  ``pippenger_msm_packed_stream`` and ``pippenger_double_msm_packed_stream``
  keep the reference's names for this and place the scalars on a device.

* **Naive MSM** (``msm_naive``): batched double-and-add + tree reduce, used
  below ``NAIVE_THRESHOLD`` points.

* **Host algorithms** (python ints): ``pippenger_host``,
  ``sorted_msm_host``, ``bos_coster_msm_host`` and their partitioned
  ``distributed_*_msm_host`` wrappers.

Points are projective word-tensor batches (curves/bn254.py); scalars are
raw (non-Montgomery) ``int32[8, n]`` words.  A packed base is one affine
point per row: ``int32[n, 16]`` for G1 (X, Y), ``int32[n, 32]`` for G2
(X.c0, X.c1, Y.c0, Y.c1); the identity is the all-zero row (no point of an
odd-order subgroup has Y = 0).
"""

from __future__ import annotations

import collections
import dataclasses

import torch

from octopuszk_tpu_torch.curves import group_ops as jac
from octopuszk_tpu_torch.fields import fp
from octopuszk_tpu_torch.ops import kernels
from octopuszk_tpu_torch.utils import device as _device
from octopuszk_tpu_torch.utils.bigint import NUM_WORDS, WORD_BITS

SCALAR_BITS = 254


def _map_coords(point, fn):
    return jac._map_coords(point, fn)


def _batch_n(points):
    return jac.leaf(points).shape[-1]


# ---------------------------------------------------------------------------
# naive reference
# ---------------------------------------------------------------------------

def msm_naive(group, points, scalars_raw):
    """Sum_i [s_i] P_i via batched double-and-add + tree reduction."""
    prods = group.scalar_mul(points, scalars_raw)
    return group.tree_reduce(prods, _batch_n(points))


# ---------------------------------------------------------------------------
# digit extraction
# ---------------------------------------------------------------------------

def _digits(scalars_raw, c: int, num_win: int):
    """int64[num_win, n]: c-bit windows of each scalar, LSB window first."""
    u = scalars_raw.to(torch.int64) & 0xFFFFFFFF
    u = torch.cat([u, torch.zeros_like(u[:1])], dim=0)
    mask = (1 << c) - 1
    out = []
    for j in range(num_win):
        word, off = divmod(c * j, WORD_BITS)
        lo = u[word] >> off
        if off + c > WORD_BITS:
            lo = lo | (u[word + 1] << (WORD_BITS - off))
        out.append(lo & mask)
    return torch.stack(out)


def _signed_digits(scalars_raw, c: int, num_win: int):
    """Signed windowed digits: magnitudes in [0, 2^(c-1)] and sign bits.

    d_j in (-2^(c-1), 2^(c-1)]: if the raw c-bit digit (plus carry) is
    > 2^(c-1) it becomes d - 2^c and carries 1 into the next window.
    Requires num_win*c >= 255 so the final carry is absorbed."""
    assert num_win * c >= 255, (num_win, c)
    digits = _digits(scalars_raw, c, num_win)
    half, full = 1 << (c - 1), 1 << c
    mags, negs = [], []
    carry = torch.zeros_like(digits[0])
    for j in range(num_win):
        d = digits[j] + carry
        go = d > half
        mags.append(torch.where(go, full - d, d))
        carry = go.to(torch.int64)
        negs.append(carry)
    return torch.stack(mags), torch.stack(negs)


# ---------------------------------------------------------------------------
# fixed-base batch MSM
# ---------------------------------------------------------------------------

def _window_table(group, base_point, w: int, outerc: int):
    """Multiples table: T[win][d] = [d * 2^(w*win)] G, coords [8, outerc,
    2^w].  Per window, w bit-steps add [2^b]G_win into every table slot
    whose digit has bit b set, all in one ``window_table`` launch.  The
    powers [2^j]G come from one doubling chain (the last of its outerc * w
    steps is not used)."""
    powers = kernels.double_points(group.ops.group_name, base_point,
                                   times=outerc * w, every_step=True)
    return kernels.window_table(group.ops.group_name, base_point, powers, w,
                                outerc)


def _choose_w(n: int) -> int:
    """Fixed-base window width from the batch size: minimize
    (254/w)*(n + w*2^w), table build plus evaluation in point adds."""
    def cost(w):
        return (-(-SCALAR_BITS // w)) * (n + w * (1 << w))

    return min(range(4, 15), key=cost)


# batch size from which fixed-base evaluation switches to the packed path
# (affine table rows + the fused mixed-add accumulation); below it the
# table and pack overhead does not amortize
FIXED_PACKED_MIN = 1 << 14
# scalars a chunk of ``fixed_base_msm_packed``: the reference's name, not
# its value (2^17, sized for a TPU's 16 GB).  The card holds 80 GB, five
# times as much; 2^21 keeps the main path's 2^21-scalar queries at one
# chunk and bounds the transients of a 2^25-scalar query to a sixteenth
FIXED_CHUNK_LOG = 21


def _choose_w_packed(n: int) -> int:
    """Window width for the packed fixed-base path, over a wider range (the
    packed table is byte-dense)."""
    def cost(w):
        return (-(-SCALAR_BITS // w)) * (n + w * (1 << w))

    return min(range(8, 17), key=cost)


@dataclasses.dataclass(frozen=True)
class FixedBaseTable:
    """The window table of one base point: projective coords [8, outerc,
    2^w] below ``FIXED_PACKED_MIN`` scalars, packed affine rows
    int32[outerc * 2^w, 16 | 32] (entry win * 2^w + d = [d * 2^(w*win)] G,
    identity at d = 0) from there up."""

    w: int
    outerc: int
    packed: bool
    data: object


def fixed_base_table(group, base_point, n: int, w: int | None = None):
    """Build the table that ``fixed_base_msm`` uses for a batch of n
    scalars; one table serves every batch of that size on the same base."""
    packed = n >= FIXED_PACKED_MIN
    if w is None:
        w = _choose_w_packed(n) if packed else _choose_w(n)
    outerc = (SCALAR_BITS + w - 1) // w
    data = _window_table(group, base_point, w, outerc)
    if packed:
        data = points_to_packed(group, _map_coords(
            data, lambda c: c.reshape(NUM_WORDS, outerc << w)))
    return FixedBaseTable(w=w, outerc=outerc, packed=packed, data=data)


def fixed_base_msm(group, base_point, scalars_raw, w: int | None = None,
                   table: FixedBaseTable | None = None):
    """[s_i] G for one base G and a batch of scalars: int32[8, n] -> batch.

    Large batches (n >= FIXED_PACKED_MIN) take the packed path: one
    accumulation launch with one lane per scalar and one row per window.
    ``table``: a table from ``fixed_base_table`` for this base and batch
    size (built here when not given)."""
    n = scalars_raw.shape[1]
    if table is None:
        table = fixed_base_table(group, base_point, n, w)
    digits = _digits(scalars_raw, table.w, table.outerc)      # [outerc, n]
    if table.packed:
        return _fixed_base_msm_packed(group, table, digits)
    acc = group.infinity((n,), scalars_raw.device)
    for win in range(table.outerc):
        pts = _map_coords(table.data, lambda c: c[:, win][:, digits[win]])
        acc = group.add(acc, pts)
    return acc


def fixed_base_msm_packed(group, table: FixedBaseTable, scalars_raw,
                          pad_to: int):
    """[s_i] G as packed affine rows int32[pad_to, 16 | 32], identity rows
    past n, for the base of ``table`` (``fixed_base_table`` for the whole
    batch): ``fixed_base_msm`` then ``points_to_packed`` on chunks of
    2^FIXED_CHUNK_LOG scalars, each written into the one output allocated
    up front, so that only a chunk's digits, points and affine conversion
    are transient.  An affine point has one form, so the rows do not depend
    on the chunk."""
    n = scalars_raw.shape[1]
    out = torch.empty((pad_to, 2 * NUM_WORDS * group.coord_dim),
                      dtype=torch.int32, device=scalars_raw.device)
    out[n:] = 0
    chunk = 1 << FIXED_CHUNK_LOG
    for lo in range(0, n, chunk):
        hi = min(n, lo + chunk)
        pts = fixed_base_msm(group, None, scalars_raw[:, lo:hi], table=table)
        out[lo:hi] = points_to_packed(group, pts)
    return out


def _fixed_base_msm_packed(group, table: FixedBaseTable, digits):
    """Packed fixed-base evaluation from per-window digits [outerc, n]."""
    win_off = torch.arange(table.outerc, device=digits.device)[:, None] \
        << table.w
    idx2 = ((digits + win_off) << 1).to(torch.int32)[None]   # [1, outerc, n]
    tot = kernels.scan_accumulate_mixed_total(
        group.ops.group_name, table.data, idx2)
    return _map_coords(tot, lambda c: c[:, 0])


def double_batch_msm(g1_group, g2_group, base_g1, base_g2, scalars_raw,
                     w: int | None = None):
    """[s_i]G1 and [s_i]G2 for the same scalars: two fixed-base MSMs."""
    return (fixed_base_msm(g1_group, base_g1, scalars_raw, w),
            fixed_base_msm(g2_group, base_g2, scalars_raw, w))


def field_batch_msm(spec, base_mont, scalars_mont):
    """Elementwise scalars[i] * base over a prime field (both Montgomery)."""
    return fp.mont_mul(spec, scalars_mont, base_mont[:, None])


# ---------------------------------------------------------------------------
# packed bases
# ---------------------------------------------------------------------------

def pack_affine_rows(group, x, y):
    """Affine coordinates -> int32[n, 16 | 32] rows (X words then Y words;
    the identity is (0, 0))."""
    flat = jac.flatten_coords((x, y))
    return torch.cat(flat, dim=0).T.contiguous()


def points_to_packed(group, points, pad_to: int | None = None):
    """Projective point batch -> packed rows int32[pad_to, 16 | 32].

    Affine conversion via the O(n) two-level batched inverse; padding
    appends identity rows."""
    n = _batch_n(points)
    x, y, _ = jac.to_affine_fast(group.ops, points)   # identity -> (0, 0)
    packed = pack_affine_rows(group, x, y)
    if pad_to is not None and pad_to != n:
        pad = torch.zeros((pad_to - n, packed.shape[1]), dtype=packed.dtype,
                          device=packed.device)
        packed = torch.cat([packed, pad], dim=0)
    return packed


def packed_to_points(group, packed):
    """Packed affine rows -> projective point batch [n]; all-zero rows map
    to the projective identity (0, 1, 0)."""
    cd = group.coord_dim
    n = packed.shape[0]
    comps = list(packed.T.reshape(2 * cd, NUM_WORDS, n).unbind(0))
    x, y = jac.rebuild_coords(comps, cd)
    inf = group.ops.is_zero(y)
    ident = group.infinity((n,), packed.device)
    one = group.ops.one((n,), packed.device)
    return group.select(inf, ident, (x, y, one))


# ---------------------------------------------------------------------------
# variable-base Pippenger (signed digits, packed base)
# ---------------------------------------------------------------------------

def _hs_prefix(group, p, n: int):
    """Inclusive prefix sums along the last axis (Hillis-Steele: level l
    adds element j - 2^l into element j), one ``prefix_sum`` launch."""
    assert _batch_n(p) == n, (_batch_n(p), n)
    return kernels.prefix_sum(group.ops.group_name, p)


def _shift_right_inf(group, p):
    """Shift a point batch right by one along the last axis, filling slot 0
    with the identity (exclusive-prefix helper)."""
    return jac._shift_points(group.ops, p, 1, False)


def _scan_sum(group, p, n: int, width: int = 2048):
    """Sum n points along the last axis in O(n) adds: a serial scan over
    rows of ``width`` lanes from the identity (lane l owns positions
    [l*rows, (l+1)*rows), the identity pads the last), one
    ``lane_row_sums`` launch, then the tree across lanes."""
    assert _batch_n(p) == n, (_batch_n(p), n)
    width = min(width, n)
    totals = kernels.lane_row_sums(group.ops.group_name, p, width)
    return group.tree_reduce(totals, width)


def _bucket_sums(group, prefix, d_sorted, B: int, lanes: int, rows: int):
    """Per-window cumulative bucket sums from the lane-parallel prefix scan.

    ``prefix`` [8, num_win, rows, lanes]: inclusive prefixes of the sorted
    points (lane l owns sorted positions [l*rows, (l+1)*rows));
    ``d_sorted`` int64[num_win, m]: the sorted bucket ids.  Returns
    cum [8, num_win, B], cum[b] = sum of the points with id <= b."""
    num_win = d_sorted.shape[0]
    dev = d_sorted.device
    lane_totals = _map_coords(prefix, lambda a: a[:, :, rows - 1])
    excl = _shift_right_inf(group, _hs_prefix(group, lane_totals, lanes))

    # segment-end positions: e_b = (# elements with id <= b) - 1
    bucket_ids = torch.arange(B, device=dev).expand(num_win, B).contiguous()
    e = torch.searchsorted(d_sorted, bucket_ids, right=True) - 1
    valid = e >= 0
    eg = e.clamp(min=0)
    win = torch.arange(num_win, device=dev)[:, None]
    lane, row = eg // rows, eg % rows
    within_at = ((win * rows + row) * lanes + lane).reshape(-1)
    lane_at = (win * lanes + lane).reshape(-1)

    def take(a, at):
        return a.reshape(NUM_WORDS, -1)[:, at].reshape(NUM_WORDS, num_win, B)

    cum = group.add(_map_coords(prefix, lambda a: take(a, within_at)),
                    _map_coords(excl, lambda a: take(a, lane_at)))
    return group.select(valid, cum, group.infinity((num_win, B), dev))


def _abel(group, cum, doublings: int, minus_last: bool):
    """sum_b b*S_b over B = len(cum) buckets, S_b = cum[b] - cum[b-1]:
    (B-1)*cum[B-1] - sum_{b<B-1} cum[b].  (B-1)*cum[B-1] is ``doublings``
    doublings of cum[B-1], less cum[B-1] once when ``minus_last``."""
    B = jac.leaf(cum).shape[-1]
    last = _map_coords(cum, lambda a: a[..., B - 1])
    rest = _map_coords(cum, lambda a: a[..., :B - 1])
    sum_rest = _scan_sum(group, rest, B - 1)
    shifted = last
    if doublings:
        shifted = kernels.double_points(group.ops.group_name, last,
                                        times=doublings)
    if minus_last:
        shifted = group.add(shifted, group.negate(last))
    return group.add(shifted, group.negate(sum_rest))


def _window_msm_mixed(group, packed, d_sorted, idx2s, c: int, lanes: int,
                      rows: int):
    """All signed-digit Pippenger windows of one chunk over a packed base.

    ``d_sorted`` int64[num_win, m]: each window's sorted bucket magnitudes;
    ``idx2s`` int32[num_win, m]: the matching (point index << 1) | negate.
    The windows are independent and ride a leading batch dimension through
    every step.  Returns a point batch [8, num_win]."""
    num_win = d_sorted.shape[0]
    # lane l owns sorted positions [l*rows, (l+1)*rows)
    idx_rows = idx2s.view(num_win, lanes, rows).transpose(1, 2)
    prefix = kernels.scan_accumulate_mixed(
        group.ops.group_name, packed, idx_rows)   # [8, num_win, rows, lanes]
    # bucket ids 0..2^(c-1); 0 = skip.  M = 2^(c-1) = 2^(c-1) doublings
    cum = _bucket_sums(group, prefix, d_sorted, (1 << (c - 1)) + 1, lanes,
                       rows)
    del prefix
    return _abel(group, cum, c - 1, minus_last=False)


def _choose_c_large(chunk_m: int) -> int:
    """Signed-window width: bucket phase ~2*2^(c-1) adds per window-chunk
    vs chunk_m scan adds; c = log2(chunk_m) - 4 keeps it ~6%."""
    return max(8, min(17, chunk_m.bit_length() - 1 - 4))


def _plan_packed(n: int, lanes: int | None, chunk_log: int):
    """Chunk plan shared by packing and execution: (num_chunks, lanes,
    chunk_m, m_total).  The same plan as the reference's, so that packed
    bases of the two packages have the same padded length."""
    num_chunks = max(1, -(-n // (1 << chunk_log)))
    if lanes is None:
        lanes = min(1 << max(0, (n // num_chunks).bit_length() - 1), 4096)
    lanes = max(lanes, 4)
    chunk_m = lanes * (-(-n // (num_chunks * lanes)))
    return num_chunks, lanes, chunk_m, num_chunks * chunk_m


def _msm_pad_to(group, n, lanes, chunk_log):
    return _plan_packed(n, lanes, chunk_log)[3]


# below this size the naive double-and-add replaces the Pippenger pipeline
# (the bucket machinery cannot win at tiny n).  Pinning c/lanes forces
# Pippenger.
NAIVE_THRESHOLD = 1 << 10


def _sorted_digits(scalars_chunk, num_win: int, c: int):
    """Signed digits + one stable sort per window for a chunk: returns
    (d_sorted int64[num_win, m], idx2s int32[num_win, m]) with idx2s =
    (source index << 1) | negbit."""
    mag, neg = _signed_digits(scalars_chunk, c, num_win)
    d_sorted, order = torch.sort(mag, dim=1, stable=True)
    idx2s = (order << 1) | neg.gather(1, order)
    return d_sorted, idx2s.to(torch.int32)


def _combine_windows(group, window_results, c: int):
    """MSB-first window combination from the identity: acc = [2^c] acc +
    W_j, one ``combine_windows`` launch."""
    return kernels.combine_windows(group.ops.group_name, window_results, c)


# bytes the packed MSMs staged from host memory, by the device they were
# staged to (a base kept in host memory is copied there chunk by chunk)
STAGED_BYTES = collections.Counter()


def _msm_large_packed(groups, packeds, scalars_raw, num_win: int, c: int,
                      lanes: int, rows: int):
    """MSMs of the same scalars against one packed base per group (one for
    a single MSM, G1 and G2 for the prover's double MSM): digit extraction
    and the per-window sort run once per chunk and drive every group's
    bucket pipeline.  Each chunk of a base is staged to the scalars' device
    (a no-op for a base already there; from host memory, one copy per
    chunk).  Returns one point per group."""
    device = scalars_raw.device
    chunk_m = lanes * rows
    num_chunks = packeds[0].shape[0] // chunk_m
    acc = [None] * len(groups)
    for k in range(num_chunks):
        lo, hi = k * chunk_m, (k + 1) * chunk_m
        d_sorted, idx2s = _sorted_digits(scalars_raw[:, lo:hi], num_win, c)
        for i, (group, packed) in enumerate(zip(groups, packeds)):
            chunk = packed[lo:hi]
            if chunk.device != device:
                STAGED_BYTES[str(device)] += chunk.nbytes
                chunk = chunk.to(device, non_blocking=True)
            w = _window_msm_mixed(group, chunk, d_sorted, idx2s, c, lanes,
                                  rows)
            acc[i] = w if acc[i] is None else group.add(acc[i], w)
    return [_combine_windows(g, a, c) for g, a in zip(groups, acc)]


def _pad_scalars(scalars_raw, m: int):
    """Append zero scalars up to m columns."""
    if scalars_raw.shape[1] == m:
        return scalars_raw
    pad = torch.zeros((NUM_WORDS, m - scalars_raw.shape[1]),
                      dtype=scalars_raw.dtype, device=scalars_raw.device)
    return torch.cat([scalars_raw, pad], dim=1)


def _pippenger_packed(groups, packeds, scalars_raw, c, lanes, chunk_log):
    """The work runs on the scalars' device.  A base lies there or in host
    memory (then it is staged chunk by chunk); a base on any other device
    is refused rather than moved."""
    n = packeds[0].shape[0]
    device = scalars_raw.device
    for packed in packeds:
        assert packed.shape[0] == n, [tuple(p.shape) for p in packeds]
        if packed.device != device and packed.device.type != "cpu":
            raise ValueError(f"the base lies on {packed.device}, the scalars "
                             f"on {device}: a base is staged only from "
                             "host memory")
    scalars_raw = _pad_scalars(scalars_raw, n)
    if c is None and lanes is None and n <= NAIVE_THRESHOLD:
        return [msm_naive(g, packed_to_points(g, p.to(device)), scalars_raw)
                for g, p in zip(groups, packeds)]
    num_chunks, lanes, chunk_m, m_total = _plan_packed(n, lanes, chunk_log)
    assert m_total == n, (m_total, n)   # packed bases are pre-padded
    if c is None:
        c = _choose_c_large(chunk_m)
    num_win = -(-255 // c)
    return _msm_large_packed(groups, packeds, scalars_raw, num_win, c, lanes,
                             chunk_m // lanes)


def pippenger_msm_packed(group, packed, scalars_raw,
                         c: int | None = None, lanes: int | None = None,
                         chunk_log: int = 22):
    """Variable-base MSM over a pre-packed base (``points_to_packed``): the
    at-rest layout of the CRS query vectors, packed once at setup and
    reused across proofs.  Runs on the scalars' device; a base in host
    memory (pinned, for an asynchronous copy) is staged there one chunk of
    2^chunk_log rows at a time, so that only one chunk of it is resident.
    Returns one point (no batch dim)."""
    return _pippenger_packed([group], [packed], scalars_raw, c, lanes,
                             chunk_log)[0]


def pippenger_double_msm_packed(g1, g2, packed1, packed2, scalars_raw,
                                c: int | None = None,
                                lanes: int | None = None,
                                chunk_log: int = 22):
    """Fused variable-base double MSM (same scalars, G1 and G2 bases of the
    same padded length): digits and sort are shared, nothing more."""
    return tuple(_pippenger_packed([g1, g2], [packed1, packed2], scalars_raw,
                                   c, lanes, chunk_log))


# ---------------------------------------------------------------------------
# host-streamed packed MSM (a CRS kept in host memory): the packed MSMs
# with the scalars placed on ``device`` (None = the card)
# ---------------------------------------------------------------------------

def pippenger_msm_packed_stream(group, packed_host, scalars_raw,
                                c: int | None = None,
                                lanes: int | None = None,
                                chunk_log: int = 22, device=None):
    """``pippenger_msm_packed`` over a base held in host memory, staged to
    ``device`` chunk by chunk.  The scalars may lie on either side."""
    return pippenger_msm_packed(
        group, packed_host, scalars_raw.to(_device.resolve(device)), c,
        lanes, chunk_log)


def pippenger_double_msm_packed_stream(g1, g2, p1_host, p2_host, scalars_raw,
                                       c: int | None = None,
                                       lanes: int | None = None,
                                       chunk_log: int = 22, device=None):
    """The streamed double MSM: digits and sort run once per chunk for
    both host-resident bases."""
    return pippenger_double_msm_packed(
        g1, g2, p1_host, p2_host, scalars_raw.to(_device.resolve(device)),
        c, lanes, chunk_log)


# ---------------------------------------------------------------------------
# variable-base Pippenger over an unpacked point batch (sort-based)
# ---------------------------------------------------------------------------

def _choose_c(n: int) -> int:
    """Window width of the sort-based path: c = log2(n) - log2(n)/3,
    clamped to [4, 16] (the bucket phase stays small beside the scan with
    the Abel reduction, so fewer, wider windows pay off)."""
    logn = max(1, n.bit_length() - 1)
    return max(4, min(16, logn - logn // 3))


def _choose_lanes(n: int) -> int:
    """Lane count of the bucket-accumulation scan (a power of two)."""
    return min(1 << max(0, n.bit_length() - 1), 4096)


def _pad_pow2_to(group, points, m):
    """Append identity points up to m; returns (points, m)."""
    n = _batch_n(points)
    if m == n:
        return points, m
    inf = group.infinity((m - n,), jac.leaf(points).device)
    return tuple(jac._cat_coord(c, f) for c, f in zip(points, inf)), m


def _window_msm(group, points, digits, c: int, lanes: int, rows: int):
    """All unsigned-digit Pippenger windows of an unpacked batch.

    ``digits`` int64[num_win, m]: bucket ids (0 = skip).  One stable sort
    per window; the scan kernel reads the points through the sorted order.
    The windows ride a leading batch dimension.  Returns a point batch
    [8, num_win]."""
    num_win = digits.shape[0]
    d_sorted, order = torch.sort(digits, dim=1, stable=True)
    # lane l owns sorted positions [l*rows, (l+1)*rows)
    idx_rows = order.to(torch.int32).view(num_win, lanes, rows).transpose(1, 2)
    del order
    prefix = kernels.scan_accumulate(
        group.ops.group_name, points, idx_rows)   # [8, num_win, rows, lanes]
    cum = _bucket_sums(group, prefix, d_sorted, 1 << c, lanes, rows)
    del prefix
    # (2^c - 1) * cum[2^c - 1] = 2^c * cum[2^c - 1] - cum[2^c - 1]
    return _abel(group, cum, c, minus_last=True)


def pippenger_msm(group, points, scalars_raw, c: int | None = None,
                  lanes: int | None = None):
    """Sum_i [s_i] P_i over an unpacked projective batch -> one point (no
    batch dim).  ``scalars_raw``: int32[8, <= n] raw words (missing scalars
    are zero)."""
    n = _batch_n(points)
    if c is None:
        c = _choose_c(n)
    if lanes is None:
        lanes = _choose_lanes(n)
    # pad to a multiple of lanes with zero scalars (bucket 0 = discarded)
    rows = -(-n // lanes)
    m = rows * lanes
    points, _ = _pad_pow2_to(group, points, m)
    scalars_raw = _pad_scalars(scalars_raw, m)
    num_win = (SCALAR_BITS + c - 1) // c
    digits = _digits(scalars_raw, c, num_win)          # [num_win, m]
    return _combine_windows(
        group, _window_msm(group, points, digits, c, lanes, rows), c)


def pippenger_msm_large(group, points, scalars_raw, c: int | None = None,
                        lanes: int | None = None, chunk_log: int = 22):
    """Large variable-base MSM of an unpacked batch: pack it into affine
    rows, then the signed-digit packed pipeline."""
    n = _batch_n(points)
    packed = points_to_packed(group, points,
                              pad_to=_msm_pad_to(group, n, lanes, chunk_log))
    return pippenger_msm_packed(group, packed, scalars_raw, c, lanes,
                                chunk_log)


# ---------------------------------------------------------------------------
# host reference algorithm
# ---------------------------------------------------------------------------

def pippenger_host(group, scalars, points, c: int = 8,
                   order: int | None = None):
    """Host-int Pippenger, used by the verifier's primary-input MSM.

    ``order``: group order; when given, scalars are reduced mod order
    first so negative / unnormalized caller input decomposes correctly."""
    if order is not None:
        scalars = [s % order for s in scalars]
    if not scalars:
        return None
    assert all(s >= 0 for s in scalars), \
        "negative scalars need `order` to normalize"
    num_win = (max(s.bit_length() for s in scalars) + c - 1) // c or 1
    mask = (1 << c) - 1
    acc = None
    for w in range(num_win - 1, -1, -1):
        for _ in range(c):
            acc = group.host.add(acc, acc) if acc is not None else None
        buckets = [None] * (1 << c)
        for s, p in zip(scalars, points):
            d = (s >> (c * w)) & mask
            if d and p is not None:
                buckets[d] = group.host.add(buckets[d], p)
        run = tot = None
        for b in range(mask, 0, -1):
            run = group.host.add(run, buckets[b])
            tot = group.host.add(tot, run)
        acc = group.host.add(acc, tot)
    return acc


def sorted_msm_host(group, scalars, points):
    """Sort by scalar, multiply scalar differences into running suffix
    sums.  Host python ints."""
    out = None
    running = None
    prev_s = None
    for s, p in sorted(zip(scalars, points), key=lambda t: -t[0]):
        if prev_s is not None and prev_s != s:
            out = group.host.add(out, group.host.mul(running, prev_s - s))
        running = group.host.add(running, p)
        prev_s = s
    if prev_s is not None:
        out = group.host.add(out, group.host.mul(running, prev_s))
    return out


def bos_coster_msm_host(group, scalars, points):
    """Bos-Coster: repeatedly reduce the two largest scalars.  Host python
    ints."""
    import heapq

    heap = [(-s, i) for i, s in enumerate(scalars) if s]
    pts = list(points)
    heapq.heapify(heap)
    if not heap:
        return None
    while len(heap) > 1:
        s1, i1 = heapq.heappop(heap)
        s2, i2 = heap[0]
        s1, s2 = -s1, -s2
        if s2 == 0 or s1 // s2 > (1 << 20):
            # degenerate: finish with double-and-add
            heapq.heappush(heap, (-s1, i1))
            acc = None
            for s, i in heap:
                acc = group.host.add(acc, group.host.mul(pts[i], -s))
            return acc
        s1 -= s2
        pts[i2] = group.host.add(pts[i2], pts[i1])
        if s1:
            heapq.heappush(heap, (-s1, i1))
    s, i = heap[0]
    return group.host.mul(pts[i], -s)


# ---------------------------------------------------------------------------
# partitioned host variants: split (scalars, points) into partitions, run a
# host algorithm per partition, reduce with host adds (for comparing
# algorithm classes; the prover's path is the device Pippenger)
# ---------------------------------------------------------------------------

def _partitioned_host_msm(group, scalars, points, alg, num_partitions):
    n = len(scalars)
    num_partitions = max(1, min(num_partitions, n))
    per = -(-n // num_partitions)
    acc = None
    for i in range(0, n, per):
        part = alg(group, scalars[i:i + per], points[i:i + per])
        acc = group.host.add(acc, part)
    return acc


def distributed_sorted_msm_host(group, scalars, points, num_partitions=8):
    return _partitioned_host_msm(group, scalars, points, sorted_msm_host,
                                 num_partitions)


def distributed_bos_coster_msm_host(group, scalars, points,
                                    num_partitions=8):
    return _partitioned_host_msm(group, scalars, points,
                                 bos_coster_msm_host, num_partitions)


def distributed_pippenger_msm_host(group, scalars, points,
                                   num_partitions=8):
    return _partitioned_host_msm(
        group, scalars, points,
        lambda g, s, p: pippenger_host(g, s, p), num_partitions)
