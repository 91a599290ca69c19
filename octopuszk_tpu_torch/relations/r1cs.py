"""R1CS relation in COO sparse form over device word tensors.

Each of A, B, C is (row, col, val) arrays; the assignment is a dense Fr
vector; A z and A^T w are gather + multiply + segment-sum.

Segment sums are exact: the products are cut into 16-bit limbs and summed
as integers, then reduced once (fp.reduce_sum_mont).  The sums are
hierarchical, as in the reference: a host-precomputed *chunk* id splits
each row (and each column, for the transpose) into chunks of <= 2^13
entries, so that a limb sum stays below 2^31; chunk partials are
canonicalized before the second-level sum.  Each level runs over its
entries in slices of 2^``MATVEC_CHUNK_LOG`` into one sum allocated up
front, and canonicalizes that sum in slices of half as many columns, so
that only a slice's gather, products and limbs, or its reduction, are
transient.  The sums are exact integers, so the words do not depend on
the slicing.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from octopuszk_tpu_torch.fields import fp
from octopuszk_tpu_torch.fields.spec import FieldSpec
from octopuszk_tpu_torch.utils import device as _device
from octopuszk_tpu_torch.utils.bigint import ints_to_words

CHUNK = 1 << 13

# entries a slice of the segment sums.  A slice's gather, products and
# 16-bit limbs (int64[16, k]) hold about 350 B an entry, so 2^22 keeps them
# near 1.5 GB whatever the size, and a matrix of the 2^20 path (A has about
# 2.6 M entries) is still one slice.  Canonicalizing the int64[16, n] sums
# holds about 600 B a column, so it runs on half as many columns a slice.
MATVEC_CHUNK_LOG = 22


@dataclasses.dataclass(frozen=True)
class SparseMatrix:
    """COO matrix over Fr with hierarchical segment ids for both axes.

    val is Montgomery-form words int32[8, nnz]; row/col int64[nnz] with
    row sorted ascending (construction sorts).  *_chunk / *_chunk_seg are
    the two-level segment-sum ids (see module docstring)."""

    row: torch.Tensor
    col: torch.Tensor
    val: torch.Tensor
    row_chunk: torch.Tensor        # [nnz] first-level id for row sums
    row_chunk_seg: torch.Tensor    # [n_row_chunks] -> row
    col_chunk: torch.Tensor        # [nnz] first-level id for col sums
    col_chunk_seg: torch.Tensor    # [n_col_chunks] -> col
    num_rows: int
    num_cols: int

    @property
    def nnz(self):
        return self.row.shape[0]


def _chunk_ids(sorted_ids: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """First-level chunk ids for a sorted id array: every run of equal ids
    is split into chunks of <= CHUNK entries; returns (chunk_of_entry,
    id_of_chunk)."""
    n = len(sorted_ids)
    if n == 0:
        return (np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.int64))
    new_run = np.empty(n, dtype=bool)
    new_run[0] = True
    new_run[1:] = sorted_ids[1:] != sorted_ids[:-1]
    run_start = np.maximum.accumulate(np.where(new_run, np.arange(n), 0))
    pos_in_run = np.arange(n) - run_start
    boundary = new_run | (pos_in_run % CHUNK == 0)
    chunk_of_entry = np.cumsum(boundary) - 1
    id_of_chunk = sorted_ids[boundary]
    return chunk_of_entry.astype(np.int64), id_of_chunk.astype(np.int64)


def make_sparse(spec: FieldSpec, rows, cols, vals, num_rows: int,
                num_cols: int, device=None) -> SparseMatrix:
    """Build a SparseMatrix from host arrays/lists (vals = raw ints).

    Synthetic circuits draw values from a handful of distinct constants, so
    Montgomery conversion runs once per distinct value and fans out with a
    numpy gather."""
    device = _device.resolve(device)
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    order = np.argsort(rows, kind="stable")
    rows, cols = rows[order], cols[order]
    row_chunk, row_chunk_seg = _chunk_ids(rows)
    corder = np.argsort(cols, kind="stable")    # for the transpose
    cc, ccs = _chunk_ids(cols[corder])
    col_chunk = np.empty(len(cols), dtype=np.int64)
    col_chunk[corder] = cc
    if isinstance(vals, np.ndarray) and vals.dtype != object:
        vals_arr = vals.astype(object)[order]
    else:
        vals_arr = np.asarray(list(vals), dtype=object)[order]
    uniq, inv = np.unique(vals_arr, return_inverse=True)
    uniq_words = ints_to_words([spec.to_mont(int(v) % spec.p) for v in uniq])
    val_words = np.ascontiguousarray(uniq_words[:, inv])
    to = lambda a: torch.from_numpy(a).to(device)
    return SparseMatrix(
        row=to(rows), col=to(cols), val=to(val_words),
        row_chunk=to(row_chunk), row_chunk_seg=to(row_chunk_seg),
        col_chunk=to(col_chunk), col_chunk_seg=to(ccs),
        num_rows=num_rows, num_cols=num_cols)


def _segment_sum(terms, seg, num_segments: int):
    """Integer segment sum along the last axis of int64[d, k]."""
    out = torch.zeros((terms.shape[0], num_segments), dtype=torch.int64,
                      device=terms.device)
    return out.index_add_(1, seg, terms)


def _sliced_sum(spec, terms_of, k: int, seg, num_segments: int):
    """Exact segment sum of k Montgomery values: ``terms_of(lo, hi)`` gives
    entries lo..hi as int32[8, hi - lo], ``seg`` int64[k] their segment
    ids; their 16-bit limbs are summed slice by slice into one
    int64[16, num_segments], which is then canonicalized in slices of half
    as many columns.
    Returns int32[8, num_segments] Montgomery."""
    step = 1 << MATVEC_CHUNK_LOG
    device = seg.device
    wide = torch.zeros((2 * fp.W, num_segments), dtype=torch.int64,
                       device=device)
    for lo in range(0, k, step):
        hi = min(k, lo + step)
        wide.index_add_(1, seg[lo:hi], fp.split16(terms_of(lo, hi)))
    out = torch.empty((fp.W, num_segments), dtype=torch.int32, device=device)
    step = max(1, step // 2)
    for lo in range(0, num_segments, step):
        hi = min(num_segments, lo + step)
        out[:, lo:hi] = fp.reduce_sum_mont(spec, wide[:, lo:hi])
    return out


def _segment_sum_field(spec, terms_of, k: int, seg1, seg1_to_seg2, n1: int,
                       n2: int):
    """Hierarchical exact segment sum of Montgomery values.

    terms_of(lo, hi): int32[8, hi - lo] Montgomery, entries lo..hi of k;
    seg1: int64[k] first-level ids (n1 of them), seg1_to_seg2: int64[n1]
    second-level target ids; returns int32[8, n2] Montgomery."""
    part = _sliced_sum(spec, terms_of, k, seg1, n1)
    return _sliced_sum(spec, lambda lo, hi: part[:, lo:hi], n1, seg1_to_seg2,
                       n2)


def matvec(spec: FieldSpec, m: SparseMatrix, z):
    """A @ z: z is int32[8, num_cols] Montgomery; result [8, num_rows]."""
    return _segment_sum_field(
        spec, lambda lo, hi: fp.mont_mul(spec, m.val[:, lo:hi],
                                         z[:, m.col[lo:hi]]),
        m.nnz, m.row_chunk, m.row_chunk_seg,
        int(m.row_chunk_seg.shape[0]), m.num_rows)


def rmatvec(spec: FieldSpec, m: SparseMatrix, w):
    """A.T @ w: w is int32[8, num_rows]; result [8, num_cols]."""
    return _segment_sum_field(
        spec, lambda lo, hi: fp.mont_mul(spec, m.val[:, lo:hi],
                                         w[:, m.row[lo:hi]]),
        m.nnz, m.col_chunk, m.col_chunk_seg,
        int(m.col_chunk_seg.shape[0]), m.num_cols)


@dataclasses.dataclass(frozen=True)
class R1CS:
    """R1CS relation: A z * B z = C z, with primary/auxiliary split.
    ``num_inputs`` counts the primary assignment *including* the leading
    constant-one variable (index 0)."""

    a: SparseMatrix
    b: SparseMatrix
    c: SparseMatrix
    num_constraints: int
    num_inputs: int
    num_variables: int

    def is_valid(self) -> bool:
        ok = self.num_inputs <= self.num_variables
        for m in (self.a, self.b, self.c):
            ok = ok and m.num_rows == self.num_constraints
            ok = ok and m.num_cols == self.num_variables
        return bool(ok)


def is_satisfied(spec: FieldSpec, r1cs: R1CS, z) -> bool:
    """All constraints hold for full assignment z?"""
    az = matvec(spec, r1cs.a, z)
    bz = matvec(spec, r1cs.b, z)
    cz = matvec(spec, r1cs.c, z)
    return bool(fp.eq(fp.mont_mul(spec, az, bz), cz).all())


def assignment_to_device(spec: FieldSpec, values, device=None):
    """Host int assignment -> Montgomery word vector int32[8, n].

    The host only packs raw residues; the Montgomery conversion is one
    batched mont_mul by R^2 on the device (a python ``to_mont`` per element
    would take seconds at 2^20 variables)."""
    raw = torch.from_numpy(ints_to_words([v % spec.p for v in values]))
    return fp.to_mont(spec, raw.to(_device.resolve(device)))
