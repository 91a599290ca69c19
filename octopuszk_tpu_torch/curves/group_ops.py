"""Vectorized COMPLETE projective curve arithmetic (a = 0 curves).

Homogeneous projective points ``(X, Y, Z)`` with the identity at (0, 1, 0),
using the Renes-Costello-Batina complete addition formulas (ePrint
2015/1060, algorithms 7-9 for a = 0): one branchless formula correct for
every input pair: doubling, identity, inverses.  Requires odd group order
(true for G1 and the G2 subgroup of BN254a and BN254b).

A point batch is a tuple of three coordinates; a coordinate is an
``int32[8, ...]`` word tensor for G1 (Fp) or a pair of them for G2 (Fp2).
The field is presented as an ops namespace (``make_fp_ops`` /
``make_fp2_ops``).

``add`` and ``double`` go through ``ops/kernels.py``: on the card they
always launch the CUDA kernel; on the CPU they evaluate ``add_formula`` /
``double_formula`` below, which are also the kernels' plain versions.
"""

from __future__ import annotations

import types

import torch

from octopuszk_tpu_torch.fields import fp, fp2, host_tower
from octopuszk_tpu_torch.fields.spec import FieldSpec
from octopuszk_tpu_torch.utils.bigint import int_to_words


def make_fp_ops(spec: FieldSpec, b3: int = 9, group_name: str = "G1",
                mul=fp.mont_mul) -> types.SimpleNamespace:
    """Coordinate-field adapter for a base prime field (G1).

    ``b3`` = 3 * coefficientB (BN254a b = 3 -> 9; BN254b b = 13 -> 39),
    multiplied in by an addition chain.  ``mul`` is the base-field product
    (the kernels' plain versions pass the plain CIOS)."""
    return types.SimpleNamespace(
        spec=spec,
        group_name=group_name,
        coord_dim=1,
        add=lambda a, b: fp.add(spec, a, b),
        sub=lambda a, b: fp.sub(spec, a, b),
        mul=lambda a, b: mul(spec, a, b),
        sqr=lambda a: mul(spec, a, a),
        neg=lambda a: fp.neg(spec, a),
        dbl=lambda a: fp.add(spec, a, a),
        inv=lambda a: fp.inv(spec, a),
        mul_b3=lambda a: fp.mul_small(spec, a, b3),
        binv=lambda a: fp.batch_inv_rows(spec, a),
        is_zero=fp.is_zero,
        eq=fp.eq,
        select=fp.select,
        zero=lambda shape=(), device=None: fp.zeros_like_batch(shape, device),
        one=lambda shape=(), device=None: fp.constant(
            spec.one_mont_words, shape, device),
    )


def g2_b3() -> tuple:
    """3 * (b / xi) = 3 * 3 / (9 + u): the BN254a twist's b3 as an
    (c0, c1) pair of host ints."""
    b2 = host_tower.fp2_mul((3, 0), host_tower.fp2_inv(host_tower.XI))
    return host_tower.fp2_scalar(b2, 3)


def make_fp2_ops(spec: FieldSpec, nr: int = -1, b3=None,
                 group_name: str = "G2",
                 mul=fp.mont_mul) -> types.SimpleNamespace:
    """Coordinate-field adapter for Fp2 (G2 of a BN curve).

    ``nr``: the Fp2 non-residue (u^2 = nr; BN254a -1, BN254b -5).  ``b3``:
    3 * the twist's coefficient b as an (c0, c1) pair of host ints; by
    default BN254a's (``g2_b3``)."""
    if b3 is None:
        b3 = g2_b3()
    b3w = (int_to_words(spec.to_mont(b3[0])), int_to_words(spec.to_mont(b3[1])))

    def mul_b3(a):
        ones = (1,) * (a[0].dim() - 1)
        cc = tuple(fp.constant(w, ones, a[0].device) for w in b3w)
        return fp2.mul(spec, a, cc, nr, mul)

    return types.SimpleNamespace(
        spec=spec,
        group_name=group_name,
        coord_dim=2,
        add=lambda a, b: fp2.add(spec, a, b),
        sub=lambda a, b: fp2.sub(spec, a, b),
        mul=lambda a, b: fp2.mul(spec, a, b, nr, mul),
        sqr=lambda a: fp2.sqr(spec, a, nr, mul),
        neg=lambda a: fp2.neg(spec, a),
        dbl=lambda a: fp2.double(spec, a),
        inv=lambda a: fp2.inv(spec, a, nr),
        mul_b3=mul_b3,
        binv=lambda a: fp2.batch_inv_rows(spec, a, nr=nr),
        is_zero=fp2.is_zero,
        eq=fp2.eq,
        select=fp2.select,
        zero=lambda shape=(), device=None: (
            fp.zeros_like_batch(shape, device),
            fp.zeros_like_batch(shape, device)),
        one=lambda shape=(), device=None: (
            fp.constant(spec.one_mont_words, shape, device),
            fp.zeros_like_batch(shape, device)),
    )


# ---------------------------------------------------------------------------
# point predicates / constructors
# ---------------------------------------------------------------------------

def infinity(ops, batch_shape=(), device=None):
    """The identity: (0, 1, 0)."""
    return (ops.zero(batch_shape, device), ops.one(batch_shape, device),
            ops.zero(batch_shape, device))


def is_infinity(ops, p):
    return ops.is_zero(p[2])


def select_point(ops, mask, p, q):
    """mask ? p : q, per batch element."""
    return tuple(ops.select(mask, a, b) for a, b in zip(p, q))


def negate(ops, p):
    return (p[0], ops.neg(p[1]), p[2])


def leaf(point) -> torch.Tensor:
    """First word tensor of a point or coordinate (for shape and device)."""
    while isinstance(point, tuple):
        point = point[0]
    return point


def _map_coords(point, fn):
    return tuple(
        tuple(fn(c) for c in coord) if isinstance(coord, tuple) else fn(coord)
        for coord in point)


def flatten_coords(point) -> list:
    """Point (or affine pair) -> flat list of word tensors."""
    flat = []
    for coord in point:
        flat.extend(coord if isinstance(coord, tuple) else (coord,))
    return flat


def rebuild_coords(flat, coord_dim: int) -> tuple:
    """Inverse of flatten_coords."""
    if coord_dim == 1:
        return tuple(flat)
    return tuple((flat[i], flat[i + 1]) for i in range(0, len(flat), 2))


# ---------------------------------------------------------------------------
# complete add / double / mixed add  (RCB 2015, algorithms 7, 8, 9; a = 0)
# ---------------------------------------------------------------------------

def _mul_many(ops, pairs):
    """[a*b for a, b in pairs] as ONE ops.mul over operands stacked on a
    new batch axis: eager PyTorch pays per call, and a formula's products
    are independent.  Operands are broadcast to a common shape first."""
    shape = fp.broadcast_shape(*[leaf(x) for pair in pairs for x in pair])

    def stack(xs):
        if isinstance(xs[0], tuple):
            return tuple(stack([x[i] for x in xs]) for i in range(2))
        return torch.stack([x.expand(shape) for x in xs], dim=1)

    prod = ops.mul(stack([a for a, _ in pairs]), stack([b for _, b in pairs]))
    if isinstance(prod, tuple):
        return list(zip(*(c.unbind(dim=1) for c in prod)))
    return list(prod.unbind(dim=1))


def add_formula(ops, p, q):
    """P + Q, complete: valid for all inputs (identity, equal, inverse)."""
    X1, Y1, Z1 = p
    X2, Y2, Z2 = q
    t0, t1, t2, t3, t4, t5 = _mul_many(ops, [
        (X1, X2), (Y1, Y2), (Z1, Z2),
        (ops.add(X1, Y1), ops.add(X2, Y2)),
        (ops.add(Y1, Z1), ops.add(Y2, Z2)),
        (ops.add(X1, Z1), ops.add(X2, Z2))])
    t3 = ops.sub(t3, ops.add(t0, t1))                 # X1Y2 + X2Y1
    t4 = ops.sub(t4, ops.add(t1, t2))                 # Y1Z2 + Y2Z1
    t5 = ops.sub(t5, ops.add(t0, t2))                 # X1Z2 + X2Z1
    three_t0 = ops.add(ops.dbl(t0), t0)
    b3t2 = ops.mul_b3(t2)
    z3 = ops.add(t1, b3t2)
    t1 = ops.sub(t1, b3t2)
    y3 = ops.mul_b3(t5)
    ma, mb, mc, md, me, mf = _mul_many(ops, [
        (t3, t1), (t4, y3), (y3, three_t0), (t1, z3),
        (z3, t4), (three_t0, t3)])
    return (ops.sub(ma, mb), ops.add(mc, md), ops.add(me, mf))


def double_formula(ops, p):
    """[2]P, complete (RCB algorithm 9, a = 0)."""
    X, Y, Z = p
    t0, t1, tzz, txy = _mul_many(ops, [(Y, Y), (Y, Z), (Z, Z), (X, Y)])
    z3 = ops.dbl(ops.dbl(ops.dbl(t0)))                # 8Y^2
    t2 = ops.mul_b3(tzz)
    y3a = ops.add(t0, t2)
    t2_3 = ops.add(ops.dbl(t2), t2)
    t0 = ops.sub(t0, t2_3)
    X3, Z3, yb, xc = _mul_many(ops, [
        (t2, z3), (t1, z3), (t0, y3a), (t0, txy)])
    return (ops.dbl(xc), ops.add(X3, yb), Z3)


def add(ops, p, q):
    """P + Q over a batch; operands are broadcast to a common shape."""
    from octopuszk_tpu_torch.ops import kernels
    return kernels.add_points(ops.group_name, p, q)


def double(ops, p):
    from octopuszk_tpu_torch.ops import kernels
    return kernels.double_points(ops.group_name, p)


def mixed_add(ops, p, q_affine, q_inf_mask=None):
    """P (projective) + Q (affine, Z = 1): complete in P (RCB algorithm 8).

    ``q_inf_mask`` marks batch slots where Q is the identity.
    """
    X1, Y1, Z1 = p
    X2, Y2 = q_affine
    t0, t1, t3, t4m, t5m = _mul_many(ops, [
        (X1, X2), (Y1, Y2),
        (ops.add(X2, Y2), ops.add(X1, Y1)),
        (X2, Z1), (Y2, Z1)])
    t3 = ops.sub(t3, ops.add(t0, t1))                 # X1Y2 + X2Y1
    t4 = ops.add(t4m, X1)                             # X1 + X2Z1
    t5 = ops.add(t5m, Y1)                             # Y1 + Y2Z1
    three_t0 = ops.add(ops.dbl(t0), t0)
    b3z1 = ops.mul_b3(Z1)
    z3 = ops.add(t1, b3z1)
    t1 = ops.sub(t1, b3z1)
    y3 = ops.mul_b3(t4)
    ma, mb, mc, md, me, mf = _mul_many(ops, [
        (t3, t1), (t5, y3), (y3, three_t0), (t1, z3),
        (z3, t5), (three_t0, t3)])
    out = (ops.sub(ma, mb), ops.add(mc, md), ops.add(me, mf))
    if q_inf_mask is not None:
        out = select_point(ops, q_inf_mask, p, out)
    return out


# ---------------------------------------------------------------------------
# affine conversion
# ---------------------------------------------------------------------------

def _to_affine(ops, p, invert):
    X, Y, Z = p
    inf = is_infinity(ops, p)
    shape, dev = tuple(leaf(X).shape[1:]), leaf(X).device
    z_safe = ops.select(inf, ops.one(shape, dev), Z)
    zinv = invert(z_safe)
    x = ops.mul(X, zinv)
    y = ops.mul(Y, zinv)
    zero = ops.zero(shape, dev)
    return (ops.select(inf, zero, x), ops.select(inf, zero, y), inf)


def to_affine(ops, p):
    """Batch projective -> affine: (x, y, inf_mask); identity -> (0, 0)."""
    return _to_affine(ops, p, ops.inv)


def normalize_z1(ops, p):
    """Rescale to Z = 1 (the identity stays (0, 1, 0))."""
    x, y, inf = to_affine(ops, p)
    shape, dev = tuple(leaf(x).shape[1:]), leaf(x).device
    one = ops.one(shape, dev)
    z = ops.select(inf, ops.zero(shape, dev), one)
    return (x, ops.select(inf, one, y), z)


def to_affine_fast(ops, p):
    """The same through the O(n) two-level batched inverse
    (fp.batch_inv_rows).  Flat [8, n] batches only."""
    return _to_affine(ops, p, ops.binv)


# ---------------------------------------------------------------------------
# reductions and scalar multiplication
# ---------------------------------------------------------------------------

def _shift_points(ops, p, d: int, toward_front: bool):
    """Shift a batch along its last axis by d, filling with the identity."""
    lf = leaf(p)
    fill = infinity(ops, tuple(lf.shape[1:-1]) + (d,), lf.device)
    if toward_front:      # out[j] = p[j + d]
        return tuple(_cat_coord(_slice_coord(c, d, None), f)
                     for c, f in zip(p, fill))
    return tuple(_cat_coord(f, _slice_coord(c, None, -d))
                 for c, f in zip(p, fill))


def _slice_coord(c, lo, hi):
    if isinstance(c, tuple):
        return tuple(x[..., lo:hi] for x in c)
    return c[..., lo:hi]


def _cat_coord(a, b):
    if isinstance(a, tuple):
        return tuple(torch.cat([x, y], dim=-1) for x, y in zip(a, b))
    return torch.cat([a, b], dim=-1)


def tree_reduce(ops, p, axis_size: int):
    """Sum a batch of points along the last batch axis -> one point per
    leading batch index: element 0 of the Hillis-Steele suffix fold (level
    l adds element j + 2^l into element j), one call of ops/kernels.py
    tree_sum."""
    from octopuszk_tpu_torch.ops import kernels
    assert leaf(p).shape[-1] == axis_size, (leaf(p).shape, axis_size)
    return kernels.tree_sum(ops.group_name, p)


def _index_last(p, i):
    return _map_coords(p, lambda c: c[..., i])


def scalar_bits(scalars_raw: torch.Tensor, bit: int) -> torch.Tensor:
    """Bit ``bit`` of each scalar; scalars_raw is int32[8, ...] raw words."""
    return (scalars_raw[bit // 32] >> (bit % 32)) & 1


def scalar_mul(ops, p, scalars_raw, num_bits: int = 254):
    """[k_i] P_i elementwise over a batch (double-and-add, MSB first)."""
    lf = leaf(p)
    acc = infinity(ops, tuple(lf.shape[1:]), lf.device)
    for bit in range(num_bits - 1, -1, -1):
        acc = double(ops, acc)
        take = scalar_bits(scalars_raw, bit) == 1
        acc = select_point(ops, take, add(ops, acc, p), acc)
    return acc
