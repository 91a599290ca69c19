"""Vectorized Fp2 = Fp[u]/(u^2 - nr) arithmetic over word tensors.

An Fp2 batch is a pair ``(c0, c1)`` of ``int32[8, ...]`` Montgomery word
tensors (see fields/fp.py).  The non-residue ``nr`` is -1 for BN254a and
-5 for BN254b, so ``(a0 + a1 u)(b0 + b1 u) = (a0 b0 + nr a1 b1) + (a0 b1 +
a1 b0) u`` and Karatsuba saves one of the four base multiplications; the
products by nr are addition chains (``fp.mul_small``).

Every function takes the base-field multiply as ``mul`` so that the plain
versions of the curve kernels can run the same formulas on the plain CIOS;
the default is ``fp.mont_mul`` (the CUDA kernel on the card).
"""

from __future__ import annotations

import torch

from octopuszk_tpu_torch.fields import fp
from octopuszk_tpu_torch.fields.spec import FieldSpec


def add(spec: FieldSpec, a, b):
    return (fp.add(spec, a[0], b[0]), fp.add(spec, a[1], b[1]))


def sub(spec: FieldSpec, a, b):
    return (fp.sub(spec, a[0], b[0]), fp.sub(spec, a[1], b[1]))


def neg(spec: FieldSpec, a):
    return (fp.neg(spec, a[0]), fp.neg(spec, a[1]))


def double(spec: FieldSpec, a):
    return (fp.add(spec, a[0], a[0]), fp.add(spec, a[1], a[1]))


def _mul_batch(spec, pairs, mul):
    """Independent base multiplies as one call (stacked on a new batch
    axis): eager PyTorch pays per call, not per element."""
    xs, ys = zip(*pairs)
    shape = fp.broadcast_shape(*xs, *ys)
    lhs = torch.stack([x.expand(shape) for x in xs], dim=1)
    rhs = torch.stack([y.expand(shape) for y in ys], dim=1)
    return mul(spec, lhs, rhs).unbind(dim=1)


def mul(spec: FieldSpec, a, b, nr: int = -1, mul=fp.mont_mul):
    """(a0 + a1 u)(b0 + b1 u) with u^2 = nr; Karatsuba: 3 base multiplies."""
    t0, t1, s = _mul_batch(spec, [
        (a[0], b[0]), (a[1], b[1]),
        (fp.add(spec, a[0], a[1]), fp.add(spec, b[0], b[1]))], mul)
    if nr == -1:
        c0 = fp.sub(spec, t0, t1)
    else:
        c0 = fp.add(spec, t0, fp.mul_small(spec, t1, nr))
    c1 = fp.sub(spec, fp.sub(spec, s, t0), t1)
    return (c0, c1)


def sqr(spec: FieldSpec, a, nr: int = -1, mul=fp.mont_mul):
    """(a0 + a1)(a0 + nr a1) - (1 + nr) a0 a1 + 2 a0 a1 u: 2 base
    multiplies; nr = -1 is the (a0 + a1)(a0 - a1) + 2 a0 a1 u form."""
    a1nr = fp.neg(spec, a[1]) if nr == -1 else fp.mul_small(spec, a[1], nr)
    m1, m2 = _mul_batch(spec, [
        (fp.add(spec, a[0], a[1]), fp.add(spec, a[0], a1nr)),
        (a[0], a[1])], mul)
    c0 = m1 if nr == -1 else fp.sub(spec, m1, fp.mul_small(spec, m2, 1 + nr))
    return (c0, fp.add(spec, m2, m2))


def mul_fp(spec: FieldSpec, a, k):
    """Multiply an Fp2 batch by an Fp batch/constant."""
    return (fp.mont_mul(spec, a[0], k), fp.mont_mul(spec, a[1], k))


def conj(spec: FieldSpec, a):
    return (a[0], fp.neg(spec, a[1]))


def _norm(spec: FieldSpec, a, nr: int = -1):
    """a0^2 - nr a1^2 (the Fp2 norm)."""
    s0, s1 = _mul_batch(spec, [(a[0], a[0]), (a[1], a[1])], fp.mont_mul)
    if nr == -1:
        return fp.add(spec, s0, s1)
    return fp.sub(spec, s0, fp.mul_small(spec, s1, nr))


def inv(spec: FieldSpec, a, nr: int = -1):
    """1 / (a0 + a1 u) = (a0 - a1 u) / (a0^2 - nr a1^2)."""
    d = fp.inv(spec, _norm(spec, a, nr))
    return (fp.mont_mul(spec, a[0], d),
            fp.neg(spec, fp.mont_mul(spec, a[1], d)))


def batch_inv_rows(spec: FieldSpec, a, lanes: int | None = None,
                   nr: int = -1):
    """Elementwise Fp2 inverse of a flat batch in O(n) base multiplies
    (norm trick over fp.batch_inv_rows).  inv(0) = 0."""
    d = fp.batch_inv_rows(spec, _norm(spec, a, nr), lanes)
    return (fp.mont_mul(spec, a[0], d),
            fp.neg(spec, fp.mont_mul(spec, a[1], d)))


def is_zero(a):
    return fp.is_zero(a[0]) & fp.is_zero(a[1])


def eq(a, b):
    return fp.eq(a[0], b[0]) & fp.eq(a[1], b[1])


def select(mask, a, b):
    return (fp.select(mask, a[0], b[0]), fp.select(mask, a[1], b[1]))
