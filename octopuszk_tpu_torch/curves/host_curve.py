"""Host-side BN254 G1/G2 group operations over python ints.

These are the exact-arithmetic oracle for the device kernels and the
implementation used for O(1)-per-proof scalar work (CRS scalars, proof
assembly, the verifier's tiny MSM).  Points are affine tuples, with None for
the identity:  G1: (x, y) ints;  G2: (x, y) Fp2 pairs.

Reference parity: BNG1.java:38-117 / BNG2.java (Jacobian ops) and the
BN254aG1Parameters/BN254aG2Parameters generators — but using textbook affine
formulas since host ops are not performance-critical.
"""

from __future__ import annotations

from octopuszk_tpu_torch.fields.spec import FQ, FR
from octopuszk_tpu_torch.fields import host_tower as tw

P = FQ.p

# generators (reference BN254aG1Parameters.java:25, BN254aG2Parameters.java:26-35)
G1_GEN = (1, 2)
G2_GEN = (
    (10857046999023057135944570762232829481370756359578518086990519993285655852781,
     11559732032986387107991004021392285783925812861821192530917403151452391805634),
    (8495653923123431417604973247489272438418190587263600148770280649306958101930,
     4082367875863433681332203403145435568316851327593401208105741076214120093531),
)

B1 = 3
B2 = tw.fp2_mul((3, 0), tw.fp2_inv(tw.XI))  # twist coefficient b/xi


# ---- generic affine ops parameterized by field callbacks ----

class _Ops:
    def __init__(self, add, sub, mul, sqr, neg, inv, scalar, zero, eq):
        self.add, self.sub, self.mul, self.sqr = add, sub, mul, sqr
        self.neg, self.inv, self.scalar, self.zero, self.eq = (
            neg, inv, scalar, zero, eq)


_FP_OPS = _Ops(
    add=lambda a, b: (a + b) % P, sub=lambda a, b: (a - b) % P,
    mul=lambda a, b: a * b % P, sqr=lambda a: a * a % P,
    neg=lambda a: (-a) % P, inv=lambda a: pow(a, -1, P),
    scalar=lambda a, k: a * k % P, zero=0, eq=lambda a, b: a == b)

_FP2_OPS = _Ops(
    add=tw.fp2_add, sub=tw.fp2_sub, mul=tw.fp2_mul, sqr=tw.fp2_sqr,
    neg=tw.fp2_neg, inv=tw.fp2_inv, scalar=tw.fp2_scalar,
    zero=tw.FP2_ZERO, eq=lambda a, b: a == b)


def _pt_add(ops: _Ops, p, q):
    if p is None:
        return q
    if q is None:
        return p
    x1, y1 = p
    x2, y2 = q
    if ops.eq(x1, x2):
        if ops.eq(y1, y2):
            return _pt_double(ops, p)
        return None
    lam = ops.mul(ops.sub(y2, y1), ops.inv(ops.sub(x2, x1)))
    x3 = ops.sub(ops.sub(ops.sqr(lam), x1), x2)
    y3 = ops.sub(ops.mul(lam, ops.sub(x1, x3)), y1)
    return (x3, y3)


def _pt_double(ops: _Ops, p):
    if p is None:
        return None
    x1, y1 = p
    if ops.eq(y1, ops.zero):
        return None
    lam = ops.mul(ops.scalar(ops.sqr(x1), 3), ops.inv(ops.scalar(y1, 2)))
    x3 = ops.sub(ops.sqr(lam), ops.scalar(x1, 2))
    y3 = ops.sub(ops.mul(lam, ops.sub(x1, x3)), y1)
    return (x3, y3)


def _pt_neg(ops: _Ops, p):
    if p is None:
        return None
    return (p[0], ops.neg(p[1]))


def _pt_mul(ops: _Ops, p, k: int, order: int | None = None):
    k %= order if order is not None else FR.p
    acc = None
    add_p = p
    while k:
        if k & 1:
            acc = _pt_add(ops, acc, add_p)
        add_p = _pt_double(ops, add_p)
        k >>= 1
    return acc


def _on_curve(ops: _Ops, p, b):
    if p is None:
        return True
    x, y = p
    return ops.eq(ops.sqr(y), ops.add(ops.mul(ops.sqr(x), x), b))


# ---- public G1 / G2 APIs ----

def g1_add(p, q):
    return _pt_add(_FP_OPS, p, q)


def g1_double(p):
    return _pt_double(_FP_OPS, p)


def g1_neg(p):
    return _pt_neg(_FP_OPS, p)


def g1_mul(p, k: int):
    return _pt_mul(_FP_OPS, p, k)


def g1_is_on_curve(p):
    return _on_curve(_FP_OPS, p, B1)


def g2_add(p, q):
    return _pt_add(_FP2_OPS, p, q)


def g2_double(p):
    return _pt_double(_FP2_OPS, p)


def g2_neg(p):
    return _pt_neg(_FP2_OPS, p)


def g2_mul(p, k: int):
    return _pt_mul(_FP2_OPS, p, k)


def g2_is_on_curve(p):
    return _on_curve(_FP2_OPS, p, B2)


def naive_msm_g1(scalars, points):
    """O(n log p) double-and-add reference (NaiveMSM.java:20-69 analogue)."""
    acc = None
    for s, pt in zip(scalars, points):
        acc = g1_add(acc, g1_mul(pt, s))
    return acc


def naive_msm_g2(scalars, points):
    acc = None
    for s, pt in zip(scalars, points):
        acc = g2_add(acc, g2_mul(pt, s))
    return acc
