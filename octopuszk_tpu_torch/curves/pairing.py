"""Optimal ate pairing on BN254, host-side (python ints).

e : G1 x G2 -> GT = mu_r in Fp12.  Used only by the Groth16 verifier and the
setup's single alpha*beta pairing (reference SerialSetup.java:159,
Verifier.java:36-49) — O(1) per proof, so a clear host-CPU job.

Algorithm: standard optimal ate Miller loop over loop count 6z+2 with the
two Frobenius correction steps, followed by the full final exponentiation
(p^12 - 1)/r computed as conj/inv easy part + integer-exponent hard part.
Written from the public algorithm (Vercauteren, "Optimal pairings"); matches
the role of BNPairing.java:84-336 without copying its structure.

G2 points are lifted from E'(Fp2) (the D-twist y^2 = x^3 + 3/xi) into
E(Fp12) via (x, y) -> (x w^2, y w^3) with w^6 = xi, so all line arithmetic
is plain affine arithmetic in Fp12.
"""

from __future__ import annotations

from octopuszk_tpu_torch.fields.spec import FQ, FR
from octopuszk_tpu_torch.fields import host_tower as tw

P = FQ.p
R_ORDER = FR.p

# BN parameter z and ate loop count 6z+2
# (reference BN254aPublicParameters.java: finalExponentZ, ateLoopCount)
BN_Z = 4965661367192848881
ATE_LOOP_COUNT = 6 * BN_Z + 2
assert ATE_LOOP_COUNT == 29793968203157093288

_FINAL_EXP = (P ** 12 - 1) // R_ORDER
_HARD_EXP = (P ** 4 - P ** 2 + 1) // R_ORDER


def _lift_g2(q):
    """E'(Fp2) affine -> E(Fp12) affine via the twist map."""
    x, y = q
    return (tw.fp12_mul(tw.fp2_to_fp12(x), tw.FP12_W2),
            tw.fp12_mul(tw.fp2_to_fp12(y), tw.FP12_W3))


def _lift_g1(p):
    x, y = p
    return (tw.fp_to_fp12(x), tw.fp_to_fp12(y))


def _frob12(pt, times: int = 1):
    """Apply the p-power Frobenius to an E(Fp12) point `times` times
    (coefficient tables — six Fp2 multiplies per coordinate, not a pow)."""
    x, y = pt
    return (tw.frobenius(x, times), tw.frobenius(y, times))


def _line_and_add(r, q, p12):
    """Chord line through r and q evaluated at p12; returns (line, r+q)."""
    xr, yr = r
    xq, yq = q
    xp, yp = p12
    if xr == xq and yr == yq:
        return _line_double(r, p12)
    if xr == xq:
        # vertical line x - xr
        return tw.fp12_sub(xp, xr), None
    lam = tw.fp12_mul(tw.fp12_sub(yq, yr),
                      tw.fp12_inv(tw.fp12_sub(xq, xr)))
    line = tw.fp12_sub(
        tw.fp12_sub(yp, yr),
        tw.fp12_mul(lam, tw.fp12_sub(xp, xr)))
    x3 = tw.fp12_sub(tw.fp12_sub(tw.fp12_sqr(lam), xr), xq)
    y3 = tw.fp12_sub(tw.fp12_mul(lam, tw.fp12_sub(xr, x3)), yr)
    return line, (x3, y3)


def _line_double(r, p12):
    """Tangent line at r evaluated at p12; returns (line, 2r)."""
    xr, yr = r
    xp, yp = p12
    three_x2 = tw.fp12_mul(tw.fp_to_fp12(3), tw.fp12_sqr(xr))
    lam = tw.fp12_mul(three_x2,
                      tw.fp12_inv(tw.fp12_mul(tw.fp_to_fp12(2), yr)))
    line = tw.fp12_sub(
        tw.fp12_sub(yp, yr),
        tw.fp12_mul(lam, tw.fp12_sub(xp, xr)))
    x3 = tw.fp12_sub(tw.fp12_sqr(lam),
                     tw.fp12_mul(tw.fp_to_fp12(2), xr))
    y3 = tw.fp12_sub(tw.fp12_mul(lam, tw.fp12_sub(xr, x3)), yr)
    return line, (x3, y3)


def miller_loop(p, q):
    """Miller loop for optimal ate; p in G1 affine, q in G2(Fp2) affine."""
    if p is None or q is None:
        return tw.FP12_ONE
    p12 = _lift_g1(p)
    q12 = _lift_g2(q)
    f = tw.FP12_ONE
    r = q12
    bits = bin(ATE_LOOP_COUNT)[3:]  # skip MSB
    for bit in bits:
        line, r = _line_double(r, p12)
        f = tw.fp12_mul(tw.fp12_sqr(f), line)
        if bit == "1":
            line, r = _line_and_add(r, q12, p12)
            f = tw.fp12_mul(f, line)
    # Frobenius correction steps: Q1 = pi_p(Q), Q2 = pi_{p^2}(Q)
    q1 = _frob12(q12, 1)
    nq2 = _frob12(q12, 2)
    nq2 = (nq2[0], tw.fp12_neg(nq2[1]))
    line, r = _line_and_add(r, q1, p12)
    f = tw.fp12_mul(f, line)
    line, r = _line_and_add(r, nq2, p12)
    f = tw.fp12_mul(f, line)
    return f


def final_exponentiation(f):
    """f^((p^12-1)/r): conj/inv easy part, then the hard part as a 4-way
    Shamir multi-exponentiation over Frobenius powers (host_tower.py
    final_exp_hard) — ~8x fewer Fp12 ops than the plain ~3000-bit pow
    (role of BNPairing.finalExponentiationFirstChunk/LastChunk,
    BNPairing.java:153-235, without its hand-derived chain)."""
    # easy: f^(p^6 - 1) then ^(p^2 + 1)
    f = tw.fp12_mul(tw.fp12_conj(f), tw.fp12_inv(f))
    f = tw.fp12_mul(tw.frobenius(f, 2), f)
    # hard: ^((p^4 - p^2 + 1)/r)
    return tw.final_exp_hard(f, R_ORDER)


def reduced_pairing(p, q):
    """e(P, Q) in GT.  e(0, Q) = e(P, 0) = 1."""
    return final_exponentiation(miller_loop(p, q))


def gt_mul(a, b):
    return tw.fp12_mul(a, b)


def gt_exp(a, e: int):
    return tw.fp12_pow(a, e % R_ORDER)


GT_ONE = tw.FP12_ONE
