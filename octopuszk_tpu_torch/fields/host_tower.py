"""Host-side BN254 extension-field tower: Fp2, Fp6, Fp12 over python ints.

Pairings are O(1) per proof (verifier side), so they run on the host CPU with
exact python integers; there is no device code for Fp12.  Tower: Fp2 = Fp[u]/(u^2+1), Fp6 = Fp2[v]/(v^3 - xi)
with xi = 9 + u, Fp12 = Fp6[w]/(w^2 - v).

Reference parity: algebra/fields/Fp2.java, Fp6_3Over2.java,
Fp12_2Over3Over2.java and the BN254a parameter files (nonresidue = -1 for
Fp2, 9+u for Fp6 — BN254aFq2Parameters.java:44, BN254aFq6Parameters.java:37).
Implemented from the standard public tower construction, not translated.
"""

from __future__ import annotations

from octopuszk_tpu_torch.fields.spec import FQ

P = FQ.p

# --- Fp2: pairs (a0, a1) = a0 + a1*u, u^2 = -1 ---

FP2_ZERO = (0, 0)
FP2_ONE = (1, 0)
XI = (9, 1)  # the Fp6/Fp12 non-residue xi = 9 + u


def fp2_add(a, b):
    return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)


def fp2_sub(a, b):
    return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)


def fp2_neg(a):
    return ((-a[0]) % P, (-a[1]) % P)


def fp2_mul(a, b):
    # (a0 + a1 u)(b0 + b1 u) = (a0 b0 - a1 b1) + (a0 b1 + a1 b0) u
    return ((a[0] * b[0] - a[1] * b[1]) % P, (a[0] * b[1] + a[1] * b[0]) % P)


def fp2_sqr(a):
    return ((a[0] + a[1]) * (a[0] - a[1]) % P, 2 * a[0] * a[1] % P)


def fp2_scalar(a, k: int):
    return (a[0] * k % P, a[1] * k % P)


def fp2_conj(a):
    return (a[0], (-a[1]) % P)


def fp2_inv(a):
    d = pow((a[0] * a[0] + a[1] * a[1]) % P, -1, P)
    return (a[0] * d % P, (-a[1]) * d % P)


def fp2_mul_by_xi(a):
    """a * (9 + u)."""
    return ((9 * a[0] - a[1]) % P, (a[0] + 9 * a[1]) % P)


def fp2_pow(a, e: int):
    acc = FP2_ONE
    base = a
    while e:
        if e & 1:
            acc = fp2_mul(acc, base)
        base = fp2_sqr(base)
        e >>= 1
    return acc


# --- Fp6: triples (c0, c1, c2) of Fp2 = c0 + c1 v + c2 v^2, v^3 = xi ---

FP6_ZERO = (FP2_ZERO, FP2_ZERO, FP2_ZERO)
FP6_ONE = (FP2_ONE, FP2_ZERO, FP2_ZERO)


def fp6_add(a, b):
    return tuple(fp2_add(x, y) for x, y in zip(a, b))


def fp6_sub(a, b):
    return tuple(fp2_sub(x, y) for x, y in zip(a, b))


def fp6_neg(a):
    return tuple(fp2_neg(x) for x in a)


def fp6_mul(a, b):
    a0, a1, a2 = a
    b0, b1, b2 = b
    t0 = fp2_mul(a0, b0)
    t1 = fp2_mul(a1, b1)
    t2 = fp2_mul(a2, b2)
    c0 = fp2_add(t0, fp2_mul_by_xi(
        fp2_sub(fp2_mul(fp2_add(a1, a2), fp2_add(b1, b2)), fp2_add(t1, t2))))
    c1 = fp2_add(
        fp2_sub(fp2_mul(fp2_add(a0, a1), fp2_add(b0, b1)), fp2_add(t0, t1)),
        fp2_mul_by_xi(t2))
    c2 = fp2_add(
        fp2_sub(fp2_mul(fp2_add(a0, a2), fp2_add(b0, b2)), fp2_add(t0, t2)),
        t1)
    return (c0, c1, c2)


def fp6_sqr(a):
    return fp6_mul(a, a)


def fp6_mul_by_v(a):
    """a * v  (shifts coefficients, wrapping through xi)."""
    return (fp2_mul_by_xi(a[2]), a[0], a[1])


def fp6_inv(a):
    a0, a1, a2 = a
    c0 = fp2_sub(fp2_sqr(a0), fp2_mul_by_xi(fp2_mul(a1, a2)))
    c1 = fp2_sub(fp2_mul_by_xi(fp2_sqr(a2)), fp2_mul(a0, a1))
    c2 = fp2_sub(fp2_sqr(a1), fp2_mul(a0, a2))
    t = fp2_add(
        fp2_mul_by_xi(fp2_add(fp2_mul(a2, c1), fp2_mul(a1, c2))),
        fp2_mul(a0, c0))
    tinv = fp2_inv(t)
    return (fp2_mul(c0, tinv), fp2_mul(c1, tinv), fp2_mul(c2, tinv))


# --- Fp12: pairs (d0, d1) of Fp6 = d0 + d1 w, w^2 = v ---

FP12_ZERO = (FP6_ZERO, FP6_ZERO)
FP12_ONE = (FP6_ONE, FP6_ZERO)


def fp12_add(a, b):
    return (fp6_add(a[0], b[0]), fp6_add(a[1], b[1]))


def fp12_sub(a, b):
    return (fp6_sub(a[0], b[0]), fp6_sub(a[1], b[1]))


def fp12_neg(a):
    return (fp6_neg(a[0]), fp6_neg(a[1]))


def fp12_mul(a, b):
    t0 = fp6_mul(a[0], b[0])
    t1 = fp6_mul(a[1], b[1])
    c0 = fp6_add(t0, fp6_mul_by_v(t1))
    c1 = fp6_sub(
        fp6_mul(fp6_add(a[0], a[1]), fp6_add(b[0], b[1])), fp6_add(t0, t1))
    return (c0, c1)


def fp12_sqr(a):
    return fp12_mul(a, a)


def fp12_conj(a):
    """Conjugate over Fp6 (= Frobenius^6): a0 - a1 w."""
    return (a[0], fp6_neg(a[1]))


def fp12_inv(a):
    t = fp6_sub(fp6_sqr(a[0]), fp6_mul_by_v(fp6_sqr(a[1])))
    tinv = fp6_inv(t)
    return (fp6_mul(a[0], tinv), fp6_neg(fp6_mul(a[1], tinv)))


def fp12_pow(a, e: int):
    if e < 0:
        return fp12_pow(fp12_inv(a), -e)
    acc = FP12_ONE
    base = a
    while e:
        if e & 1:
            acc = fp12_mul(acc, base)
        base = fp12_sqr(base)
        e >>= 1
    return acc


# embeddings

def fp_to_fp12(x: int):
    return (((x % P, 0), FP2_ZERO, FP2_ZERO), FP6_ZERO)


def fp2_to_fp12(x):
    return ((x, FP2_ZERO, FP2_ZERO), FP6_ZERO)


# w and its powers (for the twist map): w = (0, 1) in the Fp6 pair
FP12_W = (FP6_ZERO, FP6_ONE)
FP12_W2 = (  # w^2 = v
    (FP2_ZERO, FP2_ONE, FP2_ZERO), FP6_ZERO)
FP12_W3 = (  # w^3 = v*w
    FP6_ZERO, (FP2_ZERO, FP2_ONE, FP2_ZERO))


# --- Frobenius endomorphism and the hard part of the final exponentiation ---
#
# View Fp12 = Fp2[w]/(w^6 - xi): an element is sum a_i w^i, and our
# (Fp6, Fp6) pair [c00 + c01 v + c02 v^2 + w*(c10 + ...)] with v = w^2 is
# a = [c00, c10, c01, c11, c02, c12] in w-power order.
# pi^k(a)_i = conj^k(a_i) * xi^(i (p^k - 1)/6): six Fp2 multiplies instead
# of a 254k-bit fp12_pow.

_GAMMA = {}


def _gamma(k: int):
    if k not in _GAMMA:
        g1 = fp2_pow(XI, (P ** k - 1) // 6)
        row = [FP2_ONE]
        for _ in range(5):
            row.append(fp2_mul(row[-1], g1))
        _GAMMA[k] = row
    return _GAMMA[k]


def frobenius(a, k: int = 1):
    """a^(p^k) for k in {1, 2, 3} via coefficient tables."""
    assert 1 <= k <= 3
    gam = _gamma(k)
    (c00, c01, c02), (c10, c11, c12) = a
    out = []
    for i, ci in enumerate([c00, c10, c01, c11, c02, c12]):
        cc = fp2_conj(ci) if k % 2 else ci
        out.append(fp2_mul(cc, gam[i]))
    return ((out[0], out[2], out[4]), (out[1], out[3], out[5]))


def final_exp_hard(f, r: int):
    """f^((p^4 - p^2 + 1)/r) by 4-way Shamir multi-exponentiation over the
    p-adic digits of the exponent, with f^(p^k) from the Frobenius tables:
    exact by construction (the digits reassemble the exponent)."""
    d = (P ** 4 - P ** 2 + 1) // r
    digits = [d % P, (d // P) % P, (d // P ** 2) % P, d // P ** 3]
    assert sum(di * P ** i for i, di in enumerate(digits)) == d
    bases = [f, frobenius(f, 1), frobenius(f, 2), frobenius(f, 3)]
    pre = [FP12_ONE] * 16
    for m in range(1, 16):
        low = m & -m
        pre[m] = fp12_mul(pre[m ^ low], bases[low.bit_length() - 1])
    acc = FP12_ONE
    for bit in range(max(digits).bit_length() - 1, -1, -1):
        acc = fp12_sqr(acc)
        m = sum(((digits[i] >> bit) & 1) << i for i in range(4))
        if m:
            acc = fp12_mul(acc, pre[m])
    return acc
