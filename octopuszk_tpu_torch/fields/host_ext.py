"""Additional host-side extension fields: Fp3, Fp6 (2-over-3), Complex.

Port of the reference's algebra/fields/Fp3.java, Fp6_2Over3.java and
ComplexField.java (DIZK): tower variants of its other curve families and
the complex DFT of its FFT tests, on host python ints and floats.  They are
on no BN254 path; a copy of ``octopuszk_tpu/fields/host_ext.py``.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Fp3Params:
    p: int
    non_residue: int          # cubic non-residue c: u^3 = c


def fp3_add(par, a, b):
    return tuple((x + y) % par.p for x, y in zip(a, b))


def fp3_sub(par, a, b):
    return tuple((x - y) % par.p for x, y in zip(a, b))


def fp3_neg(par, a):
    return tuple((-x) % par.p for x in a)


def fp3_mul(par, a, b):
    p, c = par.p, par.non_residue
    a0, a1, a2 = a
    b0, b1, b2 = b
    t0, t1, t2 = a0 * b0 % p, a1 * b1 % p, a2 * b2 % p
    c0 = (t0 + c * ((a1 + a2) * (b1 + b2) - t1 - t2)) % p
    c1 = ((a0 + a1) * (b0 + b1) - t0 - t1 + c * t2) % p
    c2 = ((a0 + a2) * (b0 + b2) - t0 - t2 + t1) % p
    return (c0, c1, c2)


def fp3_one():
    return (1, 0, 0)


def fp3_inv(par, a):
    """Inverse via the norm map (standard cubic-extension formulas)."""
    p, c = par.p, par.non_residue
    a0, a1, a2 = a
    t0 = (a0 * a0 - c * a1 * a2) % p
    t1 = (c * a2 * a2 - a0 * a1) % p
    t2 = (a1 * a1 - a0 * a2) % p
    norm = (a0 * t0 + c * (a2 * t1 + a1 * t2)) % p
    ninv = pow(norm, -1, p)
    return (t0 * ninv % p, t1 * ninv % p, t2 * ninv % p)


# Fp6 as a quadratic extension of Fp3: (d0, d1) = d0 + d1 w, w^2 = u
def fp6_2over3_add(par, a, b):
    return (fp3_add(par, a[0], b[0]), fp3_add(par, a[1], b[1]))


def fp6_2over3_mul(par, a, b):
    t0 = fp3_mul(par, a[0], b[0])
    t1 = fp3_mul(par, a[1], b[1])
    # w^2 = u: multiply t1 by u (coefficient shift through the cubic n-r)
    u_t1 = (t1[2] * par.non_residue % par.p, t1[0], t1[1])
    c0 = fp3_add(par, t0, u_t1)
    s = fp3_mul(par, fp3_add(par, a[0], a[1]), fp3_add(par, b[0], b[1]))
    c1 = fp3_sub(par, fp3_sub(par, s, t0), t1)
    return (c0, c1)


def fp6_2over3_inv(par, a):
    # 1/(d0 + d1 w) = (d0 - d1 w)/(d0^2 - u d1^2)
    d1sq = fp3_mul(par, a[1], a[1])
    u_d1sq = (d1sq[2] * par.non_residue % par.p, d1sq[0], d1sq[1])
    t = fp3_sub(par, fp3_mul(par, a[0], a[0]), u_d1sq)
    tinv = fp3_inv(par, t)
    return (fp3_mul(par, a[0], tinv),
            fp3_neg(par, fp3_mul(par, a[1], tinv)))


# Complex doubles for FFT cross-checks (reference ComplexField.java)
def cadd(a, b):
    return (a[0] + b[0], a[1] + b[1])


def csub(a, b):
    return (a[0] - b[0], a[1] - b[1])


def cmul(a, b):
    return (a[0] * b[0] - a[1] * b[1], a[0] * b[1] + a[1] * b[0])


def naive_complex_dft(xs):
    """O(n^2) complex DFT used as the FFT oracle in the reference tests."""
    import math

    n = len(xs)
    out = []
    for k in range(n):
        acc = (0.0, 0.0)
        for j, x in enumerate(xs):
            ang = -2.0 * math.pi * j * k / n
            acc = cadd(acc, cmul(x, (math.cos(ang), math.sin(ang))))
        out.append(acc)
    return out
