"""Parameterized host-side extension tower: Fp2 / Fp6 / Fp12 over any BN
base field.

``HostTower(p, nr, xi)`` generalizes fields/host_tower.py (the BN254a
instance: nr = -1, xi = 9 + u) to any quadratic non-residue ``u^2 = nr``
and sextic non-residue ``xi`` in Fp2: BN254b's tower is u^2 = -5, xi = 3 + u
(reference bn254b_parameters/BN254bFq2Parameters.java:38,
BN254bFq6Parameters.java).  A copy of ``octopuszk_tpu/fields/tower.py``.

Pairings are O(1) per proof, so these run on host python ints.
"""

from __future__ import annotations


class HostTower:
    """Fp2 = Fp[u]/(u^2 - nr); Fp6 = Fp2[v]/(v^3 - xi); Fp12 = Fp6[w]/(w^2 - v)."""

    def __init__(self, p: int, nr: int, xi: tuple[int, int]):
        self.p = p
        self.nr = nr % p
        self.xi = (xi[0] % p, xi[1] % p)
        self.FP2_ZERO = (0, 0)
        self.FP2_ONE = (1, 0)
        self.FP6_ZERO = (self.FP2_ZERO,) * 3
        self.FP6_ONE = (self.FP2_ONE, self.FP2_ZERO, self.FP2_ZERO)
        self.FP12_ZERO = (self.FP6_ZERO, self.FP6_ZERO)
        self.FP12_ONE = (self.FP6_ONE, self.FP6_ZERO)
        # w and powers for the twist lift: w^2 = v, w^3 = v w
        v = (self.FP2_ZERO, self.FP2_ONE, self.FP2_ZERO)
        self.FP12_W2 = (v, self.FP6_ZERO)
        self.FP12_W3 = (self.FP6_ZERO, v)

    # --- Fp2 ---

    def fp2_add(self, a, b):
        p = self.p
        return ((a[0] + b[0]) % p, (a[1] + b[1]) % p)

    def fp2_sub(self, a, b):
        p = self.p
        return ((a[0] - b[0]) % p, (a[1] - b[1]) % p)

    def fp2_neg(self, a):
        p = self.p
        return ((-a[0]) % p, (-a[1]) % p)

    def fp2_mul(self, a, b):
        p, nr = self.p, self.nr
        return ((a[0] * b[0] + nr * a[1] * b[1]) % p,
                (a[0] * b[1] + a[1] * b[0]) % p)

    def fp2_sqr(self, a):
        return self.fp2_mul(a, a)

    def fp2_scalar(self, a, k: int):
        p = self.p
        return (a[0] * k % p, a[1] * k % p)

    def fp2_conj(self, a):
        return (a[0], (-a[1]) % self.p)

    def fp2_inv(self, a):
        # norm = a0^2 - nr a1^2
        p = self.p
        d = pow((a[0] * a[0] - self.nr * a[1] * a[1]) % p, -1, p)
        return (a[0] * d % p, (-a[1]) * d % p)

    def fp2_mul_by_xi(self, a):
        return self.fp2_mul(a, self.xi)

    def fp2_pow(self, a, e: int):
        acc, base = self.FP2_ONE, a
        while e:
            if e & 1:
                acc = self.fp2_mul(acc, base)
            base = self.fp2_sqr(base)
            e >>= 1
        return acc

    # --- Fp6 ---

    def fp6_add(self, a, b):
        return tuple(self.fp2_add(x, y) for x, y in zip(a, b))

    def fp6_sub(self, a, b):
        return tuple(self.fp2_sub(x, y) for x, y in zip(a, b))

    def fp6_neg(self, a):
        return tuple(self.fp2_neg(x) for x in a)

    def fp6_mul(self, a, b):
        m2, xi = self.fp2_mul, self.fp2_mul_by_xi
        a0, a1, a2 = a
        b0, b1, b2 = b
        t0, t1, t2 = m2(a0, b0), m2(a1, b1), m2(a2, b2)
        c0 = self.fp2_add(t0, xi(self.fp2_sub(
            m2(self.fp2_add(a1, a2), self.fp2_add(b1, b2)),
            self.fp2_add(t1, t2))))
        c1 = self.fp2_add(self.fp2_sub(
            m2(self.fp2_add(a0, a1), self.fp2_add(b0, b1)),
            self.fp2_add(t0, t1)), xi(t2))
        c2 = self.fp2_add(self.fp2_sub(
            m2(self.fp2_add(a0, a2), self.fp2_add(b0, b2)),
            self.fp2_add(t0, t2)), t1)
        return (c0, c1, c2)

    def fp6_sqr(self, a):
        return self.fp6_mul(a, a)

    def fp6_mul_by_v(self, a):
        return (self.fp2_mul_by_xi(a[2]), a[0], a[1])

    def fp6_inv(self, a):
        m2, xi = self.fp2_mul, self.fp2_mul_by_xi
        a0, a1, a2 = a
        c0 = self.fp2_sub(self.fp2_sqr(a0), xi(m2(a1, a2)))
        c1 = self.fp2_sub(xi(self.fp2_sqr(a2)), m2(a0, a1))
        c2 = self.fp2_sub(self.fp2_sqr(a1), m2(a0, a2))
        t = self.fp2_add(
            xi(self.fp2_add(m2(a2, c1), m2(a1, c2))), m2(a0, c0))
        tinv = self.fp2_inv(t)
        return (m2(c0, tinv), m2(c1, tinv), m2(c2, tinv))

    # --- Fp12 ---

    def fp12_add(self, a, b):
        return (self.fp6_add(a[0], b[0]), self.fp6_add(a[1], b[1]))

    def fp12_sub(self, a, b):
        return (self.fp6_sub(a[0], b[0]), self.fp6_sub(a[1], b[1]))

    def fp12_neg(self, a):
        return (self.fp6_neg(a[0]), self.fp6_neg(a[1]))

    def fp12_mul(self, a, b):
        t0 = self.fp6_mul(a[0], b[0])
        t1 = self.fp6_mul(a[1], b[1])
        c0 = self.fp6_add(t0, self.fp6_mul_by_v(t1))
        c1 = self.fp6_sub(
            self.fp6_mul(self.fp6_add(a[0], a[1]),
                         self.fp6_add(b[0], b[1])),
            self.fp6_add(t0, t1))
        return (c0, c1)

    def fp12_sqr(self, a):
        return self.fp12_mul(a, a)

    def fp12_conj(self, a):
        return (a[0], self.fp6_neg(a[1]))

    def fp12_inv(self, a):
        t = self.fp6_sub(self.fp6_sqr(a[0]),
                         self.fp6_mul_by_v(self.fp6_sqr(a[1])))
        tinv = self.fp6_inv(t)
        return (self.fp6_mul(a[0], tinv),
                self.fp6_neg(self.fp6_mul(a[1], tinv)))

    def fp12_pow(self, a, e: int):
        if e < 0:
            return self.fp12_pow(self.fp12_inv(a), -e)
        acc, base = self.FP12_ONE, a
        while e:
            if e & 1:
                acc = self.fp12_mul(acc, base)
            base = self.fp12_sqr(base)
            e >>= 1
        return acc

    # --- embeddings ---

    def fp_to_fp12(self, x: int):
        return (((x % self.p, 0), self.FP2_ZERO, self.FP2_ZERO),
                self.FP6_ZERO)

    def fp2_to_fp12(self, x):
        return ((x, self.FP2_ZERO, self.FP2_ZERO), self.FP6_ZERO)

    # --- Frobenius endomorphism ---
    #
    # View Fp12 = Fp2[w]/(w^6 - xi): an element is sum a_i w^i with the
    # map to our (Fp6, Fp6) pair [c00 + c01 v + c02 v^2 + w*(c10 + ...)
    # with v = w^2] being a = [c00, c10, c01, c11, c02, c12] in w-power
    # order.  pi^k(a)_i = conj^k(a_i) * xi^(i (p^k - 1)/6): six cheap Fp2
    # multiplies instead of a 254k-bit fp12_pow.  (Role of the reference's
    # FrobeniusCoefficientsC1 tables, BN254bFq12Parameters.java:37-52.)

    def _gamma(self, k: int):
        cache = getattr(self, "_gamma_cache", None)
        if cache is None:
            cache = {}
            object.__setattr__(self, "_gamma_cache", cache)
        if k not in cache:
            e = (self.p ** k - 1) // 6
            g1 = self.fp2_pow(self.xi, e)
            row = [self.FP2_ONE]
            for _ in range(5):
                row.append(self.fp2_mul(row[-1], g1))
            cache[k] = row
        return cache[k]

    def _to_w_coeffs(self, a):
        (c00, c01, c02), (c10, c11, c12) = a
        return [c00, c10, c01, c11, c02, c12]

    def _from_w_coeffs(self, w):
        return ((w[0], w[2], w[4]), (w[1], w[3], w[5]))

    def frobenius(self, a, k: int = 1):
        """a^(p^k) for k in {1, 2, 3} via coefficient tables."""
        assert 1 <= k <= 3
        gam = self._gamma(k)
        coeffs = self._to_w_coeffs(a)
        out = []
        for i, ci in enumerate(coeffs):
            cc = self.fp2_conj(ci) if k % 2 else ci
            out.append(self.fp2_mul(cc, gam[i]))
        return self._from_w_coeffs(out)

    def final_exp_hard(self, f, r: int):
        """f^((p^4 - p^2 + 1)/r) by 4-way Shamir multi-exponentiation
        over the p-adic digits of the exponent, with f^(p^k) from the
        Frobenius tables — ~8x fewer Fp12 ops than a plain pow of the
        ~3000-bit exponent, and exact by construction (the digits
        reassemble the exponent; no hand-derived addition chain).
        Requires nothing of f (valid for any Fp12 element)."""
        p = self.p
        d = (p ** 4 - p ** 2 + 1) // r
        digits = [d % p, (d // p) % p, (d // p ** 2) % p, d // p ** 3]
        assert sum(di * p ** i for i, di in enumerate(digits)) == d
        bases = [f, self.frobenius(f, 1), self.frobenius(f, 2),
                 self.frobenius(f, 3)]
        pre = [self.FP12_ONE] * 16
        for m in range(1, 16):
            low = m & -m
            pre[m] = self.fp12_mul(pre[m ^ low],
                                   bases[low.bit_length() - 1])
        acc = self.FP12_ONE
        for bit in range(max(digits).bit_length() - 1, -1, -1):
            acc = self.fp12_sqr(acc)
            m = sum(((digits[i] >> bit) & 1) << i for i in range(4))
            if m:
                acc = self.fp12_mul(acc, pre[m])
        return acc
