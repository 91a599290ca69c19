"""BN curve bundles: field specs, device groups, host ops and the pairing,
as one object that Groth16 is generic over.

``bn254a()`` is the primary curve (its groups are the singletons of
curves/bn254.py, its pairing curves/pairing.py).  ``bn254b()`` is the
reference's second curve, run by its ``zksnark-large`` profiler app: u^2 =
-5 tower, xi = 3 + u, b = 13 (reference bn254b_parameters/*.java), built
from one ``BNParams`` by the generic machinery (fields/fp.py, fields/fp2.py,
curves/group_ops.py, fields/tower.py).  Its device groups are named
``bn254b-G1`` and ``bn254b-G2``; ops/kernels.py has a kernel of every
curve operation for them, as for ``G1`` and ``G2``.
"""

from __future__ import annotations

import dataclasses
import functools
import types

from octopuszk_tpu_torch.curves import bn254, group_ops as jac, host_curve, pairing
from octopuszk_tpu_torch.fields.spec import FQ, FQ_B, FR, FR_B, FieldSpec
from octopuszk_tpu_torch.fields.tower import HostTower


@dataclasses.dataclass(frozen=True)
class BNParams:
    name: str
    fq: FieldSpec
    fr: FieldSpec
    b: int                     # G1: y^2 = x^3 + b
    fq2_nr: int                # u^2 = nr
    xi: tuple                  # sextic non-residue and twist (D-type)
    g1_gen: tuple              # (x, y) ints
    g2_gen: tuple              # ((x0, x1), (y0, y1))
    ate_loop_count: int        # 6z + 2


class BNPairingHost:
    """Optimal ate pairing over a parameterized tower (host python ints).

    The algorithm of curves/pairing.py (the BN254a module): Miller loop
    over 6z + 2 with the two Frobenius correction steps, then the full
    final exponentiation."""

    def __init__(self, tw: HostTower, p: int, r: int, ate_loop: int):
        self.tw = tw
        self.p = p
        self.r = r
        self.ate_loop = ate_loop
        self.hard_exp = (p ** 4 - p ** 2 + 1) // r
        self.GT_ONE = tw.FP12_ONE

    def _lift_g2(self, q):
        tw = self.tw
        return (tw.fp12_mul(tw.fp2_to_fp12(q[0]), tw.FP12_W2),
                tw.fp12_mul(tw.fp2_to_fp12(q[1]), tw.FP12_W3))

    def _lift_g1(self, p):
        return (self.tw.fp_to_fp12(p[0]), self.tw.fp_to_fp12(p[1]))

    def _frob12(self, pt, times=1):
        tw = self.tw
        return (tw.frobenius(pt[0], times), tw.frobenius(pt[1], times))

    def _line_double(self, r, p12):
        tw = self.tw
        xr, yr = r
        xp, yp = p12
        three_x2 = tw.fp12_mul(tw.fp_to_fp12(3), tw.fp12_sqr(xr))
        lam = tw.fp12_mul(three_x2,
                          tw.fp12_inv(tw.fp12_mul(tw.fp_to_fp12(2), yr)))
        line = tw.fp12_sub(tw.fp12_sub(yp, yr),
                           tw.fp12_mul(lam, tw.fp12_sub(xp, xr)))
        x3 = tw.fp12_sub(tw.fp12_sqr(lam),
                         tw.fp12_mul(tw.fp_to_fp12(2), xr))
        y3 = tw.fp12_sub(tw.fp12_mul(lam, tw.fp12_sub(xr, x3)), yr)
        return line, (x3, y3)

    def _line_and_add(self, r, q, p12):
        tw = self.tw
        xr, yr = r
        xq, yq = q
        xp, yp = p12
        if xr == xq and yr == yq:
            return self._line_double(r, p12)
        if xr == xq:
            return tw.fp12_sub(xp, xr), None
        lam = tw.fp12_mul(tw.fp12_sub(yq, yr),
                          tw.fp12_inv(tw.fp12_sub(xq, xr)))
        line = tw.fp12_sub(tw.fp12_sub(yp, yr),
                           tw.fp12_mul(lam, tw.fp12_sub(xp, xr)))
        x3 = tw.fp12_sub(tw.fp12_sub(tw.fp12_sqr(lam), xr), xq)
        y3 = tw.fp12_sub(tw.fp12_mul(lam, tw.fp12_sub(xr, x3)), yr)
        return line, (x3, y3)

    def miller_loop(self, p, q):
        tw = self.tw
        if p is None or q is None:
            return tw.FP12_ONE
        p12 = self._lift_g1(p)
        q12 = self._lift_g2(q)
        f = tw.FP12_ONE
        r = q12
        for bit in bin(self.ate_loop)[3:]:
            line, r = self._line_double(r, p12)
            f = tw.fp12_mul(tw.fp12_sqr(f), line)
            if bit == "1":
                line, r = self._line_and_add(r, q12, p12)
                f = tw.fp12_mul(f, line)
        q1 = self._frob12(q12, 1)
        nq2 = self._frob12(q12, 2)
        nq2 = (nq2[0], tw.fp12_neg(nq2[1]))
        line, r = self._line_and_add(r, q1, p12)
        f = tw.fp12_mul(f, line)
        line, r = self._line_and_add(r, nq2, p12)
        f = tw.fp12_mul(f, line)
        return f

    def final_exponentiation(self, f):
        tw = self.tw
        f = tw.fp12_mul(tw.fp12_conj(f), tw.fp12_inv(f))  # ^(p^6 - 1)
        f = tw.fp12_mul(tw.frobenius(f, 2), f)            # ^(p^2 + 1)
        return tw.final_exp_hard(f, self.r)

    def reduced_pairing(self, p, q):
        return self.final_exponentiation(self.miller_loop(p, q))

    def gt_mul(self, a, b):
        return self.tw.fp12_mul(a, b)

    def gt_exp(self, a, e: int):
        return self.tw.fp12_pow(a, e % self.r)


def _host_namespaces(params: BNParams, tw: HostTower):
    """Host affine ops of G1 and G2 over this curve, and the twist's b."""
    p, r = params.fq.p, params.fr.p
    fp_ops = host_curve._Ops(
        add=lambda a, b: (a + b) % p, sub=lambda a, b: (a - b) % p,
        mul=lambda a, b: a * b % p, sqr=lambda a: a * a % p,
        neg=lambda a: (-a) % p, inv=lambda a: pow(a, -1, p),
        scalar=lambda a, k: a * k % p, zero=0, eq=lambda a, b: a == b)
    fp2_ops = host_curve._Ops(
        add=tw.fp2_add, sub=tw.fp2_sub, mul=tw.fp2_mul, sqr=tw.fp2_sqr,
        neg=tw.fp2_neg, inv=tw.fp2_inv, scalar=tw.fp2_scalar,
        zero=tw.FP2_ZERO, eq=lambda a, b: a == b)
    b2 = tw.fp2_mul((params.b % p, 0), tw.fp2_inv(params.xi))

    def make(ops, b):
        def naive_msm(scalars, points):
            acc = None
            for s, pt in zip(scalars, points):
                acc = host_curve._pt_add(
                    ops, acc, host_curve._pt_mul(ops, pt, s, r))
            return acc

        return types.SimpleNamespace(
            add=lambda a, b_: host_curve._pt_add(ops, a, b_),
            mul=lambda a, k: host_curve._pt_mul(ops, a, k, r),
            neg=lambda a: host_curve._pt_neg(ops, a),
            is_on_curve=lambda a: host_curve._on_curve(ops, a, b),
            naive_msm=naive_msm)

    return make(fp_ops, params.b % p), make(fp2_ops, b2), b2


class BNCurve:
    """One BN curve: Fr / Fq specs, device G1 / G2 groups, host ops, and the
    pairing (the bundle Groth16 is generic over)."""

    def __init__(self, params: BNParams):
        self.params = params
        self.name = params.name
        self.fq = params.fq
        self.fr = params.fr
        self.tower = HostTower(params.fq.p, params.fq2_nr, params.xi)
        host_g1, host_g2, b2 = _host_namespaces(params, self.tower)
        # what the kernels fix of the curve (ops/kernels.py): the Fp2
        # non-residue, 3 b on G1 and on the G2 twist (a pair of host ints)
        self.nr = params.fq2_nr
        self.b3 = 3 * params.b
        self.b3_g2 = self.tower.fp2_scalar(b2, 3)
        self.g1 = bn254._Group(
            f"{params.name}-G1",
            jac.make_fp_ops(params.fq, b3=self.b3,
                            group_name=f"{params.name}-G1"),
            params.g1_gen, 1, host_g1, fq=params.fq)
        self.g2 = bn254._Group(
            f"{params.name}-G2",
            jac.make_fp2_ops(params.fq, nr=self.nr, b3=self.b3_g2,
                             group_name=f"{params.name}-G2"),
            params.g2_gen, 2, host_g2, fq=params.fq)
        self.pairing = BNPairingHost(
            self.tower, params.fq.p, params.fr.p, params.ate_loop_count)


BN254B_PARAMS = BNParams(
    name="bn254b",
    fq=FQ_B,
    fr=FR_B,
    b=13,                      # BN254bPublicParameters.java:24
    fq2_nr=-5,                 # BN254bFq2Parameters.java:38 (p - 5)
    xi=(3, 1),                 # BN254bFq6Parameters.java:35; also the twist
    g1_gen=(6,
            8804219299324514492806343261084073560212908759422749787101710634723026910978),
    g2_gen=((5079609021644061220823125455176595404585595222550497085336148917057303814280,
             17041702796731330387964445988262372396109649438458604288057852904572562782012),
            (942715487274747883577565654509921632861746790272414915686456132777971395793,
             10226306760398461226809375285904929090012967024146452193615342198255969027831)),
    ate_loop_count=28315256757185150978,  # BN254bPublicParameters.java:37
)


@functools.cache
def bn254b() -> BNCurve:
    return BNCurve(BN254B_PARAMS)


@functools.cache
def bn254a() -> types.SimpleNamespace:
    return types.SimpleNamespace(
        name="bn254a", fq=FQ, fr=FR, g1=bn254.G1, g2=bn254.G2,
        pairing=pairing, nr=-1, b3=9, b3_g2=jac.g2_b3())
