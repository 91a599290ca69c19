// Complete projective curve arithmetic for a = 0 curves (Renes, Costello,
// Batina 2015, algorithms 7, 8, 9), templated on the coordinate field:
// Fp<FqMod> for G1, Fp2<FqMod> for G2.  The identity is (0, 1, 0).  The
// formulas are those of curves/group_ops.py, term for term, so the
// projective coordinates that come out are the same words.
#pragma once
#include "fp2.cuh"

typedef Fp<FqMod> G1Coord;
typedef Fp2<FqMod> G2Coord;

// b3 = 3 b: 9 on G1 (an addition chain), 3 * (3 / (9 + u)) on the G2 twist
__device__ __forceinline__ G1Coord mul_b3(const G1Coord& a) {
  const G1Coord a8 = dbl(dbl(dbl(a)));
  return add(a, a8);
}

__device__ __forceinline__ G2Coord mul_b3(const G2Coord& a) {
  constexpr uint32_t c0[8] = G2_B3_C0_WORDS;
  constexpr uint32_t c1[8] = G2_B3_C1_WORDS;
  G2Coord b3;
#pragma unroll
  for (int k = 0; k < 8; k++) {
    b3.c0.v[k] = c0[k];
    b3.c1.v[k] = c1[k];
  }
  return mul(a, b3);
}

__device__ __forceinline__ void coord_zero(G1Coord& c) { c = fp_zero<FqMod>(); }
__device__ __forceinline__ void coord_one(G1Coord& c) { c = fp_one<FqMod>(); }
__device__ __forceinline__ void coord_zero(G2Coord& c) {
  c.c0 = fp_zero<FqMod>();
  c.c1 = fp_zero<FqMod>();
}
__device__ __forceinline__ void coord_one(G2Coord& c) {
  c.c0 = fp_one<FqMod>();
  c.c1 = fp_zero<FqMod>();
}

template <class C>
struct Pt {
  C x, y, z;
};

// P + Q, complete (algorithm 7): 12 products and 2 mul_b3
template <class C>
__device__ __forceinline__ Pt<C> pt_add(const Pt<C>& p, const Pt<C>& q) {
  C t0 = mul(p.x, q.x);
  C t1 = mul(p.y, q.y);
  C t2 = mul(p.z, q.z);
  C t3 = mul(add(p.x, p.y), add(q.x, q.y));
  C t4 = mul(add(p.y, p.z), add(q.y, q.z));
  C t5 = mul(add(p.x, p.z), add(q.x, q.z));
  t3 = sub(t3, add(t0, t1));
  t4 = sub(t4, add(t1, t2));
  t5 = sub(t5, add(t0, t2));
  const C three_t0 = add(dbl(t0), t0);
  const C b3t2 = mul_b3(t2);
  const C z3 = add(t1, b3t2);
  t1 = sub(t1, b3t2);
  const C y3 = mul_b3(t5);
  Pt<C> r;
  r.x = sub(mul(t3, t1), mul(t4, y3));
  r.y = add(mul(y3, three_t0), mul(t1, z3));
  r.z = add(mul(z3, t4), mul(three_t0, t3));
  return r;
}

// [2]P, complete (algorithm 9): 8 products and 1 mul_b3
template <class C>
__device__ __forceinline__ Pt<C> pt_double(const Pt<C>& p) {
  C t0 = mul(p.y, p.y);
  const C t1 = mul(p.y, p.z);
  const C tzz = mul(p.z, p.z);
  const C txy = mul(p.x, p.y);
  const C z3 = dbl(dbl(dbl(t0)));
  const C t2 = mul_b3(tzz);
  const C y3a = add(t0, t2);
  const C t2_3 = add(dbl(t2), t2);
  t0 = sub(t0, t2_3);
  Pt<C> r;
  r.x = dbl(mul(t0, txy));
  r.y = add(mul(t2, z3), mul(t0, y3a));
  r.z = mul(t1, z3);
  return r;
}

// P (projective) + Q (affine, not the identity), complete in P
// (algorithm 8): 11 products and 2 mul_b3.  The terms are those of
// group_ops.py; they are computed in the order that keeps the fewest
// coordinates alive (Z1's three products first, then X1 and Y1's, each
// output product as soon as its operands exist), which is what keeps the
// G2 scan inside its register budget.
template <class C>
__device__ __forceinline__ Pt<C> pt_mixed_add(const Pt<C>& p, const C& x2,
                                              const C& y2) {
  const C t4 = add(mul(x2, p.z), p.x);        // X1 + X2 Z1
  const C t5 = add(mul(y2, p.z), p.y);        // Y1 + Y2 Z1
  const C b3z1 = mul_b3(p.z);
  C t3 = mul(add(x2, y2), add(p.x, p.y));
  const C t0 = mul(p.x, x2);
  C t1 = mul(p.y, y2);
  t3 = sub(t3, add(t0, t1));                  // X1 Y2 + X2 Y1
  const C three_t0 = add(dbl(t0), t0);
  const C z3 = add(t1, b3z1);
  t1 = sub(t1, b3z1);
  const C y3 = mul_b3(t4);
  Pt<C> r;
  const C t3t1 = mul(t3, t1);
  const C t1z3 = mul(t1, z3);
  r.x = sub(t3t1, mul(t5, y3));
  r.y = add(mul(y3, three_t0), t1z3);
  r.z = add(mul(z3, t5), mul(three_t0, t3));
  return r;
}
