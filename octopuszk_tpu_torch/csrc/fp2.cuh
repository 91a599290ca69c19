// Fp2 = Fp[u]/(u^2 - nr) on top of field.cuh, nr = M::kNr of the curve's
// Fq modulus: -1 (BN254a) or -5 (BN254b).  Same formulas as fields/fp2.py:
// Karatsuba product (3 base products), c0 = t0 + nr t1; square (2 base
// products) (a0 + a1)(a0 + nr a1) - (1 + nr) a0 a1 + 2 a0 a1 u, which for
// nr = -1 is (a0 + a1)(a0 - a1) + 2 a0 a1 u.  The products by nr are
// addition chains (mul_small), chosen at compile time: BN254a's code is
// the nr = -1 form alone.
#pragma once
#include "field.cuh"

template <class M>
struct Fp2 {
  Fp<M> c0, c1;
};

template <class M>
__device__ __forceinline__ Fp2<M> add(const Fp2<M>& a, const Fp2<M>& b) {
  return {add(a.c0, b.c0), add(a.c1, b.c1)};
}

template <class M>
__device__ __forceinline__ Fp2<M> sub(const Fp2<M>& a, const Fp2<M>& b) {
  return {sub(a.c0, b.c0), sub(a.c1, b.c1)};
}

template <class M>
__device__ __forceinline__ Fp2<M> neg(const Fp2<M>& a) {
  return {neg(a.c0), neg(a.c1)};
}

template <class M>
__device__ __forceinline__ Fp2<M> dbl(const Fp2<M>& a) {
  return {add(a.c0, a.c0), add(a.c1, a.c1)};
}

template <class M>
__device__ __forceinline__ bool is_zero(const Fp2<M>& a) {
  return is_zero(a.c0) && is_zero(a.c1);
}

template <class M>
__device__ Fp2<M> mul(const Fp2<M>& a, const Fp2<M>& b) {
  const Fp<M> t0 = mul(a.c0, b.c0);
  const Fp<M> t1 = mul(a.c1, b.c1);
  const Fp<M> s = mul(add(a.c0, a.c1), add(b.c0, b.c1));
  static_assert(M::kNr < 0, "the non-residue is negative");
  if constexpr (M::kNr == -1) {
    return {sub(t0, t1), sub(sub(s, t0), t1)};
  } else {
    return {sub(t0, mul_small<(unsigned)-M::kNr>(t1)), sub(sub(s, t0), t1)};
  }
}

template <class M>
__device__ Fp2<M> sqr(const Fp2<M>& a) {
  if constexpr (M::kNr == -1) {
    const Fp<M> m1 = mul(add(a.c0, a.c1), sub(a.c0, a.c1));
    const Fp<M> m2 = mul(a.c0, a.c1);
    return {m1, add(m2, m2)};
  } else {
    constexpr unsigned k = (unsigned)-M::kNr;     // nr = -k, 1 + nr = 1 - k
    const Fp<M> m1 = mul(add(a.c0, a.c1), sub(a.c0, mul_small<k>(a.c1)));
    const Fp<M> m2 = mul(a.c0, a.c1);
    return {add(m1, mul_small<k - 1>(m2)), add(m2, m2)};
  }
}
