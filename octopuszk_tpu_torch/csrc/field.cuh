// Prime-field arithmetic on eight 32-bit words, Montgomery form, R = 2^256.
//
// One thread holds one element in registers.  Every function returns a
// canonical value in [0, p), so results equal the plain PyTorch versions
// (ops/kernels.py) and the JAX reference bit for bit after a repack.
//
// The modulus is a template parameter (FrMod, FqMod).  Its constants come
// from constants.cuh, which ops/kernels.py writes from fields/spec.py at
// build time, so the two cannot drift apart.
#pragma once
#include <cstddef>
#include <cstdint>
#include "constants.cuh"

struct FrMod {
  static constexpr uint32_t N0INV = FR_N0INV;
  __device__ __forceinline__ static uint32_t p(int i) {
    constexpr uint32_t v[8] = FR_P_WORDS;
    return v[i];
  }
  __device__ __forceinline__ static uint32_t one(int i) {
    constexpr uint32_t v[8] = FR_ONE_WORDS;
    return v[i];
  }
};

struct FqMod {
  static constexpr uint32_t N0INV = FQ_N0INV;
  __device__ __forceinline__ static uint32_t p(int i) {
    constexpr uint32_t v[8] = FQ_P_WORDS;
    return v[i];
  }
  __device__ __forceinline__ static uint32_t one(int i) {
    constexpr uint32_t v[8] = FQ_ONE_WORDS;
    return v[i];
  }
};

template <class M>
struct Fp {
  uint32_t v[8];
};

// word k of element i lives at base[k * stride + i] (word-major layout)
template <class M>
__device__ __forceinline__ Fp<M> fp_load(const uint32_t* base, size_t stride,
                                         size_t i) {
  Fp<M> r;
#pragma unroll
  for (int k = 0; k < 8; k++) r.v[k] = base[k * stride + i];
  return r;
}

template <class M>
__device__ __forceinline__ void fp_store(uint32_t* base, size_t stride,
                                         size_t i, const Fp<M>& a) {
#pragma unroll
  for (int k = 0; k < 8; k++) base[k * stride + i] = a.v[k];
}

template <class M>
__device__ __forceinline__ Fp<M> fp_zero() {
  Fp<M> r;
#pragma unroll
  for (int k = 0; k < 8; k++) r.v[k] = 0u;
  return r;
}

template <class M>
__device__ __forceinline__ Fp<M> fp_one() {
  Fp<M> r;
#pragma unroll
  for (int k = 0; k < 8; k++) r.v[k] = M::one(k);
  return r;
}

template <class M>
__device__ __forceinline__ bool is_zero(const Fp<M>& a) {
  uint32_t acc = 0u;
#pragma unroll
  for (int k = 0; k < 8; k++) acc |= a.v[k];
  return acc == 0u;
}

// a - p if a >= p, else a  (a < 2p)
template <class M>
__device__ __forceinline__ Fp<M> reduce_once(const Fp<M>& a) {
  Fp<M> d;
  uint64_t br = 0;
#pragma unroll
  for (int k = 0; k < 8; k++) {
    uint64_t s = (uint64_t)a.v[k] - M::p(k) - br;
    d.v[k] = (uint32_t)s;
    br = s >> 63;
  }
  Fp<M> r;
#pragma unroll
  for (int k = 0; k < 8; k++) r.v[k] = br ? a.v[k] : d.v[k];
  return r;
}

template <class M>
__device__ __forceinline__ Fp<M> add(const Fp<M>& a, const Fp<M>& b) {
  Fp<M> s;
  uint64_t c = 0;
#pragma unroll
  for (int k = 0; k < 8; k++) {
    uint64_t t = (uint64_t)a.v[k] + b.v[k] + c;
    s.v[k] = (uint32_t)t;
    c = t >> 32;
  }
  return reduce_once(s);  // a + b < 2p < 2^255: no carry out of word 7
}

template <class M>
__device__ __forceinline__ Fp<M> dbl(const Fp<M>& a) {
  return add(a, a);
}

template <class M>
__device__ __forceinline__ Fp<M> sub(const Fp<M>& a, const Fp<M>& b) {
  Fp<M> d;
  uint64_t br = 0;
#pragma unroll
  for (int k = 0; k < 8; k++) {
    uint64_t s = (uint64_t)a.v[k] - b.v[k] - br;
    d.v[k] = (uint32_t)s;
    br = s >> 63;
  }
  Fp<M> e;
  uint64_t c = 0;
#pragma unroll
  for (int k = 0; k < 8; k++) {
    uint64_t t = (uint64_t)d.v[k] + M::p(k) + c;
    e.v[k] = (uint32_t)t;
    c = t >> 32;
  }
  Fp<M> r;
#pragma unroll
  for (int k = 0; k < 8; k++) r.v[k] = br ? e.v[k] : d.v[k];
  return r;
}

template <class M>
__device__ __forceinline__ Fp<M> neg(const Fp<M>& a) {
  Fp<M> d;
  uint64_t br = 0;
#pragma unroll
  for (int k = 0; k < 8; k++) {
    uint64_t s = (uint64_t)M::p(k) - a.v[k] - br;
    d.v[k] = (uint32_t)s;
    br = s >> 63;
  }
  const bool z = is_zero(a);
  Fp<M> r;
#pragma unroll
  for (int k = 0; k < 8; k++) r.v[k] = z ? 0u : d.v[k];
  return r;
}

// CIOS Montgomery product a * b * R^-1 mod p: eight rounds, each one row of
// the product (8 multiply-adds) and one reduction row (8 multiply-adds) on
// 64-bit accumulators, then one conditional subtract.
template <class M>
__device__ __forceinline__ Fp<M> mul(const Fp<M>& a, const Fp<M>& b) {
  uint32_t t[9];
#pragma unroll
  for (int j = 0; j < 9; j++) t[j] = 0u;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < 8; j++) {
      uint64_t s = (uint64_t)a.v[j] * b.v[i] + t[j] + c;
      t[j] = (uint32_t)s;
      c = s >> 32;
    }
    uint64_t s8 = (uint64_t)t[8] + c;
    const uint32_t t8 = (uint32_t)s8;
    const uint32_t t9 = (uint32_t)(s8 >> 32);
    const uint32_t m = t[0] * M::N0INV;
    uint64_t s = (uint64_t)m * M::p(0) + t[0];
    c = s >> 32;
#pragma unroll
    for (int j = 1; j < 8; j++) {
      s = (uint64_t)m * M::p(j) + t[j] + c;
      t[j - 1] = (uint32_t)s;
      c = s >> 32;
    }
    s = (uint64_t)t8 + c;
    t[7] = (uint32_t)s;
    t[8] = t9 + (uint32_t)(s >> 32);
  }
  // the value is < 2p < 2^255, so t[8] is zero here
  Fp<M> r;
#pragma unroll
  for (int k = 0; k < 8; k++) r.v[k] = t[k];
  return reduce_once(r);
}

template <class M>
__device__ __forceinline__ Fp<M> sqr(const Fp<M>& a) {
  return mul(a, a);
}
