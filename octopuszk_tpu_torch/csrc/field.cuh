// Prime-field arithmetic on eight 32-bit words, Montgomery form, R = 2^256.
//
// One thread holds one element in registers.  Every function returns a
// canonical value in [0, p), so results equal the plain PyTorch versions
// (ops/kernels.py) and the JAX reference bit for bit after a repack.
//
// The modulus is a template parameter: FrMod, FqMod (BN254a), FrbMod,
// FqbMod (BN254b), SmallMod, LargeMod (the test fields of no curve).  Its
// constants come from constants.cuh, which ops/kernels.py writes from the
// field specs at build time, so the two cannot drift apart.
//
// The one bound on the modulus: p < 2^255 (constants_header refuses any
// other), so 2p < 2^256 and every value below 2p fits eight words.  What
// rests on it, with a < p and b < p canonical:
// * add: a + b < 2p < 2^256, so no carry leaves word 7, and reduce_once
//   (which takes any value below 2p) makes it canonical; sub and neg need
//   only p < 2^256.
// * mul (CIOS): between rounds the value V is below 2p; a round forms
//   U = V + a * b_i + m * p < 2p + 2 (2^32 - 1) p < 2^33 p < 2^288, nine
//   words, and U / 2^32 < 2p again.  U is held as an even array (words 0
//   to 7) plus an odd array one word higher (words 1 to 8).  Every term is
//   non-negative, so the odd array alone is at most U / 2^32 < 2^256: no
//   carry leaves its word 8, and the even array's carry out of word 7,
//   which weighs 2^256, lands in the odd array's top word.  After the last
//   round the result is below 2p < 2^256 and one reduce_once finishes.
// BN254's moduli (below 2^254) and LARGE's (about 2^254.86) run the same
// code: the bound costs no extra word or subtract.
#pragma once
#include <cstddef>
#include <cstdint>
#include "constants.cuh"

// 32-bit add, subtract and multiply-add steps of a carry chain.  On the
// card each is one PTX instruction on the condition-code carry flag
// (add.cc, addc.cc, sub.cc, mad.lo.cc, madc.hi.cc, ...); the statements are
// volatile, so they stay in program order, and nothing else between them
// writes the flag.  Compiled for the host (a C++ compiler without CUDA, as
// the tests do) the flag is a variable and each step is its definition.
namespace cc {
#if defined(__CUDA_ARCH__)
#define OZ_CC_ASM2(op, a, b)                                            \
  uint32_t r;                                                           \
  asm volatile(op " %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));           \
  return r
#define OZ_CC_ASM3(op, a, b, c)                                         \
  uint32_t r;                                                           \
  asm volatile(op " %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c)); \
  return r
#else
inline thread_local uint32_t flag = 0;
#endif

__host__ __device__ __forceinline__ uint32_t add_cc(uint32_t a, uint32_t b) {
#if defined(__CUDA_ARCH__)
  OZ_CC_ASM2("add.cc.u32", a, b);
#else
  const uint64_t s = (uint64_t)a + b;
  flag = (uint32_t)(s >> 32);
  return (uint32_t)s;
#endif
}
__host__ __device__ __forceinline__ uint32_t addc_cc(uint32_t a, uint32_t b) {
#if defined(__CUDA_ARCH__)
  OZ_CC_ASM2("addc.cc.u32", a, b);
#else
  const uint64_t s = (uint64_t)a + b + flag;
  flag = (uint32_t)(s >> 32);
  return (uint32_t)s;
#endif
}
__host__ __device__ __forceinline__ uint32_t addc(uint32_t a, uint32_t b) {
#if defined(__CUDA_ARCH__)
  OZ_CC_ASM2("addc.u32", a, b);
#else
  return a + b + flag;
#endif
}
// the flag after a subtraction is its borrow
__host__ __device__ __forceinline__ uint32_t sub_cc(uint32_t a, uint32_t b) {
#if defined(__CUDA_ARCH__)
  OZ_CC_ASM2("sub.cc.u32", a, b);
#else
  flag = a < b;
  return a - b;
#endif
}
__host__ __device__ __forceinline__ uint32_t subc_cc(uint32_t a, uint32_t b) {
#if defined(__CUDA_ARCH__)
  OZ_CC_ASM2("subc.cc.u32", a, b);
#else
  const uint64_t d = (uint64_t)a - b - flag;
  flag = (uint32_t)(d >> 63);
  return (uint32_t)d;
#endif
}
__host__ __device__ __forceinline__ uint32_t subc(uint32_t a, uint32_t b) {
#if defined(__CUDA_ARCH__)
  OZ_CC_ASM2("subc.u32", a, b);
#else
  return a - b - flag;
#endif
}
__host__ __device__ __forceinline__ uint32_t mul_lo(uint32_t a, uint32_t b) {
  return a * b;
}
__host__ __device__ __forceinline__ uint32_t mul_hi(uint32_t a, uint32_t b) {
#if defined(__CUDA_ARCH__)
  return __umulhi(a, b);
#else
  return (uint32_t)(((uint64_t)a * b) >> 32);
#endif
}
__host__ __device__ __forceinline__ uint32_t mad_lo_cc(uint32_t a, uint32_t b,
                                                       uint32_t c) {
#if defined(__CUDA_ARCH__)
  OZ_CC_ASM3("mad.lo.cc.u32", a, b, c);
#else
  const uint64_t s = (uint64_t)(a * b) + c;
  flag = (uint32_t)(s >> 32);
  return (uint32_t)s;
#endif
}
__host__ __device__ __forceinline__ uint32_t madc_lo_cc(uint32_t a, uint32_t b,
                                                        uint32_t c) {
#if defined(__CUDA_ARCH__)
  OZ_CC_ASM3("madc.lo.cc.u32", a, b, c);
#else
  const uint64_t s = (uint64_t)(a * b) + c + flag;
  flag = (uint32_t)(s >> 32);
  return (uint32_t)s;
#endif
}
__host__ __device__ __forceinline__ uint32_t madc_hi_cc(uint32_t a, uint32_t b,
                                                        uint32_t c) {
#if defined(__CUDA_ARCH__)
  OZ_CC_ASM3("madc.hi.cc.u32", a, b, c);
#else
  const uint64_t s = (((uint64_t)a * b) >> 32) + c + flag;
  flag = (uint32_t)(s >> 32);
  return (uint32_t)s;
#endif
}
__host__ __device__ __forceinline__ uint32_t madc_hi(uint32_t a, uint32_t b,
                                                     uint32_t c) {
#if defined(__CUDA_ARCH__)
  OZ_CC_ASM3("madc.hi.u32", a, b, c);
#else
  return (uint32_t)((((uint64_t)a * b) >> 32) + c + flag);
#endif
}
#undef OZ_CC_ASM2
#undef OZ_CC_ASM3
}  // namespace cc

// A modulus: its words, one in Montgomery form (R mod p) and -p^-1 mod
// 2^32.  A curve's Fq modulus carries the curve's traits as well: kNr, the
// Fp2 non-residue (u^2 = kNr, fp2.cuh); kB3, 3 b on G1; b3_c0 / b3_c1, the
// words of 3 b on the G2 twist (rcb.cuh).
#define OZ_MODULUS(TAG)                                     \
  static constexpr uint32_t N0INV = TAG##_N0INV;            \
  __device__ __forceinline__ static uint32_t p(int i) {     \
    constexpr uint32_t v[8] = TAG##_P_WORDS;                \
    return v[i];                                            \
  }                                                         \
  __device__ __forceinline__ static uint32_t one(int i) {   \
    constexpr uint32_t v[8] = TAG##_ONE_WORDS;              \
    return v[i];                                            \
  }
#define OZ_CURVE_TRAITS(TAG)                                \
  static constexpr int kNr = TAG##_NR;                      \
  static constexpr unsigned kB3 = TAG##_G1_B3;              \
  __device__ __forceinline__ static uint32_t b3_c0(int i) { \
    constexpr uint32_t v[8] = TAG##_G2_B3_C0_WORDS;         \
    return v[i];                                            \
  }                                                         \
  __device__ __forceinline__ static uint32_t b3_c1(int i) { \
    constexpr uint32_t v[8] = TAG##_G2_B3_C1_WORDS;         \
    return v[i];                                            \
  }

// BN254a
struct FrMod {
  OZ_MODULUS(FR)
};
struct FqMod {
  OZ_MODULUS(FQ)
  OZ_CURVE_TRAITS(FQ)
};
// BN254b
struct FrbMod {
  OZ_MODULUS(FRB)
};
struct FqbMod {
  OZ_MODULUS(FQB)
  OZ_CURVE_TRAITS(FQB)
};
// the test fields, of no curve: a 62-bit and a 255-bit modulus
struct SmallMod {
  OZ_MODULUS(SMALL)
};
struct LargeMod {
  OZ_MODULUS(LARGE)
};
#undef OZ_MODULUS
#undef OZ_CURVE_TRAITS

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
  d.v[0] = cc::sub_cc(a.v[0], M::p(0));
#pragma unroll
  for (int k = 1; k < 8; k++) d.v[k] = cc::subc_cc(a.v[k], M::p(k));
  const uint32_t borrow = cc::subc(0u, 0u);  // all ones if a < p
  Fp<M> r;
#pragma unroll
  for (int k = 0; k < 8; k++) r.v[k] = borrow ? a.v[k] : d.v[k];
  return r;
}

template <class M>
__device__ __forceinline__ Fp<M> add(const Fp<M>& a, const Fp<M>& b) {
  Fp<M> s;
  s.v[0] = cc::add_cc(a.v[0], b.v[0]);
#pragma unroll
  for (int k = 1; k < 7; k++) s.v[k] = cc::addc_cc(a.v[k], b.v[k]);
  s.v[7] = cc::addc(a.v[7], b.v[7]);  // a + b < 2p < 2^256: no carry out
  return reduce_once(s);
}

template <class M>
__device__ __forceinline__ Fp<M> dbl(const Fp<M>& a) {
  return add(a, a);
}

// a - b, plus p where that borrowed
template <class M>
__device__ __forceinline__ Fp<M> sub(const Fp<M>& a, const Fp<M>& b) {
  Fp<M> d;
  d.v[0] = cc::sub_cc(a.v[0], b.v[0]);
#pragma unroll
  for (int k = 1; k < 8; k++) d.v[k] = cc::subc_cc(a.v[k], b.v[k]);
  const uint32_t mask = cc::subc(0u, 0u);  // all ones if a < b
  Fp<M> r;
  r.v[0] = cc::add_cc(d.v[0], M::p(0) & mask);
#pragma unroll
  for (int k = 1; k < 7; k++) r.v[k] = cc::addc_cc(d.v[k], M::p(k) & mask);
  r.v[7] = cc::addc(d.v[7], M::p(7) & mask);
  return r;
}

// k * a for a constant k > 0 by the double-and-add chain of fields/fp.py
// mul_small, from the low bit: the running double is added where a bit
// of k is set (b3 = 9: a + 8a; 39: a + 2a + 4a + 32a)
template <unsigned K, class M>
__device__ __forceinline__ Fp<M> mul_small(const Fp<M>& a) {
  static_assert(K > 0, "mul_small needs k > 0");
  if constexpr (K == 1) {
    return a;
  } else if constexpr (K & 1u) {
    return add(a, mul_small<K / 2>(dbl(a)));
  } else {
    return mul_small<K / 2>(dbl(a));
  }
}

template <class M>
__device__ __forceinline__ Fp<M> neg(const Fp<M>& a) {
  Fp<M> d;
  d.v[0] = cc::sub_cc(M::p(0), a.v[0]);
#pragma unroll
  for (int k = 1; k < 8; k++) d.v[k] = cc::subc_cc(M::p(k), a.v[k]);
  const bool z = is_zero(a);
  Fp<M> r;
#pragma unroll
  for (int k = 0; k < 8; k++) r.v[k] = z ? 0u : d.v[k];
  return r;
}

// CIOS Montgomery product a * b * R^-1 mod p on PTX carry chains, with the
// even/odd split of sppark's mont_t: the partial products a[j] * b[i] of
// even j land in ``even`` (low word at j, high word at j + 1), those of odd
// j in ``odd``, which stands one word higher, so each row of eight
// products is one carry chain of mad.lo / mad.hi pairs and no word is
// shifted.  The running value is even + 2^32 * odd.  A round adds
// a * b[i] and m * p (m = even[0] * N0INV makes the low word zero), then
// divides by 2^32 by trading the two arrays' roles: the next round's even
// array is this round's odd one plus even[1], its odd array is even[2..7]
// (the shift folded into the next row's multiply-adds).  A round's value
// stays below 2^288 and the value between rounds below 2p (the bound at
// the top of this file), so the odd array's own top carry is always zero
// and the one carry chain that may leave the even array is added into the
// odd array's top word.  After eight rounds one merge adds
// the arrays and one conditional subtract makes the result canonical.
namespace mont {

// acc[j], acc[j + 1] = lo, hi of a[j] * bi for even j (a: 8 words, from
// ``first`` on, every second one)
__device__ __forceinline__ void mul_row(uint32_t* acc, const uint32_t* a,
                                        uint32_t bi) {
#pragma unroll
  for (int j = 0; j < 8; j += 2) {
    acc[j] = cc::mul_lo(a[j], bi);
    acc[j + 1] = cc::mul_hi(a[j], bi);
  }
}

// acc += sum over even j of a[j] * bi * 2^(32 j), one carry chain; the
// carry out of acc[7] is left in the flag
__device__ __forceinline__ void mad_row(uint32_t* acc, const uint32_t* a,
                                        uint32_t bi) {
  acc[0] = cc::mad_lo_cc(a[0], bi, acc[0]);
  acc[1] = cc::madc_hi_cc(a[0], bi, acc[1]);
#pragma unroll
  for (int j = 2; j < 8; j += 2) {
    acc[j] = cc::madc_lo_cc(a[j], bi, acc[j]);
    acc[j + 1] = cc::madc_hi_cc(a[j], bi, acc[j + 1]);
  }
}

// odd = (odd >> 64) + sum over even j of a[j] * bi * 2^(32 j), continuing
// the carry chain in the flag; nothing leaves the top word
__device__ __forceinline__ void mad_row_shift(uint32_t* odd, const uint32_t* a,
                                              uint32_t bi) {
#pragma unroll
  for (int j = 0; j < 6; j += 2) {
    odd[j] = cc::madc_lo_cc(a[j], bi, odd[j + 2]);
    odd[j + 1] = cc::madc_hi_cc(a[j], bi, odd[j + 3]);
  }
  odd[6] = cc::madc_lo_cc(a[6], bi, 0u);
  odd[7] = cc::madc_hi(a[6], bi, 0u);
}

// one round: value += a * bi, then += m * p with the low word made zero
template <class M>
__device__ __forceinline__ void cios_round(uint32_t* even, uint32_t* odd,
                                      const uint32_t* a, const uint32_t* a_odd,
                                      uint32_t bi, bool first) {
  if (first) {
    mul_row(odd, a_odd, bi);
    mul_row(even, a, bi);
  } else {
    even[0] = cc::add_cc(even[0], odd[1]);
    mad_row_shift(odd, a_odd, bi);
    mad_row(even, a, bi);
    odd[7] = cc::addc(odd[7], 0u);
  }
  const uint32_t m = even[0] * M::N0INV;
  uint32_t p_even[8], p_odd[8];
#pragma unroll
  for (int j = 0; j < 8; j += 2) {
    p_even[j] = M::p(j);
    p_odd[j] = M::p(j + 1);
  }
  mad_row(odd, p_odd, m);   // its carry out is zero (see above)
  mad_row(even, p_even, m);
  odd[7] = cc::addc(odd[7], 0u);
}

}  // namespace mont

template <class M>
__device__ __forceinline__ Fp<M> mul(const Fp<M>& a, const Fp<M>& b) {
  uint32_t even[8], odd[8], a_even[8], a_odd[8];
#pragma unroll
  for (int j = 0; j < 8; j += 2) {
    a_even[j] = a.v[j];
    a_odd[j] = a.v[j + 1];
  }
#pragma unroll
  for (int i = 0; i < 8; i += 2) {
    mont::cios_round<M>(even, odd, a_even, a_odd, b.v[i], i == 0);
    mont::cios_round<M>(odd, even, a_even, a_odd, b.v[i + 1], false);
  }
  // value = (odd + 2^32 * even) / 2^32 with odd[0] = 0
  Fp<M> r;
  r.v[0] = cc::add_cc(even[0], odd[1]);
#pragma unroll
  for (int k = 1; k < 7; k++) r.v[k] = cc::addc_cc(even[k], odd[k + 1]);
  r.v[7] = cc::addc(even[7], 0u);
  return reduce_once(r);
}

template <class M>
__device__ __forceinline__ Fp<M> sqr(const Fp<M>& a) {
  return mul(a, a);
}

// An exponent known to the host: eight little-endian words and the index
// of its top set bit (-1 for the exponent 0).
struct Exponent {
  uint32_t w[8];
  int top;
};

// a^e by square-and-multiply from the most significant bit, as
// fields/fp.py pow_const: acc = a, then for each lower bit acc = acc^2 and,
// where the bit is set, acc = acc * a.  a^0 is one.  Every step waits on
// the one before, so a thread's chain is its dependent latency: 253
// squares and 109 products for BN254's q - 2.
template <class M>
__device__ __forceinline__ Fp<M> pow_exp(const Fp<M>& a, const Exponent& e) {
  if (e.top < 0) return fp_one<M>();
  Fp<M> acc = a;
#pragma unroll 1
  for (int b = e.top - 1; b >= 0; b--) {
    acc = sqr(acc);
    if ((e.w[b >> 5] >> (b & 31)) & 1u) acc = mul(acc, a);
  }
  return acc;
}

// One lane of the two-level Montgomery batch inversion of a word-major
// [8, n] batch (fields/fp.py batch_inv_rows): lane l owns the positions
// l, l + lanes, l + 2 lanes, ... below n.  The forward sweep writes each
// position's exclusive prefix product into ``out`` (a zero counts as one),
// the lane total is raised to ``pm2`` = p - 2 (Fermat; the total is
// never zero), and the backward sweep overwrites each prefix with
// prefix * (inverse of the running product up to and including it), the
// position's inverse.  A zero maps to zero.  The inverse of an element is
// unique and canonical, so how positions are grouped into lanes does not
// change a word of the result.
template <class M>
__device__ __forceinline__ void batch_inv_lane(const uint32_t* a,
                                               uint32_t* out, size_t n,
                                               size_t lanes, size_t l,
                                               const Exponent& pm2) {
  if (l >= n) return;
  const size_t rows = (n - 1 - l) / lanes + 1;
  Fp<M> carry = fp_one<M>();
#pragma unroll 1
  for (size_t r = 0; r < rows; r++) {
    const size_t pos = l + r * lanes;
    fp_store<M>(out, n, pos, carry);
    const Fp<M> x = fp_load<M>(a, n, pos);
    if (!is_zero(x)) carry = mul(carry, x);
  }
  carry = pow_exp(carry, pm2);
#pragma unroll 1
  for (size_t r = rows; r-- > 0;) {
    const size_t pos = l + r * lanes;
    const Fp<M> x = fp_load<M>(a, n, pos);
    if (is_zero(x)) {
      fp_store<M>(out, n, pos, fp_zero<M>());
      continue;
    }
    fp_store<M>(out, n, pos, mul(carry, fp_load<M>(out, n, pos)));
    carry = mul(carry, x);
  }
}
