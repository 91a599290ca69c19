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
// 2^32; for the inversion (inv_safegcd below) p in nine signed 30-bit
// limbs, p^-1 mod 2^30 and the words of R^3 mod p.  A curve's Fq modulus
// carries the curve's traits as well: kNr, the Fp2 non-residue (u^2 =
// kNr, fp2.cuh); kB3, 3 b on G1; b3_c0 / b3_c1, the words of 3 b on the G2
// twist (rcb.cuh).
#define OZ_MODULUS(TAG)                                     \
  static constexpr uint32_t N0INV = TAG##_N0INV;            \
  static constexpr uint32_t PINV30 = TAG##_PINV30;          \
  __device__ __forceinline__ static uint32_t p(int i) {     \
    constexpr uint32_t v[8] = TAG##_P_WORDS;                \
    return v[i];                                            \
  }                                                         \
  __device__ __forceinline__ static uint32_t one(int i) {   \
    constexpr uint32_t v[8] = TAG##_ONE_WORDS;              \
    return v[i];                                            \
  }                                                         \
  __device__ __forceinline__ static int32_t p30(int i) {    \
    constexpr int32_t v[9] = TAG##_P30_LIMBS;               \
    return v[i];                                            \
  }                                                         \
  __device__ __forceinline__ static uint32_t r3(int i) {    \
    constexpr uint32_t v[8] = TAG##_R3_WORDS;               \
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

// Inversion: Bernstein-Yang "safegcd" (TCHES 2019, eprint 2019/266), in
// the form of libsecp256k1's modinv32 (constant-time divsteps with
// zeta = -(delta + 1/2), signed 30-bit limbs).
//
// Why it replaces a^(p-2) (pow_exp) here: Fermat is 253 squares and 109
// products for BN254's q - 2, each waiting on the one before; a product is
// about 280 integer instructions and 0.47 us of one thread's latency on
// this card, so one inversion takes 0.17 ms with the rest of the card
// idle, and every lane of batch_inv_rows ran one.  safegcd instead runs
// divsteps on the low 32 bits of f and g (one step: 23 instructions in the
// compiled code, 7 of them in turn on g's path), 30 at a time, each batch
// giving a 2x2 matrix with int32 entries that is then applied to f, g
// (plain integers) and to d, e (mod p: a multiple of p makes the low 30
// bits zero, so the division by 2^30 is exact) with 32 x 32 -> 64-bit
// multiply-adds, the card's native IMAD.WIDE.  20 batches of 30 (600
// divsteps) are enough for any modulus below 2^256 (libsecp256k1's
// safegcd_implementation.md: 590 for its hddivsteps at 256 bits), so no
// field needs a path of its own.  About 14,000 ALU instructions and 1,800
// 64-bit multiply-adds an inversion, some 60 products' worth against
// Fermat's 362, and a critical path of 600 divsteps of 7 dependent
// instructions against 362 products of about 100.  The divsteps select
// without branches, so all 32 lanes of a warp run the same instructions;
// a warp leaves the loop once g is zero on every lane (V::all), which
// changes no word: with g = 0 a batch leaves f = +-1 and the value of d
// mod p as they are.
//
// Input and output are Montgomery words: the algorithm inverts the
// integer x = a R, giving a^-1 R^-1, and one product by R^3 mod p makes
// it a^-1 R.  Zero gives zero, as Fermat does.
namespace sgcd {

constexpr int32_t M30 = 0x3FFFFFFF;

// value = sum v[i] 2^(30 i); v[0..7] in [0, 2^30) after an update
struct S30 {
  int32_t v[9];
};

// the 2x2 matrix of 30 divsteps, (u v; q r), times 2^30
struct Trans {
  int32_t u, v, q, r;
};

// 30 divsteps on the low words of f and g; returns the new zeta.  The
// steps of libsecp256k1's secp256k1_modinv32_divsteps_30 (u, v, q, r as
// unsigned words; they stay in [-2^30, 2^30]), each choice a select
// between values computed before the choice is known: where g is odd and
// zeta < 0 (swap) (f, g) = (g, g - f), where g is odd otherwise g = g + f,
// then g / 2; (u, v) and (q, r) alike, then u, v times 2.  A select is one
// instruction on a predicate; this form runs 7 % faster on the card than
// libsecp256k1's masks (scripts/inv_designs.py).
__device__ __forceinline__ int32_t divsteps_30(int32_t zeta, uint32_t f,
                                               uint32_t g, Trans& t) {
  uint32_t u = 1u, v = 0u, q = 0u, r = 1u;
#pragma unroll
  for (int i = 0; i < 30; i++) {
    const bool odd = g & 1u;
    const bool swap = odd && zeta < 0;
    const uint32_t g_odd = swap ? g - f : g + f;
    const uint32_t q_odd = swap ? q - u : q + u;
    const uint32_t r_odd = swap ? r - v : r + v;
    f = swap ? g : f;
    u = swap ? q : u;
    v = swap ? r : v;
    g = odd ? g_odd : g;
    q = odd ? q_odd : q;
    r = odd ? r_odd : r;
    zeta = swap ? -zeta - 2 : zeta - 1;
    g >>= 1;
    u <<= 1;
    v <<= 1;
  }
  t = {(int32_t)u, (int32_t)v, (int32_t)q, (int32_t)r};
  return zeta;
}

// (d, e) = (t [d, e] + p [md, me]) / 2^30, md and me chosen so that the
// low 30 bits vanish; d and e stay in (-2p, p)
template <class M>
__device__ __forceinline__ void update_de(S30& d, S30& e, const Trans& t) {
  const int32_t sd = d.v[8] >> 31, se = e.v[8] >> 31;
  int32_t md = (t.u & sd) + (t.v & se);
  int32_t me = (t.q & sd) + (t.r & se);
  int64_t cd = (int64_t)t.u * d.v[0] + (int64_t)t.v * e.v[0];
  int64_t ce = (int64_t)t.q * d.v[0] + (int64_t)t.r * e.v[0];
  md -= (int32_t)((M::PINV30 * (uint32_t)cd + (uint32_t)md) & (uint32_t)M30);
  me -= (int32_t)((M::PINV30 * (uint32_t)ce + (uint32_t)me) & (uint32_t)M30);
  cd += (int64_t)M::p30(0) * md;
  ce += (int64_t)M::p30(0) * me;
  cd >>= 30;
  ce >>= 30;
#pragma unroll
  for (int i = 1; i < 9; i++) {
    cd += (int64_t)t.u * d.v[i] + (int64_t)t.v * e.v[i];
    ce += (int64_t)t.q * d.v[i] + (int64_t)t.r * e.v[i];
    cd += (int64_t)M::p30(i) * md;
    ce += (int64_t)M::p30(i) * me;
    d.v[i - 1] = (int32_t)cd & M30;
    cd >>= 30;
    e.v[i - 1] = (int32_t)ce & M30;
    ce >>= 30;
  }
  d.v[8] = (int32_t)cd;
  e.v[8] = (int32_t)ce;
}

// (f, g) = t [f, g] / 2^30, exact
__device__ __forceinline__ void update_fg(S30& f, S30& g, const Trans& t) {
  int64_t cf = (int64_t)t.u * f.v[0] + (int64_t)t.v * g.v[0];
  int64_t cg = (int64_t)t.q * f.v[0] + (int64_t)t.r * g.v[0];
  cf >>= 30;
  cg >>= 30;
#pragma unroll
  for (int i = 1; i < 9; i++) {
    cf += (int64_t)t.u * f.v[i] + (int64_t)t.v * g.v[i];
    cg += (int64_t)t.q * f.v[i] + (int64_t)t.r * g.v[i];
    f.v[i - 1] = (int32_t)cf & M30;
    cf >>= 30;
    g.v[i - 1] = (int32_t)cg & M30;
    cg >>= 30;
  }
  f.v[8] = (int32_t)cf;
  g.v[8] = (int32_t)cg;
}

// r = r + p where negative; negated where ``sign`` is; the top bits
// carried up; p added again where still negative: [0, p) from (-2p, p)
template <class M>
__device__ __forceinline__ void add_p_if_negative(S30& r) {
  const int32_t c = r.v[8] >> 31;
#pragma unroll
  for (int i = 0; i < 9; i++) r.v[i] += M::p30(i) & c;
}
__device__ __forceinline__ void carry_up(S30& r) {
#pragma unroll
  for (int i = 0; i < 8; i++) {
    r.v[i + 1] += r.v[i] >> 30;
    r.v[i] &= M30;
  }
}
template <class M>
__device__ __forceinline__ void normalize(S30& r, int32_t sign) {
  add_p_if_negative<M>(r);
  const int32_t neg = sign >> 31;
#pragma unroll
  for (int i = 0; i < 9; i++) r.v[i] = (r.v[i] ^ neg) - neg;
  carry_up(r);
  add_p_if_negative<M>(r);
  carry_up(r);
}

// eight words (a value below 2^256) as limbs, and back (a value in [0, p))
template <class M>
__device__ __forceinline__ S30 from_words(const Fp<M>& a) {
  S30 r;
#pragma unroll
  for (int j = 0; j < 9; j++) {
    const int k = 30 * j / 32, s = 30 * j % 32;
    const uint64_t w = a.v[k] | (k < 7 ? (uint64_t)a.v[k + 1] << 32 : 0);
    r.v[j] = (int32_t)(w >> s) & M30;
  }
  return r;
}
template <class M>
__device__ __forceinline__ Fp<M> to_words(const S30& d) {
  Fp<M> r;
#pragma unroll
  for (int k = 0; k < 8; k++) {
    const int j = 32 * k / 30, s = 32 * k % 30;
    const uint64_t w = (uint64_t)(uint32_t)d.v[j] |
                       (uint64_t)(uint32_t)d.v[j + 1] << 30;
    r.v[k] = (uint32_t)(w >> s);
  }
  return r;
}

__device__ __forceinline__ bool is_zero(const S30& g) {
  int32_t acc = 0;
#pragma unroll
  for (int i = 0; i < 9; i++) acc |= g.v[i];
  return acc == 0;
}

}  // namespace sgcd

// The vote that ends the divstep loop: the caller's own g alone (a thread
// by itself: the host harness, one element in turn).  On the card the
// kernels pass WarpVote, whose every lane must reach each call.
struct OneThread {
  static __device__ __forceinline__ bool all(bool p) { return p; }
};
#if defined(__CUDACC__)
struct WarpVote {
  static __device__ __forceinline__ bool all(bool p) {
    return __all_sync(0xffffffffu, p);
  }
};

// The threads of a block sharing a phase's items (first(), step()) and
// its barrier (ntt.cuh's transform; the batch inversion's third level
// takes the barrier alone).
struct BlockSched {
  __device__ unsigned first() const { return threadIdx.x; }
  __device__ unsigned step() const { return blockDim.x; }
  __device__ void barrier() { __syncthreads(); }
};
#endif

// a^-1 in Montgomery form (zero for zero), for any modulus the headers
// take: at most 20 batches of 30 divsteps, each batch's matrix applied to
// (f, g) and to (d, e); then d = +-x^-1 made canonical and times R^3.
template <class M, class V>
__device__ __forceinline__ Fp<M> inv_safegcd(const Fp<M>& a) {
  sgcd::S30 d = {}, e = {}, f, g = sgcd::from_words(a);
  e.v[0] = 1;
#pragma unroll
  for (int i = 0; i < 9; i++) f.v[i] = M::p30(i);
  int32_t zeta = -1;
#pragma unroll 1
  for (int b = 0; b < 20; b++) {
    if (V::all(sgcd::is_zero(g))) break;
    sgcd::Trans t;
    zeta = sgcd::divsteps_30(zeta, (uint32_t)f.v[0], (uint32_t)g.v[0], t);
    sgcd::update_de<M>(d, e, t);
    sgcd::update_fg(f, g, t);
  }
  sgcd::normalize<M>(d, f.v[8]);   // f = +-1: its sign is d's
  Fp<M> r3;
#pragma unroll
  for (int k = 0; k < 8; k++) r3.v[k] = M::r3(k);
  return mul(sgcd::to_words<M>(d), r3);
}

// The batch inversion of a word-major [8, n] batch (fields/fp.py
// batch_inv_rows), a Montgomery trick on three levels.  Lane l < lanes owns
// the positions l, l + lanes, l + 2 lanes, ... below n
// (batch_inv_rows_count of them; a lane past ``lanes`` owns none, so a
// warp's loads of one row are contiguous).  Its forward sweep writes each
// position's exclusive prefix product into ``out`` (a zero counts as one)
// and returns the lane total; the block's T lane totals are multiplied in
// shared memory (inclusive prefix and suffix products, Hillis-Steele);
// one thread inverts the block's product (inv_safegcd); a lane's inverse
// total is the product of its exclusive prefix, its exclusive suffix and
// that inverse; its backward sweep overwrites each prefix with prefix *
// (inverse of the running product up to and including it), the
// position's inverse.  A zero maps to zero.  Each sweep loads the next
// row's words before this row's product, so a load's latency hides behind
// a product's.  The inverse of an element is unique and canonical, so how
// positions are grouped into lanes and blocks does not change a word of
// the result.
__device__ __forceinline__ size_t batch_inv_rows_count(size_t n, size_t lanes,
                                                       size_t l) {
  return l < lanes ? (n - 1 - l) / lanes + 1 : 0;
}

template <class M>
__device__ __forceinline__ Fp<M> batch_inv_forward(const uint32_t* a,
                                                   uint32_t* out, size_t n,
                                                   size_t lanes, size_t l,
                                                   size_t rows) {
  Fp<M> carry = fp_one<M>();
  Fp<M> x = rows ? fp_load<M>(a, n, l) : carry;
#pragma unroll 1
  for (size_t r = 0; r < rows; r++) {
    const size_t pos = l + r * lanes;
    const Fp<M> next = r + 1 < rows ? fp_load<M>(a, n, pos + lanes) : x;
    fp_store<M>(out, n, pos, carry);
    if (!is_zero(x)) carry = mul(carry, x);
    x = next;
  }
  return carry;
}

// ``inv``: the inverse of the lane's total
template <class M>
__device__ __forceinline__ void batch_inv_backward(const uint32_t* a,
                                                   uint32_t* out, size_t n,
                                                   size_t lanes, size_t l,
                                                   size_t rows, Fp<M> inv) {
  if (rows == 0) return;
  size_t pos = l + (rows - 1) * lanes;
  Fp<M> x = fp_load<M>(a, n, pos), pre = fp_load<M>(out, n, pos);
#pragma unroll 1
  for (size_t r = rows; r-- > 0; pos -= lanes) {
    const Fp<M> xn = r ? fp_load<M>(a, n, pos - lanes) : x;
    const Fp<M> pn = r ? fp_load<M>(out, n, pos - lanes) : pre;
    if (is_zero(x)) {
      fp_store<M>(out, n, pos, fp_zero<M>());
    } else {
      fp_store<M>(out, n, pos, mul(inv, pre));
      inv = mul(inv, x);
    }
    x = xn;
    pre = pn;
  }
}

// shared words of a block of T lanes: its prefix and suffix products,
// word-major [8][T] each, and the inverse
__host__ __device__ constexpr size_t batch_inv_smem_words(int T) {
  return 2 * 8 * (size_t)T + 8;
}

// Lane block * T + t, run by thread t of a block of T threads, every one
// of which calls this; ``sync.barrier()`` is the block's barrier (a host
// harness runs the T threads as host threads).  ``smem``:
// batch_inv_smem_words(T) words.  Each thread keeps its lane's prefix and
// suffix products in registers between the levels; the block's first
// thread alone inverts (no vote).
template <class M, int T, class Sync>
__device__ __forceinline__ void batch_inv_block(const uint32_t* a,
                                                uint32_t* out, size_t n,
                                                size_t lanes, size_t block,
                                                unsigned t, uint32_t* smem,
                                                Sync& sync) {
  uint32_t* pre = smem;
  uint32_t* suf = smem + 8 * T;
  uint32_t* total_inv = smem + 16 * T;
  const size_t l = block * T + t;
  const size_t rows = batch_inv_rows_count(n, lanes, l);
  const Fp<M> one = fp_one<M>();
  Fp<M> p = batch_inv_forward<M>(a, out, n, lanes, l, rows), s = p;
  fp_store<M>(pre, T, t, p);
  fp_store<M>(suf, T, t, s);
  sync.barrier();
#pragma unroll 1
  for (unsigned d = 1; d < (unsigned)T; d <<= 1) {
    const Fp<M> pl = t >= d ? fp_load<M>(pre, T, t - d) : one;
    const Fp<M> sr = t + d < (unsigned)T ? fp_load<M>(suf, T, t + d) : one;
    sync.barrier();
    if (t >= d) p = mul(pl, p);
    if (t + d < (unsigned)T) s = mul(s, sr);
    fp_store<M>(pre, T, t, p);
    fp_store<M>(suf, T, t, s);
    sync.barrier();
  }
  if (t == 0)
    fp_store<M>(total_inv, 1, 0,
                inv_safegcd<M, OneThread>(fp_load<M>(pre, T, T - 1)));
  sync.barrier();
  Fp<M> inv = fp_load<M>(total_inv, 1, 0);
  if (t > 0) inv = mul(inv, fp_load<M>(pre, T, t - 1));
  if (t + 1 < (unsigned)T) inv = mul(inv, fp_load<M>(suf, T, t + 1));
  batch_inv_backward<M>(a, out, n, lanes, l, rows, inv);
}
