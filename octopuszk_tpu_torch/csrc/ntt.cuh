// One radix-2 NTT of length L = 2^log_l, every stage, on a copy of the
// transform held in shared memory (ntt_kernels.cu: one block per
// transform).  Device code and, with the macros of the host tests, host
// code: the schedule hands each thread its items and separates the phases
// (a barrier of the block on the card; one thread doing every item in
// order on the host, where a stage's butterflies touch disjoint pairs).
//
// It computes what ops/kernels.py ntt_block_plain computes: the input
// times ``pre`` (where given), the butterfly stages of ops/ntt.py (DIF:
// m = L/2 .. 1, (a + b, (a - b) w); DIT: m = 1 .. L/2, (a + w b, a - w b);
// the twiddle of position j of half-block m is tw[j L / 2m], tw[k] =
// omega^k), the bit reversal (on the stores for DIF, on the loads for DIT,
// so both take and give natural order), then times ``post``.  Every value
// is canonical, so the words equal the plain version's.
#pragma once
#include "field.cuh"

// Element (l, b) of an operand, b = bh * inner + bl: word k at
// p[k * sw + l * sl + bh * sbh + bl * sbl] (element strides; 0 where a
// table is broadcast).  p == nullptr: no operand.
struct NttView {
  const uint32_t* p;
  long long sw, sl, sbh, sbl;
};

struct NttArgs {
  NttView x, pre, post;
  const uint32_t* tw;   // [8, L/2] word-major: omega^k, k < L/2
  uint32_t* out;        // [8, L, batch] contiguous
  int log_l;
  long long batch, inner;
};

// row stride of the shared copy: word k of position i at
// s[k * ntt_smem_stride(L) + ntt_pad(i)]; one padding word per 32 keeps the
// bit-reversed and the strided accesses of a warp off a single bank
__host__ __device__ __forceinline__ unsigned ntt_pad(unsigned i) {
  return i + (i >> 5);
}
__host__ __device__ __forceinline__ unsigned ntt_smem_stride(unsigned L) {
  return ntt_pad(L);
}

__host__ __device__ __forceinline__ unsigned ntt_bitrev(unsigned i,
                                                        int bits) {
#if defined(__CUDA_ARCH__)
  return __brev(i) >> (32 - bits);
#else
  unsigned r = 0;
  for (int b = 0; b < bits; b++) r |= ((i >> b) & 1u) << (bits - 1 - b);
  return r;
#endif
}

template <class M>
__device__ __forceinline__ Fp<M> ntt_view_load(const NttView& v,
                                               long long base, unsigned l) {
  Fp<M> r;
  const uint32_t* p = v.p + base + (long long)l * v.sl;
#pragma unroll
  for (int k = 0; k < 8; k++) r.v[k] = p[(long long)k * v.sw];
  return r;
}

// offset of batch entry b in a view
__device__ __forceinline__ long long ntt_view_base(const NttView& v,
                                                   long long b,
                                                   long long inner) {
  return (b / inner) * v.sbh + (b % inner) * v.sbl;
}

template <class M>
__device__ __forceinline__ Fp<M> ntt_smem_load(const uint32_t* s,
                                               unsigned stride, unsigned i) {
  Fp<M> r;
  const unsigned at = ntt_pad(i);
#pragma unroll
  for (int k = 0; k < 8; k++) r.v[k] = s[k * stride + at];
  return r;
}

template <class M>
__device__ __forceinline__ void ntt_smem_store(uint32_t* s, unsigned stride,
                                               unsigned i, const Fp<M>& a) {
  const unsigned at = ntt_pad(i);
#pragma unroll
  for (int k = 0; k < 8; k++) s[k * stride + at] = a.v[k];
}

// Transform ``b`` of the batch.  ``s``: the shared copy (8 *
// ntt_smem_stride(L) words).  Sched: first(), step() of this thread's
// items, barrier().
template <class M, bool DIF, class Sched>
__device__ __forceinline__ void ntt_block_run(const NttArgs& a, uint32_t* s,
                                              long long b, Sched& sched) {
  const int log_l = a.log_l;
  const unsigned L = 1u << log_l;
  const unsigned half = L >> 1;
  const unsigned stride = ntt_smem_stride(L);
  const long long xb = ntt_view_base(a.x, b, a.inner);
  const long long preb = a.pre.p ? ntt_view_base(a.pre, b, a.inner) : 0;
  const long long postb = a.post.p ? ntt_view_base(a.post, b, a.inner) : 0;

#pragma unroll 1
  for (unsigned i = sched.first(); i < L; i += sched.step()) {
    Fp<M> v = ntt_view_load<M>(a.x, xb, i);
    if (a.pre.p) v = mul(v, ntt_view_load<M>(a.pre, preb, i));
    ntt_smem_store<M>(s, stride, DIF ? i : ntt_bitrev(i, log_l), v);
  }
  sched.barrier();

#pragma unroll 1
  for (int st = 0; st < log_l; st++) {
    const int log_m = DIF ? log_l - 1 - st : st;
    const unsigned m = 1u << log_m;
    const int log_tstep = log_l - 1 - log_m;     // tw index stride L / 2m
#pragma unroll 1
    for (unsigned k = sched.first(); k < half; k += sched.step()) {
      const unsigned j = k & (m - 1);
      const unsigned i0 = ((k >> log_m) << (log_m + 1)) | j;
      const unsigned i1 = i0 + m;
      const Fp<M> x0 = ntt_smem_load<M>(s, stride, i0);
      const Fp<M> x1 = ntt_smem_load<M>(s, stride, i1);
      const Fp<M> w = fp_load<M>(a.tw, half, (size_t)j << log_tstep);
      if (DIF) {
        ntt_smem_store<M>(s, stride, i0, add(x0, x1));
        ntt_smem_store<M>(s, stride, i1, mul(sub(x0, x1), w));
      } else {
        const Fp<M> t = mul(x1, w);
        ntt_smem_store<M>(s, stride, i0, add(x0, t));
        ntt_smem_store<M>(s, stride, i1, sub(x0, t));
      }
    }
    sched.barrier();
  }

  const size_t out_stride = (size_t)L * a.batch;
#pragma unroll 1
  for (unsigned i = sched.first(); i < L; i += sched.step()) {
    Fp<M> v = ntt_smem_load<M>(s, stride, DIF ? ntt_bitrev(i, log_l) : i);
    if (a.post.p) v = mul(v, ntt_view_load<M>(a.post, postb, i));
    fp_store<M>(a.out, out_stride, (size_t)i * a.batch + b, v);
  }
}
