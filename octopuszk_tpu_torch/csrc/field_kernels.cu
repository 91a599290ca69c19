// Elementwise field kernels: (a) butterfly, (b) mont_mul, (c) mul_sub.
//
// They replace the TPU kernels octopuszk_tpu/ops/pallas_ops.py::butterfly
// (_butterfly_kernel), ::mont_mul (_mont_mul_kernel) and ::mul_sub
// (_mul_sub_kernel), all instances of pointwise_kernel.
//
// Bound on this card: device memory.  A butterfly moves 5 coordinates of
// 32 bytes per element, a product 3, a multiply-subtract 4, against about
// 150 32-bit multiply-adds each.  Design: one thread per element, operands
// word-major so that a warp reads 128 contiguous bytes per word, everything
// between the loads and the stores in registers, one pass over memory.
//
// Three more kernels run (b)'s chains, which the main path ran as one
// mont_mul launch per step:
// * mont_pow: a^e for a host exponent (fields/fp.py pow_const: t^n in
//   ops/ntt.py lagrange_coeffs), one thread per element running the
//   square-and-multiply chain in registers.  Bound: one thread's dependent
//   latency where the batch is small, multiply throughput where it is
//   large.
// * inv: the inverse (fields/fp.py inv, so fp2.inv and the affine
//   conversion of every proof point), one thread per element running the
//   safegcd inversion of field.cuh (inv_safegcd), which replaced the
//   Fermat chain a^(p-2) (362 dependent products for q - 2, 0.17 ms for
//   one element).  Every lane of a warp runs the divstep loop; a lane past
//   the batch inverts zero, so the warp's vote sees all 32.  Bound: one
//   thread's 600 divsteps where the batch is small (one to fifteen
//   elements on the main path).
// * batch_inv_rows: the Montgomery batch inversion of fields/fp.py
//   batch_inv_rows (before: 3 launches per row of 4,096 lanes plus a
//   Fermat chain, about 1,900 launches per setup), one thread per lane:
//   forward sweep of exclusive prefix products written into the output,
//   the block's lane totals multiplied in shared memory, one safegcd
//   inversion a block, backward sweep (field.cuh batch_inv_block).  Lane l
//   owns positions l, l + lanes, ..., so a warp's loads of one row are
//   contiguous.  A lane shortens every thread's 3 rows-product chain and
//   adds 2 log2(128) products to the block's scan; an inversion a lane
//   instead (ops/kernels.py INV_LANES, PERF.md, scripts/inv_designs.py)
//   cost more.  The same positions hold the prefix and then the inverse,
//   so it needs no scratch in device memory.
#include <cuda_runtime.h>
#include "curve.cuh"

namespace {

constexpr int kThreads = 256;
// the chains are latency-bound: small blocks spread few threads over
// many SMs
constexpr int kChainThreads = 64;
// the batch inversion's lanes a block, one inversion a block
// (scripts/inv_designs.py: 128 against 256, and one inversion a lane)
constexpr int kInvThreads = 128;

template <class M, bool DIF>
__global__ void __launch_bounds__(kThreads)
butterfly_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                 const uint32_t* __restrict__ w, uint32_t* __restrict__ o0,
                 uint32_t* __restrict__ o1, size_t n) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Fp<M> x = fp_load<M>(a, n, i);
  const Fp<M> y = fp_load<M>(b, n, i);
  const Fp<M> tw = fp_load<M>(w, n, i);
  if (DIF) {  // (a + b, (a - b) * w)
    fp_store<M>(o0, n, i, add(x, y));
    fp_store<M>(o1, n, i, mul(sub(x, y), tw));
  } else {    // (a + w * b, a - w * b)
    const Fp<M> t = mul(y, tw);
    fp_store<M>(o0, n, i, add(x, t));
    fp_store<M>(o1, n, i, sub(x, t));
  }
}

template <class M>
__global__ void __launch_bounds__(kThreads)
mont_mul_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                uint32_t* __restrict__ out, size_t n) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  fp_store<M>(out, n, i, mul(fp_load<M>(a, n, i), fp_load<M>(b, n, i)));
}

template <class M>
__global__ void __launch_bounds__(kThreads)
mul_sub_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
               const uint32_t* __restrict__ c, uint32_t* __restrict__ out,
               size_t n) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Fp<M> prod = mul(fp_load<M>(a, n, i), fp_load<M>(b, n, i));
  fp_store<M>(out, n, i, sub(prod, fp_load<M>(c, n, i)));
}

template <class M>
__global__ void __launch_bounds__(kChainThreads)
mont_pow_kernel(const uint32_t* __restrict__ a, uint32_t* __restrict__ out,
                size_t n, Exponent e) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  fp_store<M>(out, n, i, pow_exp(fp_load<M>(a, n, i), e));
}

template <class M>
__global__ void __launch_bounds__(kChainThreads)
inv_kernel(const uint32_t* __restrict__ a, uint32_t* __restrict__ out,
           size_t n) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const Fp<M> x = i < n ? fp_load<M>(a, n, i) : fp_zero<M>();
  const Fp<M> y = inv_safegcd<M, WarpVote>(x);
  if (i < n) fp_store<M>(out, n, i, y);
}

template <class M>
__global__ void __launch_bounds__(kInvThreads)
batch_inv_rows_kernel(const uint32_t* __restrict__ a, uint32_t* out, size_t n,
                      size_t lanes) {
  __shared__ uint32_t smem[batch_inv_smem_words(kInvThreads)];
  BlockSched sync;
  batch_inv_block<M, kInvThreads>(a, out, n, lanes, blockIdx.x, threadIdx.x,
                                  smem, sync);
}

inline unsigned blocks_for(size_t n, int threads = kThreads) {
  return (unsigned)((n + threads - 1) / threads);
}

}  // namespace

// field: 0 = the unit's curve's Fr, 1 = its Fq (curve.cuh).  Each
// function returns cudaGetLastError().

extern "C" int oz_butterfly(int field, int dif, const void* a, const void* b,
                            const void* w, void* o0, void* o1, long long n,
                            void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const uint32_t* pa = (const uint32_t*)a;
  const uint32_t* pb = (const uint32_t*)b;
  const uint32_t* pw = (const uint32_t*)w;
  uint32_t* p0 = (uint32_t*)o0;
  uint32_t* p1 = (uint32_t*)o1;
  const unsigned g = blocks_for((size_t)n);
  if (field == 0) {
    if (dif) butterfly_kernel<CurveFr, true><<<g, kThreads, 0, s>>>(pa, pb, pw, p0, p1, (size_t)n);
    else butterfly_kernel<CurveFr, false><<<g, kThreads, 0, s>>>(pa, pb, pw, p0, p1, (size_t)n);
  } else {
    if (dif) butterfly_kernel<CurveFq, true><<<g, kThreads, 0, s>>>(pa, pb, pw, p0, p1, (size_t)n);
    else butterfly_kernel<CurveFq, false><<<g, kThreads, 0, s>>>(pa, pb, pw, p0, p1, (size_t)n);
  }
  return (int)cudaGetLastError();
}

extern "C" int oz_mont_mul(int field, const void* a, const void* b, void* out,
                           long long n, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned g = blocks_for((size_t)n);
  if (field == 0)
    mont_mul_kernel<CurveFr><<<g, kThreads, 0, s>>>((const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, (size_t)n);
  else
    mont_mul_kernel<CurveFq><<<g, kThreads, 0, s>>>((const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, (size_t)n);
  return (int)cudaGetLastError();
}

extern "C" int oz_mul_sub(int field, const void* a, const void* b,
                          const void* c, void* out, long long n,
                          void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned g = blocks_for((size_t)n);
  if (field == 0)
    mul_sub_kernel<CurveFr><<<g, kThreads, 0, s>>>((const uint32_t*)a, (const uint32_t*)b, (const uint32_t*)c, (uint32_t*)out, (size_t)n);
  else
    mul_sub_kernel<CurveFq><<<g, kThreads, 0, s>>>((const uint32_t*)a, (const uint32_t*)b, (const uint32_t*)c, (uint32_t*)out, (size_t)n);
  return (int)cudaGetLastError();
}

// e: the exponent's eight little-endian words; top: its top set bit (-1 for
// e = 0)
extern "C" int oz_mont_pow(int field, const void* a, void* out, long long n,
                           const unsigned* e, int top, void* stream) {
  if (n <= 0 || top < -1 || top > 255) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  Exponent ex;
  for (int k = 0; k < 8; k++) ex.w[k] = e[k];
  ex.top = top;
  const unsigned g = blocks_for((size_t)n, kChainThreads);
  if (field == 0)
    mont_pow_kernel<CurveFr><<<g, kChainThreads, 0, s>>>((const uint32_t*)a, (uint32_t*)out, (size_t)n, ex);
  else
    mont_pow_kernel<CurveFq><<<g, kChainThreads, 0, s>>>((const uint32_t*)a, (uint32_t*)out, (size_t)n, ex);
  return (int)cudaGetLastError();
}

extern "C" int oz_inv(int field, const void* a, void* out, long long n,
                      void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned g = blocks_for((size_t)n, kChainThreads);
  if (field == 0)
    inv_kernel<CurveFr><<<g, kChainThreads, 0, s>>>((const uint32_t*)a, (uint32_t*)out, (size_t)n);
  else
    inv_kernel<CurveFq><<<g, kChainThreads, 0, s>>>((const uint32_t*)a, (uint32_t*)out, (size_t)n);
  return (int)cudaGetLastError();
}

// 1 <= lanes <= n
extern "C" int oz_batch_inv_rows(int field, const void* a, void* out,
                                 long long n, long long lanes, void* stream) {
  if (n <= 0 || lanes <= 0 || lanes > n) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned g = blocks_for((size_t)lanes, kInvThreads);
  if (field == 0)
    batch_inv_rows_kernel<CurveFr><<<g, kInvThreads, 0, s>>>((const uint32_t*)a, (uint32_t*)out, (size_t)n, (size_t)lanes);
  else
    batch_inv_rows_kernel<CurveFq><<<g, kInvThreads, 0, s>>>((const uint32_t*)a, (uint32_t*)out, (size_t)n, (size_t)lanes);
  return (int)cudaGetLastError();
}
