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
// Two more kernels run (b)'s chains, which the main path ran as one
// mont_mul launch per step:
// * mont_pow: a^e for a host exponent (fields/fp.py pow_const, so fp.inv
//   and the Fermat inversions of fp2.inv and the affine conversions), one
//   thread per element running the square-and-multiply chain in
//   registers: 362 dependent products for q - 2, which cost 362 launches
//   and as many wrapper calls before.  Bound: one thread's dependent
//   latency where the batch is small (one to fifteen elements on the main
//   path), multiply throughput where it is large.
// * batch_inv_rows: the two-level Montgomery batch inversion of
//   fields/fp.py batch_inv_rows (before: 3 launches per row of 4,096
//   lanes plus a Fermat chain, about 1,900 launches per setup), one
//   thread per lane: forward sweep of exclusive prefix products written
//   into the output, Fermat inversion of the lane total, backward sweep.
//   Lane l owns positions l, l + lanes, ..., so a warp's loads of one row
//   are contiguous.  Each lane adds one Fermat chain (362 products) and
//   shortens every thread's 3 rows-product chain: the lane count trades
//   the two (PERF.md).  The same positions hold the prefix and then the
//   inverse, so it needs no scratch.
#include <cuda_runtime.h>
#include "curve.cuh"

namespace {

constexpr int kThreads = 256;
// the chains are latency-bound: small blocks spread few threads over
// many SMs
constexpr int kChainThreads = 64;

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
batch_inv_rows_kernel(const uint32_t* __restrict__ a, uint32_t* out, size_t n,
                      size_t lanes, Exponent pm2) {
  const size_t l = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= lanes) return;
  batch_inv_lane<M>(a, out, n, lanes, l, pm2);
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

// pm2: the words of p - 2 and its top set bit; 1 <= lanes <= n
extern "C" int oz_batch_inv_rows(int field, const void* a, void* out,
                                 long long n, long long lanes,
                                 const unsigned* pm2, int top, void* stream) {
  if (n <= 0 || lanes <= 0 || lanes > n || top < 0 || top > 255)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  Exponent ex;
  for (int k = 0; k < 8; k++) ex.w[k] = pm2[k];
  ex.top = top;
  const unsigned g = blocks_for((size_t)lanes, kChainThreads);
  if (field == 0)
    batch_inv_rows_kernel<CurveFr><<<g, kChainThreads, 0, s>>>((const uint32_t*)a, (uint32_t*)out, (size_t)n, (size_t)lanes, ex);
  else
    batch_inv_rows_kernel<CurveFq><<<g, kChainThreads, 0, s>>>((const uint32_t*)a, (uint32_t*)out, (size_t)n, (size_t)lanes, ex);
  return (int)cudaGetLastError();
}
