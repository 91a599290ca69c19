// Bucket-accumulation scan over projective points: (h) scan_accumulate,
// G1 and G2.
//
// It replaces the TPU kernel octopuszk_tpu/ops/pallas_ops.py::
// scan_accumulate (_scan_kernel), the inner loop of the sort-based
// Pippenger over unpacked point batches (ops/msm.py::pippenger_msm).  There
// the row axis is a sequential grid dimension, the input is the gathered
// copy of the points in sorted order, and the running sum lives in scratch
// memory between grid steps.  Blocks run in no order here, so one thread
// owns one lane, keeps the projective running sum to itself and loops over
// the rows, adding each row with the complete full add (rcb.cuh::pt_add).
// The running sum starts at the identity (0, 1, 0); every inclusive prefix
// is written.
//
// The gather is folded in: the kernel reads the unpacked point batch
// (word-major int32[8, n] components, 3 for G1 and 6 for G2) through the
// sorted-order index, so the gathered copy never exists in device memory.
// Reading 8 words strided by n per component through a random index does
// not coalesce; it is accepted here (the step's arithmetic dominates: 12
// field products, about 3,000 multiply-adds on G1, per 96 bytes read).  A
// leading batch dimension carries all windows of one MSM in one launch,
// since 4,096 lanes alone would fill a few percent of the card.
//
// Bound on this card: integer multiply throughput (12 field products and
// 2 mul_b3 per row; on G2 each is an Fp2 product).
#include <cuda_runtime.h>
#include "rcb.cuh"

namespace {

constexpr int kThreads = 128;

// One row's full add, kept out of line: with the formula inlined into the
// row loop, nvcc 12.9 (cicc at -O3) crashed with a segmentation fault on
// this file, as it did on scan_kernels.cu's mixed add while field.cuh's
// product was written with 64-bit multiply-adds; scan_kernels.cu inlines
// its step since the product runs on carry chains, this file has not been
// tried again.  The running sum and the row pass through local memory once
// per row: under 100 words beside the roughly 3,000 multiply-adds of a G1
// add.
template <class C>
__device__ __noinline__ void full_step(Pt<C>& carry, const Pt<C>& q) {
  carry = pt_add(carry, q);
}

// idx[b, r, l] is read at b * sb + r * sr + l * sl (element strides); its
// entries are point indices into the base of n points.  Output component:
// int32[8, batch, rows, lanes].
template <class C>
__global__ void __launch_bounds__(kThreads)
scan_full_kernel(PointPtrs base, size_t n, const int32_t* __restrict__ idx,
                 long long sb, long long sr, long long sl, int batch,
                 int rows, int lanes, PointPtrs out) {
  const size_t t = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (size_t)batch * lanes) return;
  const size_t b = t / lanes;
  const size_t l = t % lanes;
  Pt<C> carry;
  coord_zero(carry.x);
  coord_one(carry.y);
  coord_zero(carry.z);
  const int32_t* ix = idx + (long long)b * sb + (long long)l * sl;
  const size_t stride = (size_t)batch * rows * lanes;
  for (int r = 0; r < rows; r++) {
    const size_t e = (size_t)(uint32_t)ix[(long long)r * sr];
    Pt<C> q;
    load_coord(q.x, base, 0, n, e);
    load_coord(q.y, base, 1, n, e);
    load_coord(q.z, base, 2, n, e);
    full_step(carry, q);
    const size_t off = (b * rows + r) * lanes + l;
    store_coord(carry.x, out, 0, stride, off);
    store_coord(carry.y, out, 1, stride, off);
    store_coord(carry.z, out, 2, stride, off);
  }
}

}  // namespace

// group: 1 = G1 (3 component addresses per point batch), 2 = G2 (6).
// ``base``: the n-point batch; ``out``: the prefix components.  Returns
// cudaGetLastError().
extern "C" int oz_scan_full(int group, const unsigned long long* base,
                            long long n, const void* idx, long long sb,
                            long long sr, long long sl, int batch, int rows,
                            int lanes, const unsigned long long* out,
                            void* stream) {
  if (batch <= 0 || lanes <= 0 || rows <= 0 || n <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int cnt = 3 * group;
  const size_t total = (size_t)batch * lanes;
  const unsigned g = (unsigned)((total + kThreads - 1) / kThreads);
  if (group == 1)
    scan_full_kernel<G1Coord><<<g, kThreads, 0, s>>>(
        make_ptrs(base, cnt), (size_t)n, (const int32_t*)idx, sb, sr, sl,
        batch, rows, lanes, make_ptrs(out, cnt));
  else
    scan_full_kernel<G2Coord><<<g, kThreads, 0, s>>>(
        make_ptrs(base, cnt), (size_t)n, (const int32_t*)idx, sb, sr, sl,
        batch, rows, lanes, make_ptrs(out, cnt));
  return (int)cudaGetLastError();
}
