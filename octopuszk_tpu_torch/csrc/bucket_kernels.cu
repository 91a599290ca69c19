// Two loops of the Pippenger bucket reduction as one launch each, G1 and
// G2: the row loop of ops/msm.py _scan_sum (lane_row_sums) and
// group_ops.tree_reduce (tree_sum); prefix_kernels.cu holds the third,
// _hs_prefix.  They are chains of (d) add_points, octopuszk_tpu/ops/
// pallas_ops.py::add_points (_add_kernel), which the reference runs as
// lax.scan and fori_loop bodies inside one compiled program; run eagerly
// they cost one launch per row or level, each with its wrapper call,
// identity fill and concatenation (about 70 launches per MSM).
//
// Bound on this card: integer multiply throughput (12 field products per
// G1 add, 42 per G2 add, against 288 or 576 bytes moved), and for the
// levels of the tree the dependency between levels.  Design:
// * lane_row_sums: one thread per (batch row, lane) adds its rows in
//   order, the running sum in registers (rcb.cuh lane_row_sum).
// * tree_sum: tree_reduce keeps only element 0 of a Hillis-Steele suffix
//   fold, and element 0 is exactly the pairwise tree whose node j at
//   level l is node j plus node j + 2^(l-1) of the level below (plus the
//   identity past the end): n - 1 adds and the identity adds, not
//   n log n (rcb.cuh tree_sum_rows).  Level 0 reads the input, the others
//   work in place in a scratch buffer, and the last writes each row's
//   root.  The levels spread over the whole card and meet at a grid-wide
//   barrier of a cooperative launch (grid.cuh): one block per batch row
//   meeting at __syncthreads ran 1.3x (G1) and 1.7x (G2) slower on the
//   H100 (PERF.md).
#include <cuda_runtime.h>
#include "grid.cuh"
#include "curve.cuh"

namespace {

using levels::GridSched;
using levels::kThreads;

template <class C>
__global__ void __launch_bounds__(kThreads)
lane_row_sums_kernel(PointPtrs p, size_t batch, size_t n, size_t width,
                     size_t rows, PointPtrs out) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= batch * width) return;
  const size_t b = i / width, lane = i - b * width;
  store_point(lane_row_sum<C>(p, batch * n, b * n, n, lane, rows), out,
              batch * width, i);
}

template <class C>
__global__ void __launch_bounds__(kThreads)
tree_sum_kernel(PointPtrs in, PointPtrs scratch, PointPtrs out, size_t batch,
                size_t n, unsigned* count) {
  GridSched sched{count, 0u};
  tree_sum_rows<C>(in, scratch, out, batch, n, sched);
}

}  // namespace

// group: 1 = G1 (3 component addresses per point batch), 2 = G2 (6).
// Point batches are word-major [8, batch, n] components; each function
// returns a CUDA error code (0 = launched).

// out [8, batch, width]: lane l of row b sums positions [l rows, (l+1)
// rows) of the row, rows = ceil(n / width), from the identity
extern "C" int oz_lane_row_sums(int group, const unsigned long long* p,
                                long long batch, long long n, long long width,
                                const unsigned long long* out, void* stream) {
  if (batch <= 0 || n <= 0 || width <= 0 || width > n)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int cnt = 3 * group;
  const size_t rows = (size_t)((n + width - 1) / width);
  const size_t items = (size_t)batch * (size_t)width;
  const unsigned g = (unsigned)((items + kThreads - 1) / kThreads);
  if (group == 1)
    lane_row_sums_kernel<G1Coord><<<g, kThreads, 0, s>>>(make_ptrs(p, cnt), (size_t)batch, (size_t)n, (size_t)width, rows, make_ptrs(out, cnt));
  else
    lane_row_sums_kernel<G2Coord><<<g, kThreads, 0, s>>>(make_ptrs(p, cnt), (size_t)batch, (size_t)n, (size_t)width, rows, make_ptrs(out, cnt));
  return (int)cudaGetLastError();
}

// out [8, batch]: element 0 of the suffix fold of each row; scratch
// [8, batch, n]; count: one zeroed word
extern "C" int oz_tree_sum(int group, const unsigned long long* p,
                           const unsigned long long* scratch, long long batch,
                           long long n, const unsigned long long* out,
                           void* count, void* stream) {
  if (batch <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  const int cnt = 3 * group;
  const size_t items = (size_t)batch * (size_t)((n + 1) / 2);
  return levels::launch_levels(
      group == 1 ? tree_sum_kernel<G1Coord> : tree_sum_kernel<G2Coord>, items,
      make_ptrs(p, cnt), make_ptrs(scratch, cnt), make_ptrs(out, cnt),
      (size_t)batch, (size_t)n, (unsigned*)count, (cudaStream_t)stream);
}
