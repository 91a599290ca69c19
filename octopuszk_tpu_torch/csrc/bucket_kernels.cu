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
// * lane_row_sums: the function fixes 30,720 chains of 32 dependent adds
//   on the main path (15 windows x 2,048 lanes), about 233 an SM, and one
//   thread a chain held 255 registers on G2 (spilling), so an SM ran 8
//   warps of long carry chains at a fifth of the multiply rate.  Two
//   threads a chain (rcb.cuh lane_row_sum_pair, pt_add_pair): each runs
//   half of every level of an add's products and the pair trades the
//   results by shuffles, so a thread's chain is half as long and it holds
//   about 180 registers on G2, no spill.  Measured against it on the H100
//   (PERF.md, scripts/chain_designs.py): one thread a chain, the same
//   with each block's rows staged through shared memory, a warp a chain
//   with every element spread over 8 lanes (lanes.cuh), an 8-lane group
//   a chain; all slower on G2, and on G1 none beat one thread a chain by
//   more than the spread between runs.
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

// the value of the other thread of a pair (lanes 2k, 2k + 1 of a warp)
struct ShflPair {
  template <class M>
  static __device__ __forceinline__ Fp<M> other(const Fp<M>& a) {
    Fp<M> r;
#pragma unroll
    for (int k = 0; k < 8; k++)
      r.v[k] = __shfl_xor_sync(0xffffffffu, a.v[k], 1);
    return r;
  }
  template <class M>
  static __device__ __forceinline__ Fp2<M> other(const Fp2<M>& a) {
    return {other(a.c0), other(a.c1)};
  }
};

// thread 2 i + h of the grid is half h of chain i; a warp's threads stay
// to the end (they shuffle), those past the last chain repeat it unstored
template <class C>
__global__ void __launch_bounds__(kThreads)
lane_row_sums_kernel(PointPtrs p, size_t batch, size_t n, size_t width,
                     size_t rows, PointPtrs out) {
  const size_t t = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t chains = batch * width;
  if ((t & ~(size_t)31) >> 1 >= chains) return;   // the whole warp
  const bool h = t & 1, live = (t >> 1) < chains;
  const size_t i = live ? t >> 1 : chains - 1;
  const size_t b = i / width, lane = i - b * width;
  const Pt<C> acc = lane_row_sum_pair<C, ShflPair>(p, batch * n, b * n, n,
                                                   lane, rows, h);
  if (live && !h) store_point(acc, out, chains, i);
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
  const size_t threads = 2 * (size_t)batch * (size_t)width;
  const unsigned g = (unsigned)((threads + kThreads - 1) / kThreads);
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
