// ops/msm.py _hs_prefix as one launch, G1 and G2: the inclusive prefix
// sums of the Pippenger bucket reduction's lane totals (a chain of (d)
// add_points, octopuszk_tpu/ops/pallas_ops.py::add_points, _add_kernel;
// before: one launch per level, each with an identity fill and a
// concatenation).
//
// Bound on this card: integer multiply throughput (every element of every
// level is an add: 15 windows x 4,096 lanes x 12 levels on the main path)
// and the dependency between levels.  Design: the full Hillis-Steele
// dataflow (rcb.cuh prefix_sum_rows) between two buffers, the output and
// a scratch buffer, so that a level never reads what it writes; the last
// level lands in the output.  A window's 4,096 lanes of G2 points are
// 786 KB, more than an SM's shared memory, so the levels pass through
// device memory (in L2: 15 windows are 11.8 MB).  The levels spread over
// the whole card and meet at a grid-wide barrier of a cooperative launch
// (grid.cuh): one block per window meeting at __syncthreads left 117 of
// 132 SMs idle and ran 9x (G1) and 13x (G2) slower on the H100 (PERF.md).
#include <cuda_runtime.h>
#include "grid.cuh"
#include "curve.cuh"

namespace {

using levels::GridSched;
using levels::kThreads;

template <class C>
__global__ void __launch_bounds__(kThreads)
prefix_sum_kernel(PointPtrs in, PointPtrs scratch, PointPtrs out,
                  size_t batch, size_t n, unsigned* count) {
  GridSched sched{count, 0u};
  prefix_sum_rows<C>(in, scratch, out, batch, n, sched);
}

}  // namespace

// group: 1 = G1 (3 component addresses per point batch), 2 = G2 (6).
// out [8, batch, n]: inclusive prefix sums of each row of the word-major
// [8, batch, n] batch p; scratch [8, batch, n]; count: one zeroed word.
// Returns a CUDA error code (0 = launched).
extern "C" int oz_prefix_sum(int group, const unsigned long long* p,
                             const unsigned long long* scratch,
                             long long batch, long long n,
                             const unsigned long long* out, void* count,
                             void* stream) {
  if (batch <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  const int cnt = 3 * group;
  const size_t items = (size_t)batch * (size_t)n;
  return levels::launch_levels(
      group == 1 ? prefix_sum_kernel<G1Coord> : prefix_sum_kernel<G2Coord>,
      items, make_ptrs(p, cnt), make_ptrs(scratch, cnt), make_ptrs(out, cnt),
      (size_t)batch, (size_t)n, (unsigned*)count, (cudaStream_t)stream);
}
