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
//   level l is node j plus node j + 2^l of the level below (plus the
//   identity past the end): n - 1 adds and the identity adds, not n log n.
//   Its levels depend on each other, so what bounds it is its critical
//   path: 11 levels of adds on the main path (15 rows of 2,048 lane
//   totals), fewer than 1,000 adds live after the fourth.  The design
//   (rcb.cuh tree_sum_block): subtrees of 2^8 leaves on blocks of 256
//   threads, each add on a pair (pt_add_pair: 6 rounds of products on G1,
//   21 on G2, against 12 and 42 on one thread), a subtree's levels in
//   shared memory between __syncthreads; the last block of a row's
//   subtrees to finish (a count per group, after a __threadfence) adds
//   their roots on its own pairs.  No cooperative launch and no grid-wide
//   barrier: the rows end on their own.  Measured against it on the H100
//   (PERF.md, scripts/tree_designs.py): the parent's eleven levels of
//   one-thread adds meeting at grid-wide barriers (grid.cuh), 2.3-3.1x
//   slower; the same levels with pair adds, 1.4-1.9x; subtrees of 2^5 to
//   2^7 leaves, slower on every curve and group; the levels of at most 8
//   adds (or the tiers past the first) on one warp an add (lanes.cuh
//   pt_add), 11-14 % faster on G1 (5-8 us), slower on BN254a's G2, and
//   spilling on BN254b's G2 with a second add body in the kernel.
#include <cuda_runtime.h>
#include "grid.cuh"
#include "curve.cuh"

namespace {

using levels::kThreads;

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
__global__ void __launch_bounds__(1 << kTreeLog)
tree_sum_kernel(PointPtrs in, PointPtrs scratch, PointPtrs out, size_t batch,
                size_t n, unsigned* count) {
  constexpr int kSlots = 1 << (kTreeLog - 1);
  constexpr int kComps = 3 * (int)(sizeof(C) / 32);
  __shared__ uint32_t smem[kComps * 8 * kSlots];
  __shared__ unsigned flag;
  PointPtrs slots;
#pragma unroll
  for (int c = 0; c < 6; c++)
    slots.c[c] = c < kComps ? smem + c * 8 * kSlots : nullptr;
  TreeBlock sched{&flag};
  tree_sum_block<C, ShflPair, kTreeLog>(in, scratch, out, batch, n,
                                        blockIdx.x, threadIdx.x, slots,
                                        count, sched);
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
// [8, batch, n]; count: batch * ceil(n / 2) zeroed words
extern "C" int oz_tree_sum(int group, const unsigned long long* p,
                           const unsigned long long* scratch, long long batch,
                           long long n, const unsigned long long* out,
                           void* count, void* stream) {
  if (batch <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  const int cnt = 3 * group;
  const TreeShape s = tree_shape<kTreeLog>((size_t)batch, (size_t)n);
  if (s.blocks > 0x7fffffffu) return (int)cudaErrorInvalidValue;
  const dim3 g((unsigned)s.blocks), b(1u << kTreeLog);
  cudaStream_t st = (cudaStream_t)stream;
  if (group == 1)
    tree_sum_kernel<G1Coord><<<g, b, 0, st>>>(make_ptrs(p, cnt), make_ptrs(scratch, cnt), make_ptrs(out, cnt), (size_t)batch, (size_t)n, (unsigned*)count);
  else
    tree_sum_kernel<G2Coord><<<g, b, 0, st>>>(make_ptrs(p, cnt), make_ptrs(scratch, cnt), make_ptrs(out, cnt), (size_t)batch, (size_t)n, (unsigned*)count);
  return (int)cudaGetLastError();
}
