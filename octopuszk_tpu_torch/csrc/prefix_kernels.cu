// ops/msm.py _hs_prefix as one launch, G1 and G2: the inclusive prefix
// sums of the Pippenger bucket reduction's lane totals (a chain of (d)
// add_points, octopuszk_tpu/ops/pallas_ops.py::add_points, _add_kernel,
// which the reference runs as a fori_loop over the levels).
//
// Bound on this card: integer multiply throughput (every element of every
// level is an add: 15 windows x 4,096 lanes x 12 levels on the main path,
// 61,440 adds a level, about one wave of the card's threads) and the
// dependency between levels.  Design (rcb.cuh prefix_sum_item,
// prefix.cuh): the full Hillis-Steele dataflow in two phases of items
// that blocks take from a ticket.  Phase 1 runs levels 0 .. 3 on tiles of
// a row, each tile recomputing the 15 elements before it; phase 2, after
// one wait for the row's tiles, runs levels 4 .. L - 1 on each residue
// class mod 16 of a row on one block, a Hillis-Steele scan of its own (j
// - 2^l = j mod 16 for l >= 4).  The levels pass between two
// shared-memory buffers, one __syncthreads a level; no grid-wide barrier
// and no cooperative launch.  G1: one thread an add, three blocks of 128
// an SM, phase 2's adds of the identity as (X Y, Y^2, Y Z) (3 products of
// 12, the same words).  G2: each add on a pair (pt_add_pair: 255
// registers on BN254b without a spill), two blocks of 128 an SM; the
// identity's adds complete (the shorter form slowed BN254b's loop).
// Measured against it on the H100 (PERF.md, scripts/prefix_designs.py):
// the levels meeting at eleven grid-wide barriers of a cooperative launch
// (grid.cuh), one thread or a pair an add; classes mod 2^3 .. 2^6; pairs
// on G1, one thread on G2; other blocks.  What holds G2 is one add's rate
// at 8 warps an SM and its 240 classes on 264 resident blocks.
#include <cuda_runtime.h>
#include "prefix.cuh"
#include "curve.cuh"

namespace {

template <class C>
int launch(PointPtrs in, PointPtrs out, size_t batch, size_t n,
           unsigned* count, cudaStream_t s) {
  typedef PrefixOf<C> K;
  return launch_prefix<C, K::kThreads, K::kBlock, K::kMinBlocks, K::kRounds,
                       K::kSlots, K::kIdentity>(K::kLog, in, out, batch, n,
                                                count, s);
}

}  // namespace

// group: 1 = G1 (3 component addresses per point batch), 2 = G2 (6).
// out [8, batch, n]: inclusive prefix sums of each row of the word-major
// [8, batch, n] batch p (batch n < 2^32); count: 1 + batch zeroed words.
// Returns a CUDA error code (0 = launched).
extern "C" int oz_prefix_sum(int group, const unsigned long long* p,
                             long long batch, long long n,
                             const unsigned long long* out, void* count,
                             void* stream) {
  if (batch <= 0 || n <= 0 || batch > 0xffffffffll / n)
    return (int)cudaErrorInvalidValue;
  const int cnt = 3 * group;
  cudaStream_t s = (cudaStream_t)stream;
  if (group == 1)
    return launch<G1Coord>(make_ptrs(p, cnt), make_ptrs(out, cnt),
                           (size_t)batch, (size_t)n, (unsigned*)count, s);
  return launch<G2Coord>(make_ptrs(p, cnt), make_ptrs(out, cnt),
                         (size_t)batch, (size_t)n, (unsigned*)count, s);
}
