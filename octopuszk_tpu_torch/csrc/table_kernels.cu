// Two chains of (d) add_points (octopuszk_tpu/ops/pallas_ops.py::
// add_points, _add_kernel) as one launch each, G1 and G2:
// * window_table: the fixed-base window table of ops/msm.py
//   _window_table (run eagerly, its masked loop is outerc x w launches,
//   255 per base at w = 15, and adds w 2^(w-1) times per window).
// * combine_windows: ops/msm.py _combine_windows (eagerly, an add and a
//   doubling chain launch per window).
//
// window_table.  Bound on this card: integer multiply throughput, one add
// per entry (outerc (2^w - 1): 557,039 at w = 15, outerc = 17).  Design:
// rcb.cuh window_table_rounds, round t makes the entries [2^t, 2^(t+1))
// of every window with one add each from an entry of an earlier round.
// The first kBlockRounds rounds (255 adds per window) run on one block
// per window between __syncthreads; a grid-wide barrier before each of
// them would cost more than their adds.  The rest (each round at least
// a block's worth of adds per window, the last ones waves over the
// card) spread over a cooperative launch and meet at grid.cuh's barrier.
// The latency of w dependent adds is the floor.
//
// combine_windows.  Bound: the latency of one accumulator's chain (15 x
// (17 doublings + 1 add) on the main path, batch 1), not throughput.
// Design: one warp per accumulator, each field element spread over the
// eight lanes of a group and the independent products of a formula on
// the warp's four groups at once (lanes.cuh): a G1 doubling is two
// rounds of products, an add four.
#include <cuda_runtime.h>
#include "grid.cuh"
#include "lanes.cuh"
#include "curve.cuh"

namespace {

using levels::GridSched;
using levels::kThreads;

// rounds 0 .. 7 on a block of kThreads: round 7 makes 2^7 entries
constexpr int kBlockRounds = 8;
static_assert(1 << (kBlockRounds - 1) == kThreads, "one add a thread");

template <class C>
__global__ void __launch_bounds__(kThreads)
window_table_kernel(PointPtrs base, PointPtrs powers, size_t npow, int w,
                    int outerc, PointPtrs out, unsigned* count) {
  GridSched sched{count, 0u};
  window_table_rounds<C>(base, powers, npow, w, outerc, out, kBlockRounds,
                         sched);
}

// one warp per accumulator (the warp's index in the grid)
template <class C>
__global__ void __launch_bounds__(kThreads)
combine_windows_kernel(PointPtrs wins, size_t batch, int num_win, int c,
                       PointPtrs out) {
  typedef typename lanes::Spread<C, lanes::WarpLanes>::type S;
  const size_t b = ((size_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (b >= batch) return;                 // the whole warp
  lanes::store_point(lanes::combine_windows<S>(wins, batch * num_win,
                                               b * num_win, num_win, c),
                     out, batch, b);
}

}  // namespace

// group: 1 = G1 (3 component addresses per point batch), 2 = G2 (6).
// Each function returns a CUDA error code (0 = launched).

// base: one point [8, 1]; powers: [8, npow], point j - 1 = [2^j] base,
// npow >= outerc * w - 1; out: [8, outerc << w], entry (win << w) + d =
// [d 2^(win w)] base; count: one zeroed word
extern "C" int oz_window_table(int group, const unsigned long long* base,
                               const unsigned long long* powers,
                               long long npow, int w, int outerc,
                               const unsigned long long* out, void* count,
                               void* stream) {
  if (w < 1 || w > 24 || outerc < 1 || npow < (long long)outerc * w - 1)
    return (int)cudaErrorInvalidValue;
  const int cnt = 3 * group;
  PointPtrs b = make_ptrs(base, cnt), p = make_ptrs(powers, cnt),
            o = make_ptrs(out, cnt);
  size_t n = (size_t)npow;
  unsigned* c = (unsigned*)count;
  void* args[] = {&b, &p, &n, &w, &outerc, &o, &c};
  // the widest round: outerc 2^(w-1) adds
  const size_t items = (size_t)outerc << (w - 1);
  return levels::launch_cooperative(
      group == 1 ? window_table_kernel<G1Coord> : window_table_kernel<G2Coord>,
      items, args, (cudaStream_t)stream);
}

// wins: [8, batch, num_win]; out: [8, batch]
extern "C" int oz_combine_windows(int group, const unsigned long long* wins,
                                  long long batch, int num_win, int c,
                                  const unsigned long long* out,
                                  void* stream) {
  if (batch <= 0 || num_win < 1 || c < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int cnt = 3 * group;
  const unsigned g =
      (unsigned)(((size_t)batch * 32 + kThreads - 1) / kThreads);
  const PointPtrs w = make_ptrs(wins, cnt), o = make_ptrs(out, cnt);
  if (group == 1)
    combine_windows_kernel<G1Coord><<<g, kThreads, 0, s>>>(
        w, (size_t)batch, num_win, c, o);
  else
    combine_windows_kernel<G2Coord><<<g, kThreads, 0, s>>>(
        w, (size_t)batch, num_win, c, o);
  return (int)cudaGetLastError();
}
