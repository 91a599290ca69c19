// Two chains of (d) add_points (octopuszk_tpu/ops/pallas_ops.py::
// add_points, _add_kernel) as one launch each, G1 and G2:
// * window_table: the fixed-base window table of ops/msm.py
//   _window_table, one thread per entry (window win, digit d): from the
//   identity, add [2^(win w + b)] G for each set bit b of d, the adds that
//   the masked loop (w adds of the whole row per window, each selected
//   where the bit is set) keeps; run eagerly, that loop is outerc x w
//   launches (255 per base at w = 15).
// * combine_windows: ops/msm.py _combine_windows, one thread per
//   accumulator: from the identity, acc = [2^c] acc + W_j, most
//   significant window first (eagerly, an add and a doubling chain launch
//   per window).
//
// Bound on this card: integer multiply throughput for the table (about
// 4.2 M G2 adds for 17 windows of 2^15 entries at w = 15, an entry up to
// 15 dependent adds); one thread's dependent latency for the combine
// (one accumulator per MSM: 15 x (17 doublings + 1 add)).
#include <cuda_runtime.h>
#include "rcb.cuh"
#include "curve.cuh"

namespace {

constexpr int kThreads = 128;

template <class C>
__global__ void __launch_bounds__(kThreads)
window_table_kernel(PointPtrs base, PointPtrs powers, size_t npow, int w,
                    int outerc, PointPtrs out) {
  const size_t t = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t entries = (size_t)outerc << w;
  if (t >= entries) return;
  const int win = (int)(t >> w);
  const unsigned d = (unsigned)(t & (((size_t)1 << w) - 1));
  store_point(window_entry<C>(base, powers, npow, win, d, w), out, entries,
              t);
}

template <class C>
__global__ void __launch_bounds__(kThreads)
combine_windows_kernel(PointPtrs wins, size_t batch, int num_win, int c,
                       PointPtrs out) {
  const size_t b = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= batch) return;
  store_point(combine_windows<C>(wins, batch * num_win, b * num_win,
                                 num_win, c),
              out, batch, b);
}

}  // namespace

// group: 1 = G1 (3 component addresses per point batch), 2 = G2 (6).
// Each function returns a CUDA error code (0 = launched).

// base: one point [8, 1]; powers: [8, npow], point j - 1 = [2^j] base,
// npow >= outerc * w - 1; out: [8, outerc << w], entry (win << w) + d =
// [d 2^(win w)] base
extern "C" int oz_window_table(int group, const unsigned long long* base,
                               const unsigned long long* powers,
                               long long npow, int w, int outerc,
                               const unsigned long long* out, void* stream) {
  if (w < 1 || w > 24 || outerc < 1 || npow < (long long)outerc * w - 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int cnt = 3 * group;
  const size_t entries = (size_t)outerc << w;
  const unsigned g = (unsigned)((entries + kThreads - 1) / kThreads);
  if (group == 1)
    window_table_kernel<G1Coord><<<g, kThreads, 0, s>>>(make_ptrs(base, cnt), make_ptrs(powers, cnt), (size_t)npow, w, outerc, make_ptrs(out, cnt));
  else
    window_table_kernel<G2Coord><<<g, kThreads, 0, s>>>(make_ptrs(base, cnt), make_ptrs(powers, cnt), (size_t)npow, w, outerc, make_ptrs(out, cnt));
  return (int)cudaGetLastError();
}

// wins: [8, batch, num_win]; out: [8, batch]
extern "C" int oz_combine_windows(int group, const unsigned long long* wins,
                                  long long batch, int num_win, int c,
                                  const unsigned long long* out,
                                  void* stream) {
  if (batch <= 0 || num_win < 1 || c < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int cnt = 3 * group;
  const unsigned g = (unsigned)(((size_t)batch + kThreads - 1) / kThreads);
  if (group == 1)
    combine_windows_kernel<G1Coord><<<g, kThreads, 0, s>>>(make_ptrs(wins, cnt), (size_t)batch, num_win, c, make_ptrs(out, cnt));
  else
    combine_windows_kernel<G2Coord><<<g, kThreads, 0, s>>>(make_ptrs(wins, cnt), (size_t)batch, num_win, c, make_ptrs(out, cnt));
  return (int)cudaGetLastError();
}
