// Batched point kernels: (d) add_points, (e) double_points, G1 and G2.
//
// They replace the TPU kernels octopuszk_tpu/ops/pallas_ops.py::add_points
// (_add_kernel) and ::double_points (_double_kernel), instances of
// pointwise_kernel that trace curves/group_ops.py add / double.
//
// Bound on this card: integer multiply throughput and registers.  A G1 add
// is 12 field products (about 1,700 32-bit multiply-adds) for 288 bytes
// moved; a G2 add three times the products for twice the bytes.  Design:
// one thread per point, coordinates word-major so loads coalesce, the whole
// formula in registers with no intermediate in device memory.  The G2 add
// keeps about a dozen Fp2 temporaries (192 words) alive, more than the 255
// registers a thread may hold, so the compiler spills some to local memory;
// that is accepted here.
//
// double_points runs a whole doubling chain in one launch: ``times``
// doublings of each point, the point held in registers throughout, and
// with ``every_step`` each intermediate [2^j]P written to an output with
// one more trailing axis (component word k, point i, step j at
// k * n * times + i * times + j).  The reference runs these chains as
// fori_loops inside one compiled program (ops/msm.py _abel,
// _combine_windows, _window_table); run eagerly one double per launch, a
// chain cost a launch and the host's wrapper call (about 0.07 ms) for a
// few microseconds of work.  What bounds a chain now is one thread's
// dependent latency: every double waits on the one before, so a chain of
// 255 G2 doublings (the window table) is 255 x 27 dependent field products
// on one thread, and only a shorter product (field.cuh's carry chains)
// makes it faster.  A warp per point, splitting a double's products over
// lanes, would cut that latency but leave 31 of 32 lanes of a warp idle
// for the 1 to 15 points that chains double; it is not worth it here.
#include <cuda_runtime.h>
#include "rcb.cuh"
#include "curve.cuh"

namespace {

constexpr int kThreads = 128;

template <class C>
__global__ void __launch_bounds__(kThreads)
add_points_kernel(PointPtrs p, PointPtrs q, PointPtrs out, size_t n) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  store_point(pt_add(load_point<C>(p, n, i), load_point<C>(q, n, i)), out, n, i);
}

template <class C, bool EVERY_STEP>
__global__ void __launch_bounds__(kThreads)
double_points_kernel(PointPtrs p, PointPtrs out, size_t n, int times) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Pt<C> q = load_point<C>(p, n, i);
#pragma unroll 1
  for (int j = 0; j < times; j++) {
    q = pt_double(q);
    if (EVERY_STEP) store_point(q, out, n * times, i * times + j);
  }
  if (!EVERY_STEP) store_point(q, out, n, i);
}

}  // namespace

// group: 1 = G1 (3 addresses per point), 2 = G2 (6 addresses per point).
// Addresses are word-major int32[8, n] coordinate components.

extern "C" int oz_add_points(int group, const unsigned long long* p,
                             const unsigned long long* q,
                             const unsigned long long* out, long long n,
                             void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int cnt = 3 * group;
  const unsigned g = (unsigned)(((size_t)n + kThreads - 1) / kThreads);
  if (group == 1)
    add_points_kernel<G1Coord><<<g, kThreads, 0, s>>>(make_ptrs(p, cnt), make_ptrs(q, cnt), make_ptrs(out, cnt), (size_t)n);
  else
    add_points_kernel<G2Coord><<<g, kThreads, 0, s>>>(make_ptrs(p, cnt), make_ptrs(q, cnt), make_ptrs(out, cnt), (size_t)n);
  return (int)cudaGetLastError();
}

// ``times`` doublings of each of n points; every_step: ``out`` components
// are [8, n, times] and receive every intermediate, else [8, n] and the
// last one.
extern "C" int oz_double_points(int group, const unsigned long long* p,
                                const unsigned long long* out, long long n,
                                int times, int every_step, void* stream) {
  if (n <= 0 || times <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int cnt = 3 * group;
  const unsigned g = (unsigned)(((size_t)n + kThreads - 1) / kThreads);
  const PointPtrs pp = make_ptrs(p, cnt), po = make_ptrs(out, cnt);
  if (group == 1 && every_step)
    double_points_kernel<G1Coord, true><<<g, kThreads, 0, s>>>(pp, po, (size_t)n, times);
  else if (group == 1)
    double_points_kernel<G1Coord, false><<<g, kThreads, 0, s>>>(pp, po, (size_t)n, times);
  else if (every_step)
    double_points_kernel<G2Coord, true><<<g, kThreads, 0, s>>>(pp, po, (size_t)n, times);
  else
    double_points_kernel<G2Coord, false><<<g, kThreads, 0, s>>>(pp, po, (size_t)n, times);
  return (int)cudaGetLastError();
}
