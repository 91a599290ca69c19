// Batched point kernels: (d) add_points, (e) double_points, G1 and G2.
//
// They replace the TPU kernels octopuszk_tpu/ops/pallas_ops.py::add_points
// (_add_kernel) and ::double_points (_double_kernel), instances of
// pointwise_kernel that trace curves/group_ops.py add / double.
//
// add_points.  Bound on this card: integer multiply throughput and
// registers.  A G1 add is 12 field products (about 1,700 32-bit
// multiply-adds) for 288 bytes moved; a G2 add three times the products
// for twice the bytes.  Coordinates word-major so loads coalesce, the
// whole formula in registers with no intermediate in device memory.
// * G1: one thread per point (0.71 of its bound, PERF.md).
// * G2: one thread would keep about a dozen Fp2 temporaries (192 words)
//   alive, more than the 255 registers a thread may hold, and spill.  So
//   two threads a point (rcb.cuh add_point_pair, pt_add_pair): each runs
//   half of every level of the add's products and the pair trades the
//   results by shuffles, as lane_row_sums does (bucket_kernels.cu), in
//   180 registers, no spill.  Measured against it on the H100 (PERF.md,
//   scripts/tree_designs.py): one thread a point (255 registers and a
//   spill), 1.2x (BN254a) and 1.6x (BN254b) slower; one thread with
//   pt_add's products in the order that keeps the fewest temporaries
//   alive, no better; the pair with each thread loading one point and
//   trading it (208 registers), and blocks of 32 or 64 threads, within
//   2 %; at most 168 registers (three blocks of 128 an SM), 4-7 % faster
//   but spilling (44 B on BN254a, 208 B on BN254b).  G1's add stays on
//   one thread: on a pair it is 16-17 % slower.

// double_points runs a whole doubling chain in one launch: ``times``
// doublings of each point, the point held in registers throughout, and
// with ``every_step`` each intermediate [2^j]P written to an output with
// one more trailing axis (component word k, point i, step j at
// k * n * times + i * times + j).  The reference runs these chains as
// fori_loops inside one compiled program (ops/msm.py _abel,
// _window_table); run eagerly one double per launch, a chain cost a launch
// and the host's wrapper call for a few microseconds of work.
//
// The design follows ``times``, the length of the chain:
// * times = 1, one double of each point: a throughput case, bound like
//   add_points; one thread per point.
// * times >= 2, a chain: every double waits on the one before, and the
//   main path's chains double 1 to 15 points (the window table's 255
//   doublings of one point, the Abel sum's 16 of one point per window), so
//   what bounds them is one point's dependent latency, not throughput.
//   One warp per point (lanes.cuh): each field element spread over the
//   eight lanes of a group and a double's independent products on the
//   warp's four groups, so a G1 double is two rounds of products where
//   one thread runs 8 products in turn, a G2 double seven rounds for 27.
//   The 31 lanes that one thread would leave idle cost nothing here: no
//   other work waits for them.
#include <cuda_runtime.h>
#include "lanes.cuh"
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

// two threads a point; a warp's threads stay to the end (they shuffle)
template <class C>
__global__ void __launch_bounds__(kThreads)
add_points_pair_kernel(PointPtrs p, PointPtrs q, PointPtrs out, size_t n) {
  const size_t t = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if ((t & ~(size_t)31) >> 1 >= n) return;       // the whole warp
  add_point_pair<C, ShflPair>(p, q, out, n, t);
}

// times = 1: one thread per point
template <class C>
__global__ void __launch_bounds__(kThreads)
double_points_kernel(PointPtrs p, PointPtrs out, size_t n) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  store_point(pt_double(load_point<C>(p, n, i)), out, n, i);
}

// times >= 2: one warp per point (the warp's index in the grid)
template <class C, bool EVERY_STEP>
__global__ void __launch_bounds__(kThreads)
double_chain_kernel(PointPtrs p, PointPtrs out, size_t n, int times) {
  typedef typename lanes::Spread<C, lanes::WarpLanes>::type S;
  const size_t i = ((size_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (i >= n) return;                     // the whole warp
  lanes::double_chain<S>(p, out, n, i, times, EVERY_STEP);
}

template <class C>
void launch_double(PointPtrs p, PointPtrs out, size_t n, int times,
                   bool every_step, cudaStream_t s) {
  if (times == 1) {
    const unsigned g = (unsigned)((n + kThreads - 1) / kThreads);
    double_points_kernel<C><<<g, kThreads, 0, s>>>(p, out, n);
    return;
  }
  const unsigned g = (unsigned)((n * 32 + kThreads - 1) / kThreads);
  if (every_step)
    double_chain_kernel<C, true><<<g, kThreads, 0, s>>>(p, out, n, times);
  else
    double_chain_kernel<C, false><<<g, kThreads, 0, s>>>(p, out, n, times);
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
  const size_t threads = (size_t)n * group;
  const unsigned g = (unsigned)((threads + kThreads - 1) / kThreads);
  if (group == 1)
    add_points_kernel<G1Coord><<<g, kThreads, 0, s>>>(make_ptrs(p, cnt), make_ptrs(q, cnt), make_ptrs(out, cnt), (size_t)n);
  else
    add_points_pair_kernel<G2Coord><<<g, kThreads, 0, s>>>(make_ptrs(p, cnt), make_ptrs(q, cnt), make_ptrs(out, cnt), (size_t)n);
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
  const PointPtrs pp = make_ptrs(p, cnt), po = make_ptrs(out, cnt);
  if (group == 1)
    launch_double<G1Coord>(pp, po, (size_t)n, times, every_step != 0, s);
  else
    launch_double<G2Coord>(pp, po, (size_t)n, times, every_step != 0, s);
  return (int)cudaGetLastError();
}
