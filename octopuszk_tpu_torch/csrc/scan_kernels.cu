// Bucket-accumulation scans, G1 and G2, one template over a row step:
// (f) scan_accumulate_mixed (every prefix written) and (g)
// scan_accumulate_mixed_total (lane totals only) mixed-add affine rows of a
// packed base; (h) scan_accumulate full-adds projective rows (every prefix
// written).
//
// They replace the TPU kernels octopuszk_tpu/ops/pallas_ops.py::
// scan_accumulate_mixed (_scan_mixed_kernel), ::scan_accumulate_mixed_total
// (_scan_mixed_total_kernel) and ::scan_accumulate (_scan_kernel, the inner
// loop of the sort-based Pippenger over unpacked point batches,
// ops/msm.py::pippenger_msm).  There the row axis is a sequential grid
// dimension and the running sum lives in scratch memory between grid steps.
// Blocks run in no order here, so one thread owns one lane, keeps the
// projective running sum to itself and loops over the rows.
//
// The row gather is folded in: the kernel reads one point row per step
// through an index tensor, so the gathered rows never exist in device
// memory.  (f)/(g) read the packed base (one affine point per row of 16 or
// 32 words, identity = all zero) through entries (point index << 1) |
// negate (the sign of ops/msm.py::_gather_packed); a row whose Y is zero is
// the identity and leaves the running sum as it is.  (h) reads the n-point
// projective batch, which its wrapper repacks once per call into rows of 24
// or 48 words (X, Y, Z; a layout copy), through plain point indices, and
// adds every row with the complete add, identity rows included: a skipped
// add would change the projective words.  A leading batch dimension
// carries all windows of a chunk or an MSM in one launch, since 4,096 lanes
// alone would fill a few percent of the card.
//
// Bound on this card: integer multiply throughput (a mixed add is 11 field
// products and two mul_b3 per row, a full add 12 and two, against 64 / 96
// bytes read on G1, 128 / 192 on G2, and, with prefixes, 96 or 192 bytes
// written).  What the design does about it:
// * The product is field.cuh's carry-chain CIOS (PTX mad.lo.cc /
//   madc.hi.cc), about half the instructions of 64-bit multiply-adds.
// * The step is inlined into the row loop, which is kept rolled
//   (``#pragma unroll 1``): the running sum stays in registers and the
//   scheduler sees the whole row.  nvcc 12.9's cicc crashed on these loops
//   at -O3 with the 64-bit product inlined; with the carry-chain product
//   they compile.  Out of line the mixed step was 1.07x (G1) and 1.3x (G2)
//   slower on the H100 (PERF.md).
// * Registers: __launch_bounds__ asks for 16 resident warps per SM on G1
//   (at most 128 registers) and 8 on G2 (at most 255): capped at 168
//   registers for 12 warps, the G2 mixed step spills 0.8-1 KB a row to
//   local memory and runs 1.5x slower on the H100 (PERF.md), so the wider
//   register file wins over occupancy; rcb.cuh orders the mixed add so
//   that few temporaries live at once.  BN254b's G2 instance (Fp2 products
//   by nr = -5) spills 64-136 B at the same bound (PERF.md).
// * The gather's latency: each row is copied into shared memory by
//   cp.async one row ahead (two stages per thread, 16-byte pieces), and
//   its index two rows ahead, so the dependent loads overlap the row
//   before.  A point row is contiguous, so it is 2-6 sectors where (h)
//   read word-major components through the index: 24 or 48 sectors a row.
//   (h)'s G2 rows fill the 48 KB of static shared memory exactly (128
//   threads x 2 stages x 192 bytes).
// Blocks of 128 threads: 32 and 64 measured the same.
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include "rcb.cuh"
#include "curve.cuh"

namespace {

constexpr int kThreads = 128;

// resident blocks of kThreads per SM that __launch_bounds__ asks the
// register allocator to allow: 16 warps on G1, 8 on G2
template <class C>
struct Occupancy;
template <class M>
struct Occupancy<Fp<M>> {
  static constexpr int kMinBlocks = 4;
};
template <class M>
struct Occupancy<Fp2<M>> {
  static constexpr int kMinBlocks = 2;
};

struct OutPtrs {
  uint32_t* c[6];
};

// 8 words of one coordinate component, contiguous in a row
template <class M>
__device__ __forceinline__ Fp<M> load_row8(const uint32_t* row) {
  const uint4 lo = *reinterpret_cast<const uint4*>(row);
  const uint4 hi = *reinterpret_cast<const uint4*>(row + 4);
  Fp<M> r;
  r.v[0] = lo.x; r.v[1] = lo.y; r.v[2] = lo.z; r.v[3] = lo.w;
  r.v[4] = hi.x; r.v[5] = hi.y; r.v[6] = hi.z; r.v[7] = hi.w;
  return r;
}

template <class M>
__device__ __forceinline__ void load_row(const uint32_t* row, Fp<M>& c) {
  c = load_row8<M>(row);
}
template <class M>
__device__ __forceinline__ void load_row(const uint32_t* row, Fp2<M>& c) {
  c.c0 = load_row8<M>(row);
  c.c1 = load_row8<M>(row + 8);
}

// words of one coordinate in a row
template <class C>
struct CoordWords;
template <class M>
struct CoordWords<Fp<M>> {
  static constexpr int kValue = 8;
};
template <class M>
struct CoordWords<Fp2<M>> {
  static constexpr int kValue = 16;
};

// The step of (f) and (g): an affine row (X, Y) of the packed base, entry
// (point << 1) | negate; Y = 0 is the identity and is skipped.
struct MixedStep {
  static constexpr int kCoords = 2;
  __device__ __forceinline__ static uint32_t point(uint32_t e) {
    return e >> 1;
  }
  template <class C>
  __device__ __forceinline__ static void add_row(Pt<C>& carry,
                                                 const uint32_t* row,
                                                 uint32_t e) {
    C x, y;
    load_row(row, x);
    load_row(row + CoordWords<C>::kValue, y);
    if (!is_zero(y)) {
      if (e & 1u) y = neg(y);
      carry = pt_mixed_add(carry, x, y);
    }
  }
};

// The step of (h): a projective row (X, Y, Z), entry = point index; every
// row is added with the complete add.
struct FullStep {
  static constexpr int kCoords = 3;
  __device__ __forceinline__ static uint32_t point(uint32_t e) { return e; }
  template <class C>
  __device__ __forceinline__ static void add_row(Pt<C>& carry,
                                                 const uint32_t* row,
                                                 uint32_t) {
    Pt<C> q;
    load_row(row, q.x);
    load_row(row + CoordWords<C>::kValue, q.y);
    load_row(row + 2 * CoordWords<C>::kValue, q.z);
    carry = pt_add(carry, q);
  }
};

template <class M>
__device__ __forceinline__ void store_at(const Fp<M>& c, const OutPtrs& o,
                                         int ci, size_t stride, size_t off) {
  fp_store<M>(o.c[ci], stride, off, c);
}
template <class M>
__device__ __forceinline__ void store_at(const Fp2<M>& c, const OutPtrs& o,
                                         int ci, size_t stride, size_t off) {
  fp_store<M>(o.c[2 * ci], stride, off, c.c0);
  fp_store<M>(o.c[2 * ci + 1], stride, off, c.c1);
}

template <class C>
__device__ __forceinline__ void store_pt(const Pt<C>& p, const OutPtrs& o,
                                         size_t stride, size_t off) {
  store_at(p.x, o, 0, stride, off);
  store_at(p.y, o, 1, stride, off);
  store_at(p.z, o, 2, stride, off);
}

// ``base``: the point rows (the packed base, or (h)'s repacked batch).
// idx2[b, r, l] is read at b * sb + r * sr + l * sl (element strides).
// Prefix output component: int32[8, batch, rows, lanes]; totals output:
// int32[8, batch, lanes].
template <class C, class Step, bool WRITE_PREFIX>
__global__ void __launch_bounds__(kThreads, Occupancy<C>::kMinBlocks)
scan_kernel(const uint32_t* __restrict__ base,
            const int32_t* __restrict__ idx2, long long sb, long long sr,
            long long sl, int batch, int rows, int lanes, OutPtrs out) {
  constexpr int kRowWords = Step::kCoords * CoordWords<C>::kValue;
  constexpr int kChunks = kRowWords / 4;         // 16-byte pieces of a row
  __shared__ uint4 stage[2][kThreads][kChunks];  // this thread's two rows
  const size_t t = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (size_t)batch * lanes) return;
  const size_t b = t / lanes;
  const size_t l = t % lanes;
  Pt<C> carry;
  coord_zero(carry.x);
  coord_one(carry.y);
  coord_zero(carry.z);
  const int32_t* ix = idx2 + (long long)b * sb + (long long)l * sl;
  const size_t stride = WRITE_PREFIX ? (size_t)batch * rows * lanes
                                     : (size_t)batch * lanes;
  auto fetch = [&](uint32_t e, int s) {
    const uint4* src =
        reinterpret_cast<const uint4*>(base + (size_t)Step::point(e) *
                                                  kRowWords);
#pragma unroll
    for (int k = 0; k < kChunks; k++)
      __pipeline_memcpy_async(&stage[s][threadIdx.x][k], src + k, 16);
    __pipeline_commit();
  };
  uint32_t e = rows > 0 ? (uint32_t)ix[0] : 0u;
  if (rows > 0) fetch(e, 0);
  uint32_t e_next = rows > 1 ? (uint32_t)ix[sr] : 0u;
#pragma unroll 1
  for (int r = 0; r < rows; r++) {
    if (r + 1 < rows)
      fetch(e_next, (r + 1) & 1);
    else
      __pipeline_commit();                       // keeps the group count
    const uint32_t e_after =
        r + 2 < rows ? (uint32_t)ix[(long long)(r + 2) * sr] : 0u;
    __pipeline_wait_prior(1);                    // row r has landed
    Step::template add_row<C>(
        carry, reinterpret_cast<const uint32_t*>(stage[r & 1][threadIdx.x]),
        e);
    if (WRITE_PREFIX)
      store_pt(carry, out, stride, (b * rows + r) * lanes + l);
    e = e_next;
    e_next = e_after;
  }
  if (!WRITE_PREFIX) store_pt(carry, out, stride, b * lanes + l);
}

template <class C, class Step, bool WRITE_PREFIX>
int launch(const void* base, const void* idx2, long long sb,
           long long sr, long long sl, int batch, int rows, int lanes,
           const unsigned long long* out, cudaStream_t s) {
  OutPtrs o;
  const int count = 3 * (CoordWords<C>::kValue / 8);
  for (int k = 0; k < 6; k++)
    o.c[k] = k < count ? (uint32_t*)(uintptr_t)out[k] : nullptr;
  const size_t total = (size_t)batch * lanes;
  const unsigned g = (unsigned)((total + kThreads - 1) / kThreads);
  scan_kernel<C, Step, WRITE_PREFIX><<<g, kThreads, 0, s>>>(
      (const uint32_t*)base, (const int32_t*)idx2, sb, sr, sl, batch,
      rows, lanes, o);
  return (int)cudaGetLastError();
}

}  // namespace

// group: 1 = G1 (packed rows of 16 words, 3 outputs), 2 = G2 (32 words,
// 6 outputs).  Returns cudaGetLastError().
extern "C" int oz_scan_mixed(int group, int write_prefix, const void* packed,
                             const void* idx2, long long sb, long long sr,
                             long long sl, int batch, int rows, int lanes,
                             const unsigned long long* out, void* stream) {
  if (batch <= 0 || lanes <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (group == 1)
    return write_prefix
               ? launch<G1Coord, MixedStep, true>(packed, idx2, sb, sr, sl,
                                                  batch, rows, lanes, out, s)
               : launch<G1Coord, MixedStep, false>(packed, idx2, sb, sr, sl,
                                                   batch, rows, lanes, out, s);
  return write_prefix
             ? launch<G2Coord, MixedStep, true>(packed, idx2, sb, sr, sl,
                                                batch, rows, lanes, out, s)
             : launch<G2Coord, MixedStep, false>(packed, idx2, sb, sr, sl,
                                                 batch, rows, lanes, out, s);
}

// (h): group 1 = G1 (point rows of 24 words, 3 outputs), 2 = G2 (48 words,
// 6 outputs); ``idx`` holds point indices; every prefix is written.
// Returns cudaGetLastError().
extern "C" int oz_scan_full(int group, const void* point_rows,
                            const void* idx, long long sb, long long sr,
                            long long sl, int batch, int rows, int lanes,
                            const unsigned long long* out, void* stream) {
  if (batch <= 0 || lanes <= 0 || rows <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (group == 1)
    return launch<G1Coord, FullStep, true>(point_rows, idx, sb, sr, sl, batch,
                                           rows, lanes, out, s);
  return launch<G2Coord, FullStep, true>(point_rows, idx, sb, sr, sl, batch,
                                         rows, lanes, out, s);
}
