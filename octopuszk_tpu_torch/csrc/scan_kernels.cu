// Bucket-accumulation scans: (f) scan_accumulate_mixed (every prefix
// written) and (g) scan_accumulate_mixed_total (lane totals only), G1 and
// G2, one template with a WRITE_PREFIX flag.
//
// They replace the TPU kernels octopuszk_tpu/ops/pallas_ops.py::
// scan_accumulate_mixed (_scan_mixed_kernel) and ::scan_accumulate_mixed_total
// (_scan_mixed_total_kernel).  There the row axis is a sequential grid
// dimension and the running sum lives in scratch memory between grid steps.
// Blocks run in no order here, so one thread owns one lane, keeps the
// projective running sum to itself and loops over the rows.
//
// The row gather and the sign of ops/msm.py::_gather_packed are folded in:
// the kernel reads the packed base (one affine point per row of 16 or 32
// words, identity = all zero) through an index tensor whose entries are
// (point index << 1) | negate, so the gathered rows never exist in device
// memory.  A leading batch dimension carries all windows of a chunk in one
// launch, since 4,096 lanes alone would fill a few percent of the card.
//
// Bound on this card: integer multiply throughput (a mixed add is 11 field
// products and two mul_b3 per row, against 64 or 128 bytes read and, with
// prefixes, 96 or 192 bytes written).  A row whose Y is zero is the
// identity and leaves the running sum as it is.
#include <cuda_runtime.h>
#include "rcb.cuh"

namespace {

constexpr int kThreads = 128;

struct OutPtrs {
  uint32_t* c[6];
};

// 8 words of one coordinate component, contiguous in a packed row
__device__ __forceinline__ Fp<FqMod> load_row8(const uint32_t* row) {
  const uint4 lo = *reinterpret_cast<const uint4*>(row);
  const uint4 hi = *reinterpret_cast<const uint4*>(row + 4);
  Fp<FqMod> r;
  r.v[0] = lo.x; r.v[1] = lo.y; r.v[2] = lo.z; r.v[3] = lo.w;
  r.v[4] = hi.x; r.v[5] = hi.y; r.v[6] = hi.z; r.v[7] = hi.w;
  return r;
}

__device__ __forceinline__ void load_affine(const uint32_t* row, G1Coord& x,
                                            G1Coord& y) {
  x = load_row8(row);
  y = load_row8(row + 8);
}
__device__ __forceinline__ void load_affine(const uint32_t* row, G2Coord& x,
                                            G2Coord& y) {
  x.c0 = load_row8(row);
  x.c1 = load_row8(row + 8);
  y.c0 = load_row8(row + 16);
  y.c1 = load_row8(row + 24);
}

__device__ __forceinline__ void store_at(const G1Coord& c, const OutPtrs& o,
                                         int ci, size_t stride, size_t off) {
  fp_store<FqMod>(o.c[ci], stride, off, c);
}
__device__ __forceinline__ void store_at(const G2Coord& c, const OutPtrs& o,
                                         int ci, size_t stride, size_t off) {
  fp_store<FqMod>(o.c[2 * ci], stride, off, c.c0);
  fp_store<FqMod>(o.c[2 * ci + 1], stride, off, c.c1);
}

// One row's mixed add, kept out of line: with the formula inlined into the
// row loop, nvcc 12.9 (cicc at -O3) crashes on this file.  The running sum
// therefore passes through local memory (served by L1) once per row: about
// 40 words beside the roughly 3,000 multiply-adds of a G1 mixed add.
template <class C>
__device__ __noinline__ void mixed_step(Pt<C>& carry, const C& x, const C& y) {
  carry = pt_mixed_add(carry, x, y);
}

template <class C>
__device__ __forceinline__ void store_pt(const Pt<C>& p, const OutPtrs& o,
                                         size_t stride, size_t off) {
  store_at(p.x, o, 0, stride, off);
  store_at(p.y, o, 1, stride, off);
  store_at(p.z, o, 2, stride, off);
}

// idx2[b, r, l] is read at b * sb + r * sr + l * sl (element strides).
// Prefix output component: int32[8, batch, rows, lanes]; totals output:
// int32[8, batch, lanes].
template <class C, int ROW_WORDS, bool WRITE_PREFIX>
__global__ void __launch_bounds__(kThreads)
scan_kernel(const uint32_t* __restrict__ packed,
            const int32_t* __restrict__ idx2, long long sb, long long sr,
            long long sl, int batch, int rows, int lanes, OutPtrs out) {
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
  for (int r = 0; r < rows; r++) {
    const uint32_t e = (uint32_t)ix[(long long)r * sr];
    C x, y;
    load_affine(packed + (size_t)(e >> 1) * ROW_WORDS, x, y);
    if (!is_zero(y)) {
      if (e & 1u) y = neg(y);
      mixed_step(carry, x, y);
    }
    if (WRITE_PREFIX)
      store_pt(carry, out, stride, (b * rows + r) * lanes + l);
  }
  if (!WRITE_PREFIX) store_pt(carry, out, stride, b * lanes + l);
}

template <class C, int ROW_WORDS>
int launch(int write_prefix, const void* packed, const void* idx2,
           long long sb, long long sr, long long sl, int batch, int rows,
           int lanes, const unsigned long long* out, int count,
           cudaStream_t s) {
  OutPtrs o;
  for (int k = 0; k < 6; k++)
    o.c[k] = k < count ? (uint32_t*)(uintptr_t)out[k] : nullptr;
  const size_t total = (size_t)batch * lanes;
  const unsigned g = (unsigned)((total + kThreads - 1) / kThreads);
  if (write_prefix)
    scan_kernel<C, ROW_WORDS, true><<<g, kThreads, 0, s>>>(
        (const uint32_t*)packed, (const int32_t*)idx2, sb, sr, sl, batch,
        rows, lanes, o);
  else
    scan_kernel<C, ROW_WORDS, false><<<g, kThreads, 0, s>>>(
        (const uint32_t*)packed, (const int32_t*)idx2, sb, sr, sl, batch,
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
    return launch<G1Coord, 16>(write_prefix, packed, idx2, sb, sr, sl, batch,
                               rows, lanes, out, 3, s);
  return launch<G2Coord, 32>(write_prefix, packed, idx2, sb, sr, sl, batch,
                             rows, lanes, out, 6, s);
}
