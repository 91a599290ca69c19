// Row gather: (i) row_gather, out[j, :] = table[idx[j], :].
//
// It replaces the TPU kernel scripts/gather_experiment.py::_pallas_gather,
// where a scalar-prefetch operand carries the row indices ahead of the grid
// and each grid step's BlockSpec index map DMAs the G rows it names into
// one output block.  On this card a thread loads its own index: one thread
// copies one 16-byte chunk of one row, so thread t serves row j = t / (W/4)
// and chunk k = t % (W/4), and the threads of a row are neighbours.  A
// 512-byte row (W = 128) is one warp's coalesced read; a 64-byte row
// (W = 16, one G1 point) is a quarter warp's.  Each index is read by the
// W/4 threads of its row (one cached line between them).
//
// An index outside [0, rows) is an error and is never clamped or skipped:
// the thread that meets it traps, which aborts the launch, and the fault is
// raised by the next synchronisation with the card (the convention of
// PyTorch's own device-side index checks).  Offsets are 64-bit.
//
// Bound on this card: device memory bytes (each row read once and written
// once, plus the index), with no arithmetic to speak of.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void row_gather_kernel(const int4* __restrict__ table,
                                  long long rows,
                                  const int* __restrict__ idx, long long m,
                                  int chunks, int4* __restrict__ out) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= m * chunks) return;
  const long long j = t / chunks;
  const long long k = t - j * chunks;
  const int r = __ldg(idx + j);
  if (r < 0 || r >= rows) __trap();
  out[t] = __ldg(table + (long long)r * chunks + k);
}

}  // namespace

// table: int32[rows, width], 16-byte aligned and contiguous; idx: int32[m];
// out: int32[m, width].  width must be a positive multiple of 4.
extern "C" int oz_row_gather(const void* table, long long rows,
                             const void* idx, long long m, int width,
                             void* out, void* stream) {
  if (rows <= 0 || m <= 0 || width <= 0 || width % 4 != 0)
    return (int)cudaErrorInvalidValue;
  const int chunks = width / 4;
  const long long blocks = (m * chunks + kThreads - 1) / kThreads;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  row_gather_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int4*)table, rows, (const int*)idx, m, chunks, (int4*)out);
  return (int)cudaGetLastError();
}
