// The two-phase prefix of rcb.cuh prefix_sum_item as a kernel and its
// launch, for any worker and block (prefix_kernels.cu builds the library's;
// scripts/prefix_designs.py others).  Device code of the CUDA toolchain
// only.
#pragma once
#include <cuda_runtime.h>
#include "rcb.cuh"

namespace {

// Blocks take items in order from a ticket (count[0]) until none is left;
// count[1 + b] counts row b's arrived tiles.  A phase-2 item waits only on
// tiles whose tickets came before its own, taken by blocks that are
// running and that wait on nothing: so no launch of any size deadlocks,
// and no cooperative launch is needed.
template <class C, int T, int BLOCK, int MINB, int S, bool ID>
__global__ void __launch_bounds__(BLOCK, MINB)
prefix_sum_kernel(PointPtrs in, PointPtrs out, PrefixShape s,
                  unsigned* count) {
  extern __shared__ uint32_t smem[];
  __shared__ unsigned ticket;
  PrefixBlock sched;
#pragma unroll 1
  for (;;) {
    if (threadIdx.x == 0) ticket = atomicAdd(count, 1u);
    __syncthreads();
    const unsigned item = ticket;
    if (item >= s.items) return;
    prefix_sum_item<C, ShflPair, T, S, ID>(in, out, s, item, threadIdx.x,
                                           BLOCK, smem, count + 1, sched);
    __syncthreads();
  }
}

// One launch over the [8, batch, n] batch ``in`` into ``out``: classes mod
// 2^m, T threads a worker, blocks of BLOCK threads, ROUNDS rounds of
// workers a tile's first level, two shared-memory buffers of S points (at
// least ROUNDS x workers + 1), phase 2's adds of the identity by
// pt_add_identity (ID), as many blocks as the card holds at once (or as
// there are items); ``count``: 1 + batch zeroed words.
template <class C, int T, int BLOCK, int MINB, int ROUNDS, int S,
          bool ID = true>
int launch_prefix(int m, PointPtrs in, PointPtrs out, size_t batch, size_t n,
                  unsigned* count, cudaStream_t st) {
  constexpr size_t kWorkers = BLOCK / T;
  static_assert(S >= ROUNDS * kWorkers + 1, "a tile and its halo");
  const size_t smem = 2 * S * sizeof(Pt<C>);
  auto kernel = prefix_sum_kernel<C, T, BLOCK, MINB, S, ID>;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, BLOCK,
                                                      smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const PrefixShape s = prefix_shape(batch, n, m, kWorkers, ROUNDS, S);
  size_t blocks = (size_t)sms * per_sm;
  if (blocks > s.items) blocks = s.items;
  prefix_sum_kernel<C, T, BLOCK, MINB, S, ID>
      <<<(unsigned)blocks, BLOCK, smem, st>>>(in, out, s, count);
  return (int)cudaGetLastError();
}

}  // namespace
