// Levels of a reduction separated inside one launch (table_kernels.cu;
// the grid-barrier designs of scripts/tree_designs.py and
// scripts/prefix_designs.py): a barrier across the blocks of a
// cooperative launch, the schedules that hand each thread its items of a
// level, and the launch.  Device code of the CUDA toolchain only (the loops they drive
// are in rcb.cuh, which also compiles for the host).
#pragma once
#include <cuda_runtime.h>
#include "rcb.cuh"

namespace levels {

constexpr int kThreads = 128;

// A barrier across the blocks of a cooperative launch (all resident):
// each block adds one to ``count`` and waits until the count reaches this
// barrier's target; the count only grows, so one zeroed word serves every
// barrier of a launch.
__device__ __forceinline__ void grid_barrier(unsigned* count,
                                             unsigned& target) {
  target += gridDim.x;
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(count, 1u);
    while (*(volatile unsigned*)count < target) {
    }
    __threadfence();
  }
  __syncthreads();
}

// How the threads of a cooperative launch share a level's items (rows x
// per_row): every block takes every grid-stride item in turn; the levels
// meet at grid_barrier.  Work kept on one block: the block's share of n
// items (``blocks``), a thread's share of the block's (``threads``), and
// the block's barrier (``sync``).
struct GridSched {
  unsigned* count;
  unsigned target;
  __device__ ItemRange range(size_t rows, size_t per_row) const {
    return {(size_t)blockIdx.x * blockDim.x + threadIdx.x,
            (size_t)gridDim.x * blockDim.x, rows * per_row};
  }
  __device__ void barrier() { grid_barrier(count, target); }
  __device__ ItemRange blocks(size_t n) const {
    return {blockIdx.x, gridDim.x, n};
  }
  __device__ ItemRange threads(size_t n) const {
    return {threadIdx.x, blockDim.x, n};
  }
  __device__ void sync() const { __syncthreads(); }
};

// A cooperative launch of ``kernel`` with as many blocks as the level's
// largest item count needs and the card can hold at once.  The card is the
// current device, which ops/kernels.py sets to the operands' card for the
// call, so the grid is sized for the card the launch runs on.
template <class K>
int launch_cooperative(K kernel, size_t items, void** args, cudaStream_t s) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, 0);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  size_t blocks = (items + kThreads - 1) / kThreads;
  if (blocks > (size_t)sms * per_sm) blocks = (size_t)sms * per_sm;
  if (blocks < 1) blocks = 1;
  e = cudaLaunchCooperativeKernel((const void*)kernel, dim3((unsigned)blocks),
                                  dim3(kThreads), args, 0, s);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The designs' levels: kernel(in, scratch, out, batch, n, count) as a
// cooperative launch over the card.
template <class K>
int launch_levels(K kernel, size_t items, PointPtrs in, PointPtrs scratch,
                  PointPtrs out, size_t batch, size_t n, unsigned* count,
                  cudaStream_t s) {
  void* args[] = {&in, &scratch, &out, &batch, &n, &count};
  return launch_cooperative(kernel, items, args, s);
}

}  // namespace levels
