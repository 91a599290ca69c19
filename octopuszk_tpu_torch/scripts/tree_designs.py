"""Designs of two kernels of family (d), timed side by side on the card:
the pairwise tree of ``kernels.tree_sum`` and the batched add of
``kernels.add_points``.

Each design is a kernel over the headers of ``csrc/`` (``rcb.cuh``'s one
thread a point and two threads a point, ``lanes.cuh``'s field elements
spread over the eight lanes of a group of a warp), built here with nvcc
into ``build/`` from the sources below for each curve named (one nvcc a
design and curve, all started together), run at the main path's shapes
(queries of 2^21 rows: the tree over 15 rows of 2,048 lane totals, the
add over [15 windows, 65,537 buckets]) and compared word for word with
the plain version before it is timed.

    python -m octopuszk_tpu_torch.scripts.tree_designs [bn254a] [bn254b]

Tree designs (each keeps tree_sum's adds, operands and order):
  ``grid_thread``  the levels one after the other, each add on one thread,
                   the levels meeting at a grid-wide barrier of a
                   cooperative launch (the design before subtrees);
  ``grid_pair``    the same levels, each add on two threads (pt_add_pair);
  ``block_pair_<k>``  subtrees of 2^k leaves on blocks of 2^k threads, each
                   add on a pair, the roots of a row's subtrees added by
                   the last of its blocks to finish (rcb.cuh
                   tree_sum_block), k = 5, 6, 7 (the library's is 8);
  ``block_warp_<k>``  the same, the tiers past the first with each add on
                   one warp (lanes.cuh pt_add, a product's words over 8
                   lanes, four products at once), k = 7, 8;
  ``block_hybrid_<k>``  the same, every level of at most as many adds as
                   the block has warps on warps, k = 7, 8;
and the library's kernel beside them, each launch timed on the device
(its buffers made before, each launch its own zeroed counts); then the
library's wrapper (``kernels.tree_sum``, its host time included) at the
main path's shape and at the other callers' (one row of 1,024 or 1,000;
short rows; large batches of short rows; long rows; n = 1), each
compared with the plain version.

Add designs (G1 and G2), timed on the device:
  ``thread``       one thread a point, pt_add (the design before pairs);
  ``thread_lean``  one thread a point, pt_add's products in the order that
                   keeps the fewest coordinates alive;
  ``pair_both``    two threads a point, both loading both points (rcb.cuh
                   add_point_pair), blocks of 128;
  ``pair_both_64``, ``pair_both_32``  the same in blocks of 64 or 32;
  ``pair_both_3_blocks``  the same, at most 168 registers (three blocks of
                   128 an SM);
  ``pair_split``   two threads a point, each loading one point and trading
                   it by shuffles;
and the library's kernel beside them.

Prints one JSON line per design, curve and group (ms per launch by CUDA
events over 20 launches after two warm-up launches, ``timed`` "device"
or "wrapper"; ptxas registers and spills), then the card's name and
power limit.  Needs the card and raises without one, or if a design's
words differ from the plain version's (after every design has run).
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import hashlib
import json
import subprocess
import sys

import torch

from octopuszk_tpu_torch.ops import kernels
from octopuszk_tpu_torch.scripts.chain_designs import (
    _equal, _flat, _launch, _ptxas, _rand_point, _rebuild, _time_ms)
from octopuszk_tpu_torch.utils import device as _device

PRELUDE = r"""
#include <cuda_runtime.h>
#include "grid.cuh"
#include "lanes.cuh"
#include "curve.cuh"
namespace {
constexpr int kT = 128;
}
"""

# one tree design per source: oz_tree(group, p, scratch, batch, n, out,
# count, stream), count zeroed: batch * ceil(n / 2) words
TREES = {
    "grid_thread": r"""
// the parent's loop (rcb.cuh tree_sum_rows before subtrees)
template <class C>
__device__ __forceinline__ Pt<C> tree_node(const PointPtrs& src,
                                           size_t stride, size_t at,
                                           size_t n, size_t j, size_t h) {
  const Pt<C> a = load_point<C>(src, stride, at + j);
  const Pt<C> b = j + h < n ? load_point<C>(src, stride, at + j + h)
                            : pt_identity<C>();
  return pt_add(a, b);
}
template <class C>
__global__ void __launch_bounds__(kT)
k(PointPtrs in, PointPtrs scratch, PointPtrs out, size_t batch, size_t n,
  unsigned* count) {
  levels::GridSched sched{count, 0u};
  const size_t stride = batch * n;
  const int L = ceil_log2(n);
  if (L == 0) {
    const ItemRange it = sched.range(batch, 1);
    for (size_t i = it.first; i < it.end; i += it.step)
      store_point(load_point<C>(in, stride, i * n), out, batch, i);
    return;
  }
#pragma unroll 1
  for (int l = 0; l < L; l++) {
    const size_t h = (size_t)1 << l;
    const size_t nodes = (n + 2 * h - 1) / (2 * h);
    const bool last = l + 1 == L;
    const PointPtrs& src = l == 0 ? in : scratch;
    const ItemRange it = sched.range(batch, nodes);
#pragma unroll 1
    for (size_t i = it.first; i < it.end; i += it.step) {
      const size_t b = i / nodes, j = 2 * h * (i - b * nodes);
      const Pt<C> node = tree_node<C>(src, stride, b * n, n, j, h);
      if (last) store_point(node, out, batch, b);
      else store_point(node, scratch, stride, b * n + j);
    }
    if (!last) sched.barrier();
  }
}
template <class C>
static int launch(PointPtrs in, PointPtrs sc, PointPtrs out, size_t batch,
                  size_t n, unsigned* count, cudaStream_t s) {
  return levels::launch_levels(k<C>, batch * ((n + 1) / 2), in, sc, out,
                               batch, n, count, s);
}
""",
    "grid_pair": r"""
// the parent's levels, each add on a pair; a warp's pairs take items
// together (the loop's bound is the warp's first item), a pair past the
// level's items repeats its last and stores nothing
template <class C>
__global__ void __launch_bounds__(kT)
k(PointPtrs in, PointPtrs scratch, PointPtrs out, size_t batch, size_t n,
  unsigned* count) {
  levels::GridSched sched{count, 0u};
  const size_t stride = batch * n;
  const int L = ceil_log2(n);
  const size_t t = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t pairs = ((size_t)gridDim.x * blockDim.x) >> 1;
  const bool h = t & 1;
  if (L == 0) {
    for (size_t i = t; i < batch; i += 2 * pairs)
      store_point(load_point<C>(in, stride, i * n), out, batch, i);
    return;
  }
#pragma unroll 1
  for (int l = 0; l < L; l++) {
    const size_t hh = (size_t)1 << l;
    const size_t nodes = (n + 2 * hh - 1) / (2 * hh), items = batch * nodes;
    const bool last = l + 1 == L;
    const PointPtrs& src = l == 0 ? in : scratch;
#pragma unroll 1
    for (size_t it = t >> 1; (it & ~(size_t)15) < items; it += pairs) {
      const bool live = it < items;
      const size_t i = live ? it : items - 1;
      const size_t b = i / nodes, j = 2 * hh * (i - b * nodes);
      const Pt<C> a = load_point<C, true>(src, stride, b * n + j);
      const Pt<C> c = j + hh < n ? load_point<C, true>(src, stride,
                                                       b * n + j + hh)
                                 : pt_identity<C>();
      const Pt<C> r = pt_add_pair<C, ShflPair>(a, c, h);
      if (live && !h) {
        if (last) store_point(r, out, batch, b);
        else store_point(r, scratch, stride, b * n + j);
      }
    }
    if (!last) sched.barrier();
  }
}
template <class C>
static int launch(PointPtrs in, PointPtrs sc, PointPtrs out, size_t batch,
                  size_t n, unsigned* count, cudaStream_t s) {
  return levels::launch_levels(k<C>, 2 * batch * ((n + 1) / 2), in, sc, out,
                               batch, n, count, s);
}
""",
}

# subtrees of 2^K leaves, the library's loop at another K
BLOCK_PAIR = r"""
template <class C>
__global__ void __launch_bounds__(1 << KLOG)
k(PointPtrs in, PointPtrs scratch, PointPtrs out, size_t batch, size_t n,
  unsigned* count) {
  constexpr int kComps = 3 * (int)(sizeof(C) / 32);
  constexpr int kSlots = 1 << (KLOG - 1);
  __shared__ uint32_t smem[kComps * 8 * kSlots];
  __shared__ unsigned flag;
  PointPtrs slots;
#pragma unroll
  for (int c = 0; c < 6; c++)
    slots.c[c] = c < kComps ? smem + c * 8 * kSlots : nullptr;
  TreeBlock sched{&flag};
  tree_sum_block<C, ShflPair, KLOG>(in, scratch, out, batch, n, blockIdx.x,
                                    threadIdx.x, slots, count, sched);
}
template <class C>
static int launch(PointPtrs in, PointPtrs sc, PointPtrs out, size_t batch,
                  size_t n, unsigned* count, cudaStream_t s) {
  const TreeShape sh = tree_shape<KLOG>(batch, n);
  k<C><<<(unsigned)sh.blocks, 1 << KLOG, 0, s>>>(in, sc, out, batch, n,
                                                 count);
  return (int)cudaGetLastError();
}
"""
for _k in (5, 6, 7):
    TREES[f"block_pair_{_k}"] = f"#define KLOG {_k}\n" + BLOCK_PAIR

# subtrees of 2^KLOG leaves as the library's; MODE 0: the tiers past the
# first with each add on one warp (lanes.cuh pt_add); MODE 1: every level
# of at most as many adds as the block has warps on warps, the others on
# pairs (where a block holds one group)
BLOCK_MIX = r"""
// lanes.cuh's warp reading words another block wrote through L2
struct WarpLanesL2 : lanes::WarpLanes {
  static __device__ __forceinline__ U32 load(const uint32_t* base,
                                             size_t stride, size_t i, U32 k) {
    return __ldcg(base + (size_t)k * stride + i);
  }
};
template <class S>
__device__ __noinline__ Pt<S> warp_add(Pt<S> a, Pt<S> b) {
  return lanes::pt_add(a, b);
}
// level m of a tier on the block's warps, one add a warp, the nodes as in
// rcb.cuh tree_pair_level (slot i / 2, the root in slot 0)
template <class C>
__device__ __forceinline__ void warp_level(const PointPtrs& src,
                                           size_t stride, size_t at,
                                           size_t n, size_t base, size_t u,
                                           int levels, int m,
                                           const PointPtrs& slots,
                                           size_t nslots) {
  typedef typename lanes::Spread<C, lanes::WarpLanes>::type S;
  typedef typename lanes::Spread<C, WarpLanesL2>::type S2;
  const unsigned w = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const size_t count = (n - base + u - 1) / u;
  const size_t adds = (size_t)1 << (levels - 1 - m);
#pragma unroll 1
  for (size_t a = w; a < adds; a += warps) {
    const size_t i = a << (m + 1), j = i + ((size_t)1 << m);
    if (i >= count) continue;
    Pt<S> x, y;
    if (m == 0) {
      const Pt<S2> x2 = lanes::load_point<S2>(src, stride, at + base + i * u);
      x = *reinterpret_cast<const Pt<S>*>(&x2);
    } else {
      x = lanes::load_point<S>(slots, nslots, i >> 1);
    }
    if (j < count) {
      if (m == 0) {
        const Pt<S2> y2 = lanes::load_point<S2>(src, stride,
                                                at + base + j * u);
        y = *reinterpret_cast<const Pt<S>*>(&y2);
      } else {
        y = lanes::load_point<S>(slots, nslots, j >> 1);
      }
    } else {
      lanes::coord_zero(y.x);
      lanes::coord_one(y.y);
      lanes::coord_zero(y.z);
    }
    lanes::store_point(warp_add<S>(x, y), slots, nslots, i >> 1);
  }
}
template <class C, int K>
__device__ __forceinline__ void tree_block_mix(
    const PointPtrs& in, const PointPtrs& scratch, const PointPtrs& out,
    size_t batch, size_t n, unsigned* count, const PointPtrs& slots,
    TreeBlock& sched) {
  const size_t blk = blockIdx.x;
  const unsigned t = threadIdx.x, warps = blockDim.x >> 5;
  const TreeShape s = tree_shape<K>(batch, n);
  const size_t stride = batch * n, nslots = (size_t)1 << (K - 1);
  if (s.levels == 0) {
    const size_t row = (blk << K) + t;
    if (row < batch)
      store_point(load_point<C>(in, batch, row), out, batch, row);
    return;
  }
  const unsigned lt = t & ((1u << s.first) - 1);
  const size_t total = batch * s.groups;
  size_t sub = blk * s.per_block + (t >> s.first);
  const bool live = sub < total;
  if (!live) sub = total - 1;
  const size_t b = sub / s.groups;
  const size_t slot0 = (size_t)(t >> s.first) << (s.first - 1);
  size_t g = sub - b * s.groups, u = 1, counted = 0;
#pragma unroll 1
  for (int done = 0;; done += K) {
    const int levels = s.levels - done < K ? s.levels - done : K;
    const size_t base = g * (u << K);
    const PointPtrs& src = done ? scratch : in;
#pragma unroll 1
    for (int m = 0; m < levels; m++) {
      const size_t adds = (size_t)1 << (levels - 1 - m);
      const bool on_warps = s.per_block == 1 &&
                            (MODE == 0 ? done > 0 : adds <= warps);
      if (on_warps)
        warp_level<C>(src, stride, b * n, n, base, u, levels, m, slots,
                      nslots);
      else
        tree_pair_level<C, ShflPair>(src, stride, b * n, n, base, u, levels,
                                     m, lt, slots, nslots, slot0);
      __syncthreads();
    }
    if (done + levels == s.levels) {
      if (live && lt == 0)
        store_point(load_point<C>(slots, nslots, slot0), out, batch, b);
      return;
    }
    if (t == 0)
      store_point(load_point<C>(slots, nslots, 0), scratch, stride,
                  b * n + base);
    const size_t groups = (n + (u << K) - 1) / (u << K);
    const size_t parent = g >> K;
    const size_t sibs = groups - (parent << K);
    if (!sched.arrive(count + (counted + parent) * batch + b,
                      (unsigned)(sibs < ((size_t)1 << K) ? sibs
                                                         : (size_t)1 << K)))
      return;
    counted += (groups + ((size_t)1 << K) - 1) >> K;
    g = parent;
    u <<= K;
  }
}
template <class C>
__global__ void __launch_bounds__(1 << KLOG)
k(PointPtrs in, PointPtrs scratch, PointPtrs out, size_t batch, size_t n,
  unsigned* count) {
  constexpr int kComps = 3 * (int)(sizeof(C) / 32);
  constexpr int kSlots = 1 << (KLOG - 1);
  __shared__ uint32_t smem[kComps * 8 * kSlots];
  __shared__ unsigned flag;
  PointPtrs slots;
#pragma unroll
  for (int c = 0; c < 6; c++)
    slots.c[c] = c < kComps ? smem + c * 8 * kSlots : nullptr;
  TreeBlock sched{&flag};
  tree_block_mix<C, KLOG>(in, scratch, out, batch, n, count, slots, sched);
}
template <class C>
static int launch(PointPtrs in, PointPtrs sc, PointPtrs out, size_t batch,
                  size_t n, unsigned* count, cudaStream_t s) {
  const TreeShape sh = tree_shape<KLOG>(batch, n);
  k<C><<<(unsigned)sh.blocks, 1 << KLOG, 0, s>>>(in, sc, out, batch, n,
                                                 count);
  return (int)cudaGetLastError();
}
"""
for _k in (7, 8):
    TREES[f"block_warp_{_k}"] = f"#define KLOG {_k}\n#define MODE 0\n" + BLOCK_MIX
    TREES[f"block_hybrid_{_k}"] = (f"#define KLOG {_k}\n#define MODE 1\n"
                                   + BLOCK_MIX)

TREE_ENTRY = r"""
extern "C" int oz_tree(int group, const unsigned long long* p,
                       const unsigned long long* scratch, long long batch,
                       long long n, const unsigned long long* out,
                       void* count, void* stream) {
  const int cnt = 3 * group;
  cudaStream_t s = (cudaStream_t)stream;
  if (group == 1)
    return launch<G1Coord>(make_ptrs(p, cnt), make_ptrs(scratch, cnt),
                           make_ptrs(out, cnt), batch, n, (unsigned*)count, s);
  return launch<G2Coord>(make_ptrs(p, cnt), make_ptrs(scratch, cnt),
                         make_ptrs(out, cnt), batch, n, (unsigned*)count, s);
}
"""

# one add design per source: oz_add(group, p, q, out, n, stream)
ADDS = {
    "thread": r"""
template <class C>
__global__ void __launch_bounds__(kT)
k(PointPtrs p, PointPtrs q, PointPtrs out, size_t n) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  store_point(pt_add(load_point<C>(p, n, i), load_point<C>(q, n, i)), out,
              n, i);
}
#define THREADS_PER_POINT 1
""",
    "thread_lean": r"""
// pt_add's products and sums of the same operands, each coordinate loaded
// just before its first use and each product made as soon as its
// operands exist, so that the inputs die early: X1 X2, Y1 Y2 and their
// cross term; Z1 Z2; the two cross terms with Z (the inputs then dead);
// then the products by b3 and the output products two by two
template <class C>
__device__ __forceinline__ Pt<C> pt_add_lean(const PointPtrs& pp,
                                             const PointPtrs& qq, size_t n,
                                             size_t i) {
  C px, qx, py, qy, pz, qz;
  load_coord(px, pp, 0, n, i);
  load_coord(qx, qq, 0, n, i);
  const C t0 = mul(px, qx);
  load_coord(py, pp, 1, n, i);
  load_coord(qy, qq, 1, n, i);
  const C t1 = mul(py, qy);
  const C t3 = sub(mul(add(px, py), add(qx, qy)), add(t0, t1));
  load_coord(pz, pp, 2, n, i);
  load_coord(qz, qq, 2, n, i);
  const C t2 = mul(pz, qz);
  const C t5 = sub(mul(add(px, pz), add(qx, qz)), add(t0, t2));
  const C t4 = sub(mul(add(py, pz), add(qy, qz)), add(t1, t2));
  const C three_t0 = add(dbl(t0), t0);
  const C b3t2 = mul_b3(t2);
  const C z3 = add(t1, b3t2);
  const C t1m = sub(t1, b3t2);
  const C y3 = mul_b3(t5);
  Pt<C> r;
  r.x = sub(mul(t3, t1m), mul(t4, y3));
  r.y = add(mul(y3, three_t0), mul(t1m, z3));
  r.z = add(mul(z3, t4), mul(three_t0, t3));
  return r;
}
template <class C>
__global__ void __launch_bounds__(kT)
k(PointPtrs p, PointPtrs q, PointPtrs out, size_t n) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  store_point(pt_add_lean<C>(p, q, n, i), out, n, i);
}
#define THREADS_PER_POINT 1
""",
    "pair_both": r"""
template <class C>
__global__ void __launch_bounds__(kT)
k(PointPtrs p, PointPtrs q, PointPtrs out, size_t n) {
  const size_t t = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if ((t & ~(size_t)31) >> 1 >= n) return;
  add_point_pair<C, ShflPair>(p, q, out, n, t);
}
#define THREADS_PER_POINT 2
""",
    "pair_split": r"""
template <class C>
__device__ __forceinline__ C trade(const C& mine) {
  return ShflPair::other(mine);
}
template <class C>
__global__ void __launch_bounds__(kT)
k(PointPtrs p, PointPtrs q, PointPtrs out, size_t n) {
  const size_t t = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if ((t & ~(size_t)31) >> 1 >= n) return;
  const bool h = t & 1, live = (t >> 1) < n;
  const size_t i = live ? t >> 1 : n - 1;
  const Pt<C> mine = load_point<C>(h ? q : p, n, i);
  const Pt<C> theirs = {trade(mine.x), trade(mine.y), trade(mine.z)};
  const Pt<C> a = {choose(h, theirs.x, mine.x), choose(h, theirs.y, mine.y),
                   choose(h, theirs.z, mine.z)};
  const Pt<C> b = {choose(h, mine.x, theirs.x), choose(h, mine.y, theirs.y),
                   choose(h, mine.z, theirs.z)};
  const Pt<C> r = pt_add_pair<C, ShflPair>(a, b, h);
  if (!live) return;
  if (h) {
    store_coord(r.y, out, 1, n, i);
  } else {
    store_coord(r.x, out, 0, n, i);
    store_coord(r.z, out, 2, n, i);
  }
}
#define THREADS_PER_POINT 2
""",
}

# the pair with other blocks: 64 or 32 threads (more warps an SM at 180
# registers), or 128 with at most 168 registers (three blocks an SM)
PAIR_BLOCK = r"""
template <class C>
__global__ void __launch_bounds__(BLOCK, MIN_BLOCKS)
k(PointPtrs p, PointPtrs q, PointPtrs out, size_t n) {
  const size_t t = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if ((t & ~(size_t)31) >> 1 >= n) return;
  add_point_pair<C, ShflPair>(p, q, out, n, t);
}
#define THREADS_PER_POINT 2
"""
for _name, _b, _m in (("pair_both_64", 64, 1), ("pair_both_32", 32, 1),
                      ("pair_both_3_blocks", 128, 3)):
    ADDS[_name] = f"#define BLOCK {_b}\n#define MIN_BLOCKS {_m}\n" + PAIR_BLOCK

ADD_ENTRY = r"""
#ifndef BLOCK
#define BLOCK kT
#endif
template <class C>
static int launch(PointPtrs p, PointPtrs q, PointPtrs out, size_t n,
                  cudaStream_t s) {
  const size_t threads = n * THREADS_PER_POINT;
  k<C><<<(unsigned)((threads + BLOCK - 1) / BLOCK), BLOCK, 0, s>>>(p, q, out,
                                                                  n);
  return (int)cudaGetLastError();
}
extern "C" int oz_add(int group, const unsigned long long* p,
                      const unsigned long long* q,
                      const unsigned long long* out, long long n,
                      void* stream) {
  const int cnt = 3 * group;
  cudaStream_t s = (cudaStream_t)stream;
  if (group == 1)
    return launch<G1Coord>(make_ptrs(p, cnt), make_ptrs(q, cnt),
                           make_ptrs(out, cnt), n, s);
  return launch<G2Coord>(make_ptrs(p, cnt), make_ptrs(q, cnt),
                         make_ptrs(out, cnt), n, s);
}
"""

# the library's tree at its other callers' shapes [batch, n]: msm_naive's
# one row, dmsm's short rows, large batches of short rows, one long row,
# n = 1 (a copy), n not a power of two
CALLER_SHAPES = ((1, 1024), (1, 1000), (4, 3), (15, 4), (4096, 5),
                 (1000, 1), (1, 1 << 15), (3, (1 << 14) + 5), (2, 2))


def _sources(only=None):
    out = {f"tree_{k}": PRELUDE + v + TREE_ENTRY for k, v in TREES.items()}
    out.update({f"add_{k}": PRELUDE + v + ADD_ENTRY
                for k, v in ADDS.items()})
    return {k: v for k, v in out.items() if only is None or k in only}


def build(curves, only=None) -> dict:
    """Each design's shared library per curve ((curve, name) -> (ctypes
    function, ptxas lines)), one nvcc each, all started together."""
    srcs = _sources(only)
    consts = kernels.constants_header()
    h = hashlib.sha256(consts.encode())
    for name in kernels.HEADERS:
        h.update((kernels.CSRC / name).read_bytes())
    for name in sorted(srcs):
        h.update(srcs[name].encode())
    out_dir = kernels.BUILD_ROOT / f"tree-designs-{h.hexdigest()[:16]}"
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "constants.cuh").write_text(consts)
    nvcc = kernels._nvcc()

    def one(job):
        curve, name = job
        cu = out_dir / f"{name}.cu"
        so = out_dir / f"lib{name}-{curve}.so"
        r = subprocess.run([nvcc, *kernels.NVCC_FLAGS,
                            *kernels.LIBRARIES[curve].defs, "-shared", "-I",
                            str(kernels.CSRC), "-I", str(out_dir), str(cu),
                            "-o", str(so)], capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name} ({curve}):\n"
                               f"{r.stderr}")
        return curve, name, so, r.stdout + r.stderr

    for name in srcs:
        (out_dir / f"{name}.cu").write_text(srcs[name])
    jobs = [(c, n) for c in curves for n in sorted(srcs)]
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        built = list(pool.map(one, jobs))
    libs = {}
    vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    addrs = ctypes.POINTER(ctypes.c_ulonglong)
    for curve, name, so, log in built:
        lib = ctypes.CDLL(str(so))
        if name.startswith("tree_"):
            fn = lib.oz_tree
            fn.argtypes = [ci, addrs, addrs, ll, ll, addrs, vp, vp]
        else:
            fn = lib.oz_add
            fn.argtypes = [ci, addrs, addrs, addrs, ll, vp]
        fn.restype = ctypes.c_int
        libs[curve, name] = (fn, _ptxas(log))
    return libs


def _device_ms(launch, dev, reps: int = 20) -> float:
    """ms a launch on the device: ``launch(k)`` issues launch k (k < reps +
    2) on buffers made before, two warm-up launches, then CUDA events
    around ``reps`` (the host's ctypes call, some microseconds, overlaps
    the launch before it)."""
    launch(0)
    launch(1)
    torch.cuda.synchronize(dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for k in range(reps):
        launch(2 + k)
    end.record()
    torch.cuda.synchronize(dev)
    return start.elapsed_time(end) / reps


def _tree_rows(libs, curve, g, cd, tot, batch, n, dev, reps=20):
    """The tree designs and the library's kernel on the points ``tot``
    [batch, n]: (name, device ms, output) per design; each launch gets
    its own zeroed counts (a design's grid barrier or arrivals)."""
    words = batch * ((n + 1) // 2)
    outs = [torch.empty((8, batch), dtype=torch.int32, device=dev)
            for _ in tot]
    scratch = [torch.empty_like(t) for t in tot]
    a_in, a_sc, a_out = (kernels._addr_array(x) for x in (tot, scratch, outs))
    lib_fn = kernels._group_entry(g, "oz_tree_sum")[0]
    designs = [(nm[5:], f) for (c, nm), (f, _) in libs.items()
               if c == curve and nm.startswith("tree_")]
    rows = []
    for name, fn in designs + [("library", lib_fn)]:
        counts = [torch.zeros(words, dtype=torch.int32, device=dev)
                  for _ in range(reps + 2)]
        ms = _device_ms(lambda k, fn=fn: _launch(
            fn, dev, cd, a_in, a_sc, batch, n, a_out, counts[k].data_ptr()),
            dev, reps)
        rows.append((name, ms, [o.clone() for o in outs]))
    return rows


def main(curves=("bn254a",), only=None, num_win: int = 15,
         width: int = 2048, nb: int = (1 << 16) + 1) -> list:
    dev = _device.resolve(None)
    libs = build(curves, only)
    gen = torch.Generator(device=dev).manual_seed(14)
    results, failed = [], []

    def rec(obj):
        results.append(obj)
        print(json.dumps(obj), flush=True)

    for curve in curves:
        cv = kernels.LIBRARIES[curve].bundle()
        for cd, g in ((1, cv.g1.name), (2, cv.g2.name)):
            # the tree at the main path's shape: each design's kernel on
            # the device, then the library's wrapper (its host time too)
            tot = _rand_point(gen, cd, (num_win, width), dev)
            want = _flat(kernels.tree_sum_plain(g, _rebuild(tot, cd)))
            for name, ms, got in _tree_rows(libs, curve, g, cd, tot,
                                             num_win, width, dev):
                ok = _equal(got, want)
                rec({"design": f"tree_sum {name}", "curve": curve,
                     "group": g, "shape": [num_win, width], "ms": ms,
                     "timed": "device", "equal": ok,
                     "ptxas": libs.get((curve, f"tree_{name}"),
                                       (None, None))[1]})
                if not ok:
                    failed.append(f"tree_sum {name} {g}")
            ms, got = _time_ms(lambda: _flat(kernels.tree_sum(
                g, _rebuild(tot, cd))), dev, 20)
            ok = _equal(got, want)
            rec({"design": "tree_sum library", "curve": curve, "group": g,
                 "shape": [num_win, width], "ms": ms, "timed": "wrapper",
                 "equal": ok, "ptxas": None})
            if not ok:
                failed.append(f"tree_sum library wrapper {g}")
            del tot, want
            # the library's tree at the other callers' shapes
            for batch, n in CALLER_SHAPES:
                pts = _rand_point(gen, cd, (batch, n), dev)
                want = _flat(kernels.tree_sum_plain(g, _rebuild(pts, cd)))
                ms, got = _time_ms(lambda: _flat(kernels.tree_sum(
                    g, _rebuild(pts, cd))), dev, 20)
                ok = _equal(got, want)
                rec({"design": "tree_sum library", "curve": curve,
                     "group": g, "shape": [batch, n], "ms": ms,
                     "timed": "wrapper", "equal": ok, "ptxas": None})
                if not ok:
                    failed.append(f"tree_sum library {g} {[batch, n]}")
                del pts, want
            # the add at the bucket phase's shape, on the device
            p = _rand_point(gen, cd, (num_win, nb), dev)
            q = _rand_point(gen, cd, (num_win, nb), dev)
            want = _flat(kernels.add_points_plain(g, _rebuild(p, cd),
                                                  _rebuild(q, cd)))
            outs = [torch.empty_like(t) for t in p]
            a_p, a_q, a_out = (kernels._addr_array(x) for x in (p, q, outs))
            designs = [(nm[4:], f) for (c, nm), (f, _) in libs.items()
                       if c == curve and nm.startswith("add_")]
            lib_fn = kernels._group_entry(g, "oz_add_points")[0]
            for name, fn in designs + [("library", lib_fn)]:
                for o in outs:
                    o.zero_()
                ms = _device_ms(lambda k, fn=fn: _launch(
                    fn, dev, cd, a_p, a_q, a_out, num_win * nb), dev)
                ok = _equal(outs, want)
                rec({"design": f"add_points {name}", "curve": curve,
                     "group": g, "shape": [num_win, nb], "ms": ms,
                     "timed": "device", "equal": ok,
                     "ptxas": libs.get((curve, f"add_{name}"),
                                       (None, None))[1]})
                if not ok:
                    failed.append(f"add_points {name} {g}")
            del p, q, want, outs
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    if failed:
        raise AssertionError(f"differ from the plain version: {failed}")
    return results


if __name__ == "__main__":
    main(tuple(sys.argv[1:]) or ("bn254a",))
    sys.exit(0)
