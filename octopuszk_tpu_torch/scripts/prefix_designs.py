"""Designs of ``kernels.prefix_sum`` (the Hillis-Steele prefix of kernel
(d)'s adds), timed side by side on the card.

Each design is a kernel over the headers of ``csrc/``, built here with
nvcc into ``build/`` from the sources below for each curve named (one nvcc
a design and curve, all started together), run at the main path's shape
(the lane totals of 15 windows x 4,096 lanes) and compared word for word
with the plain version before it is timed.

    python -m octopuszk_tpu_torch.scripts.prefix_designs [bn254a] [bn254b]

Designs (each makes the words of every add of the dataflow, the
identity's included, from the same operands in the same order):
  ``grid_thread``  the levels one after the other between two buffers,
                   each add on one thread, the levels meeting at a
                   grid-wide barrier of a cooperative launch (the design
                   before this script);
  ``grid_pair``    the same levels, each add on two threads (pt_add_pair);
  ``class_pair_<m>``  two phases (rcb.cuh prefix_sum_item, prefix.cuh):
                   levels 0 .. m - 1 on tiles of a row, each tile
                   recomputing the 2^m - 1 elements before it; then, after
                   one wait for the row's tiles, levels m .. L - 1 on each
                   residue class mod 2^m on one block; the levels between
                   two shared-memory buffers of 257 points; each add on a
                   pair, blocks of 256 threads, a pair taking a slot a
                   round, tiles of two rounds (m = 3 .. 6; 2^3 with
                   buffers of 513, so that its classes of 512 fit);
  ``class_pair_4_b128``  blocks of 128 threads (two G2 blocks an SM),
                   tiles of 4 rounds (the library's G2);
  ``class_thread_4_3blocks``  each add on one thread, blocks of 128
                   threads (three an SM on G1: at most 168 registers),
                   tiles of one round;
  ``*_id``         the same with phase 2's warps whose every add is of the
                   identity making (X Y, Y^2, Y Z) (rcb.cuh
                   pt_add_identity: 3 of 12 products, the same words);
                   ``class_thread_4_3blocks_id`` is the library's G1;
  ``class_thread_4_b256_id``  blocks of 256 (two G1 blocks an SM: at most
                   128 registers);
and the library's kernel beside them, each launch timed on the device
(its buffers made before, each launch its own zeroed counts); then the
library's wrapper (``kernels.prefix_sum``, its host time included) at the
main path's shape and at other callers' (the unpacked path's 19 windows,
small MSMs' 4 lanes, short rows, many short rows, n = 1, a row whose
classes exceed the shared memory), each compared with the plain version.

Prints one JSON line per design, curve and group (ms per launch by CUDA
events over 20 launches after two warm-up launches, ``timed`` "device" or
"wrapper"; ptxas registers and spills), then the card's name and power
limit.  Needs the card and raises without one, or if a design's words
differ from the plain version's (after every design has run).
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import hashlib
import json
import re
import subprocess
import sys

import torch

from octopuszk_tpu_torch.ops import kernels
from octopuszk_tpu_torch.scripts.chain_designs import (
    _equal, _flat, _launch, _ptxas, _rand_point, _rebuild, _time_ms)
from octopuszk_tpu_torch.scripts.tree_designs import _device_ms
from octopuszk_tpu_torch.utils import device as _device

PRELUDE = r"""
#include <cuda_runtime.h>
#include "grid.cuh"
#include "prefix.cuh"
#include "curve.cuh"
namespace {
constexpr int kT = 128;
}
"""

# one design per source: oz_prefix(group, p, scratch, batch, n, out, count,
# stream); count: 1 + batch zeroed words
DESIGNS = {
    "grid_thread": r"""
// the parent's loop (rcb.cuh prefix_step, prefix_sum_rows): level l
// writes out where L - 1 - l is even, else scratch
template <class C>
__global__ void __launch_bounds__(kT)
k(PointPtrs in, PointPtrs scratch, PointPtrs out, size_t batch, size_t n,
  unsigned* count) {
  levels::GridSched sched{count, 0u};
  const size_t stride = batch * n;
  const int L = ceil_log2(n);
  const ItemRange it = sched.range(batch, n);
  if (L == 0) {
    for (size_t i = it.first; i < it.end; i += it.step)
      store_point(load_point<C>(in, stride, i), out, stride, i);
    return;
  }
#pragma unroll 1
  for (int l = 0; l < L; l++) {
    const PointPtrs& dst = ((L - 1 - l) & 1) ? scratch : out;
    const PointPtrs& src = l == 0 ? in : (((L - l) & 1) ? scratch : out);
    const size_t d = (size_t)1 << l;
#pragma unroll 1
    for (size_t i = it.first; i < it.end; i += it.step) {
      const size_t j = i % n;
      const Pt<C> a = load_point<C>(src, stride, i);
      const Pt<C> b = j >= d ? load_point<C>(src, stride, i - d)
                             : pt_identity<C>();
      store_point(pt_add(a, b), dst, stride, i);
    }
    if (l + 1 < L) sched.barrier();
  }
}
template <class C>
static int launch(PointPtrs in, PointPtrs sc, PointPtrs out, size_t batch,
                  size_t n, unsigned* count, cudaStream_t s) {
  return levels::launch_levels(k<C>, batch * n, in, sc, out, batch, n,
                               count, s);
}
""",
    "grid_pair": r"""
// the parent's levels, each add on a pair; a warp's pairs take items
// together (the loop's bound is the warp's first item), a pair past the
// level's items repeats the last and stores nothing; reads through L2
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
    for (size_t i = t; i < stride; i += 2 * pairs)
      store_point(load_point<C>(in, stride, i), out, stride, i);
    return;
  }
#pragma unroll 1
  for (int l = 0; l < L; l++) {
    const PointPtrs& dst = ((L - 1 - l) & 1) ? scratch : out;
    const PointPtrs& src = l == 0 ? in : (((L - l) & 1) ? scratch : out);
    const size_t d = (size_t)1 << l;
#pragma unroll 1
    for (size_t it = t >> 1; (it & ~(size_t)15) < stride; it += pairs) {
      const bool live = it < stride;
      const size_t i = live ? it : stride - 1, j = i % n;
      const Pt<C> a = load_point<C, true>(src, stride, i);
      const Pt<C> b = j >= d ? load_point<C, true>(src, stride, i - d)
                             : pt_identity<C>();
      const Pt<C> r = pt_add_pair<C, ShflPair>(a, b, h);
      if (live) store_part<2>(r, dst, stride, i, h);
    }
    if (l + 1 < L) sched.barrier();
  }
}
template <class C>
static int launch(PointPtrs in, PointPtrs sc, PointPtrs out, size_t batch,
                  size_t n, unsigned* count, cudaStream_t s) {
  return levels::launch_levels(k<C>, 2 * batch * n, in, sc, out, batch, n,
                               count, s);
}
""",
}

# the two phases of the library's loop at another configuration: classes
# mod 2^M, T threads a worker, blocks of BLOCK threads, ROUNDS rounds a
# tile, buffers of SLOTS points, at least MINB1 / MINB2 blocks an SM on G1
# / G2, phase 2's whole warps of adds of the identity by pt_add_identity
# (ID) or by the complete add
CLASS = r"""
template <class C>
static int launch(PointPtrs in, PointPtrs sc, PointPtrs out, size_t batch,
                  size_t n, unsigned* count, cudaStream_t s) {
  constexpr int kMin = sizeof(C) == 32 ? MINB1 : MINB2;
  return launch_prefix<C, T, BLOCK, kMin, ROUNDS, SLOTS, ID>(
      M, in, out, batch, n, count, s);
}
"""
for _name, _m, _t, _block, _rounds, _slots, _min1, _min2, _id in (
        ("class_pair_3", 3, 2, 256, 2, 513, 2, 1, 0),
        ("class_pair_4", 4, 2, 256, 2, 257, 2, 1, 0),
        ("class_pair_5", 5, 2, 256, 2, 257, 2, 1, 0),
        ("class_pair_6", 6, 2, 256, 2, 257, 2, 1, 0),
        ("class_pair_4_b128", 4, 2, 128, 4, 257, 4, 2, 0),
        ("class_pair_4_b128_id", 4, 2, 128, 4, 257, 4, 2, 1),
        ("class_thread_4_3blocks", 4, 1, 128, 1, 257, 3, 1, 0),
        ("class_thread_4_3blocks_id", 4, 1, 128, 1, 257, 3, 1, 1),
        ("class_thread_4_b256_id", 4, 1, 256, 1, 257, 2, 1, 1)):
    DESIGNS[_name] = "".join(
        f"#define {k} {v}\n" for k, v in (
            ("M", _m), ("T", _t), ("BLOCK", _block), ("ROUNDS", _rounds),
            ("SLOTS", _slots), ("MINB1", _min1), ("MINB2", _min2),
            ("ID", "true" if _id else "false"))) + CLASS

ENTRY = r"""
extern "C" int oz_prefix(int group, const unsigned long long* p,
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

# the library's wrapper at its callers' shapes [batch, n]: the unpacked
# path's 19 windows, small MSMs' 4 lanes, short rows across tiles, many
# short rows, n = 1, a row of 2^12 + 17 (classes of 258 > 257 slots: phase
# 2 in place), n not a power of two
CALLER_SHAPES = ((19, 4096), (1, 4), (15, 4), (3, 37), (2, 17), (4096, 5),
                 (4, 1), (2, 4113), (1, 1000))


def build(curves, only=None) -> dict:
    """Each design's shared library per curve ((curve, name) -> (ctypes
    function, ptxas lines)), one nvcc each, all started together."""
    srcs = {k: PRELUDE + v + ENTRY for k, v in DESIGNS.items()
            if only is None or k in only}
    consts = kernels.constants_header()
    h = hashlib.sha256(consts.encode())
    for name in kernels.HEADERS:
        h.update((kernels.CSRC / name).read_bytes())
    for name in sorted(srcs):
        h.update(srcs[name].encode())
    out_dir = kernels.BUILD_ROOT / f"prefix-designs-{h.hexdigest()[:16]}"
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "constants.cuh").write_text(consts)
    nvcc = kernels._nvcc()
    for name in srcs:
        (out_dir / f"{name}.cu").write_text(srcs[name])

    def one(job):
        curve, name = job
        so = out_dir / f"lib{name}-{curve}.so"
        r = subprocess.run([nvcc, *kernels.NVCC_FLAGS,
                            *kernels.LIBRARIES[curve].defs, "-shared", "-I",
                            str(kernels.CSRC), "-I", str(out_dir),
                            str(out_dir / f"{name}.cu"), "-o", str(so)],
                           capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name} ({curve}):\n"
                               f"{r.stderr}")
        return curve, name, so, r.stdout + r.stderr

    jobs = [(c, n) for c in curves for n in sorted(srcs)]
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        built = list(pool.map(one, jobs))
    libs = {}
    vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    addrs = ctypes.POINTER(ctypes.c_ulonglong)
    for curve, name, so, log in built:
        fn = ctypes.CDLL(str(so)).oz_prefix
        fn.argtypes = [ci, addrs, addrs, ll, ll, addrs, vp, vp]
        fn.restype = ctypes.c_int
        libs[curve, name] = (fn, _ptxas_calls(log))
    return libs


def _ptxas_calls(log: str) -> list:
    """ptxas's registers and spills per kernel, then each function it
    compiled on its own (not inlined: called at run time)."""
    entries = set(re.findall(r"Compiling entry function '(\w+)'", log))
    return _ptxas(log) + [{"called": f} for f in sorted(
        set(re.findall(r"Function properties for (\w+)", log)) - entries)]


def _design_rows(libs, curve, g, cd, pts, batch, n, dev, reps=20):
    """The designs and the library's kernel on the points ``pts`` [batch,
    n]: (name, device ms, output) per design; each launch gets its own
    zeroed counts (a grid barrier's, or a ticket and a row's arrivals)."""
    outs = [torch.empty_like(t) for t in pts]
    scratch = [torch.empty_like(t) for t in pts]
    a_in, a_sc, a_out = (kernels._addr_array(x) for x in (pts, scratch, outs))
    lib_fn = kernels._group_entry(g, "oz_prefix_sum")[0]
    rows = []
    for (c, name), (fn, _) in list(libs.items()) + [(("", "library"),
                                                      (lib_fn, None))]:
        if c not in (curve, ""):
            continue
        for o in outs:
            o.zero_()
        counts = [torch.zeros(1 + batch, dtype=torch.int32, device=dev)
                  for _ in range(reps + 2)]
        if name == "library":
            launch = (lambda k: _launch(lib_fn, dev, cd, a_in, batch, n,
                                        a_out, counts[k].data_ptr()))
        else:
            launch = (lambda k, fn=fn: _launch(fn, dev, cd, a_in, a_sc, batch,
                                               n, a_out,
                                               counts[k].data_ptr()))
        ms = _device_ms(launch, dev, reps)
        rows.append((name, ms, [o.clone() for o in outs]))
    return rows


def main(curves=("bn254a",), only=None, num_win: int = 15,
         lanes: int = 4096) -> list:
    dev = _device.resolve(None)
    libs = build(curves, only)
    gen = torch.Generator(device=dev).manual_seed(15)
    results, failed = [], []

    def rec(obj):
        results.append(obj)
        print(json.dumps(obj), flush=True)

    for curve in curves:
        cv = kernels.LIBRARIES[curve].bundle()
        for cd, g in ((1, cv.g1.name), (2, cv.g2.name)):
            pts = _rand_point(gen, cd, (num_win, lanes), dev)
            want = _flat(kernels.prefix_sum_plain(g, _rebuild(pts, cd)))
            for name, ms, got in _design_rows(libs, curve, g, cd, pts,
                                              num_win, lanes, dev):
                ok = _equal(got, want)
                ptx = _ptxas_calls(kernels.compile_log(curve)[
                    "prefix_kernels.cu"]) if name == "library" else libs[
                        curve, name][1]
                rec({"design": f"prefix_sum {name}", "curve": curve,
                     "group": g, "shape": [num_win, lanes], "ms": ms,
                     "timed": "device", "equal": ok, "ptxas": ptx})
                if not ok:
                    failed.append(f"prefix_sum {name} {g}")
            del pts, want
            for batch, n in ((num_win, lanes),) + CALLER_SHAPES:
                pts = _rand_point(gen, cd, (batch, n), dev)
                want = _flat(kernels.prefix_sum_plain(g, _rebuild(pts, cd)))
                ms, got = _time_ms(lambda: _flat(kernels.prefix_sum(
                    g, _rebuild(pts, cd))), dev, 20)
                ok = _equal(got, want)
                rec({"design": "prefix_sum library", "curve": curve,
                     "group": g, "shape": [batch, n], "ms": ms,
                     "timed": "wrapper", "equal": ok, "ptxas": None})
                if not ok:
                    failed.append(f"prefix_sum library {g} {[batch, n]}")
                del pts, want
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
