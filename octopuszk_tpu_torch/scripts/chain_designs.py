"""Designs of two chains of kernels (d) and (e), timed side by side on the
card: the row loop of a two-level bucket sum (``kernels.lane_row_sums``)
and the doubling chains of ``kernels.double_points``.

Each design is a kernel over the headers of ``csrc/`` (``rcb.cuh``'s one
thread a point, ``lanes.cuh``'s field elements spread over the eight lanes
of a group of a warp), built here with nvcc into ``build/`` from the
sources below, run at the main path's shapes (BN254a, queries of 2^21
rows: lane row sums over [15 windows, 65,536 buckets] in 2,048 lanes of 32
rows; the window table's chain of 255 doublings of one point, every step
kept; the Abel sum's 16 doublings of 15 points) and compared word for word
with the plain version before it is timed.

    python -m octopuszk_tpu_torch.scripts.chain_designs

Row-sum designs (one chain: a lane's 32 adds in order, from the identity):
  ``thread``   one thread a chain, its points read from device memory;
  ``staged``   one thread a chain, a block's next rows staged through
               shared memory with coalesced loads;
  ``warp``     one warp a chain, a formula's products on the warp's four
               groups (``lanes::pt_add``);
  ``group``    one 8-lane group a chain, four chains a warp, each
               formula's products in sequence;
  ``thread_call`` one thread a chain, every product a call of one
               function body (``__noinline__``) instead of inlined;
and the library's ``lane_row_sums`` (two threads a chain, rcb.cuh
``pt_add_pair``) beside them.

Doubling-chain design: ``thread`` (one thread a point), beside the
library's ``double_points`` (a chain on one warp a point,
``lanes::double_chain``).

Prints one JSON line per design (ms per launch by CUDA events after two
warm-up launches, ptxas registers and spills), the library's row sums also
over 1, 4 and 30 windows (timed, not compared), then the card's name and
power limit.  Needs the card and raises without one, or if a design's
words differ from the plain version's (after every design has run).
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

from octopuszk_tpu_torch.curves import bn254
from octopuszk_tpu_torch.ops import kernels
from octopuszk_tpu_torch.utils import device as _device

PRELUDE = r"""
#include <cuda_runtime.h>
#include "lanes.cuh"
#include "curve.cuh"
namespace {
constexpr int kT = 128;
}
"""

# every product of a formula a call of one body (__noinline__): an add's
# code shrinks from all its products inlined to one product's
CALL = r"""
template <class C>
__device__ __noinline__ C mul_body(const C& a, const C& b) { return mul(a, b); }
template <class C>
__device__ __noinline__ C mul_b3_body(const C& a) { return mul_b3(a); }
template <class C>
struct Call {
  C e;
};
template <class C>
__device__ __forceinline__ Call<C> mul(const Call<C>& a, const Call<C>& b) {
  return {mul_body(a.e, b.e)};
}
template <class C>
__device__ __forceinline__ Call<C> mul_b3(const Call<C>& a) {
  return {mul_b3_body(a.e)};
}
template <class C>
__device__ __forceinline__ Call<C> add(const Call<C>& a, const Call<C>& b) {
  return {add(a.e, b.e)};
}
template <class C>
__device__ __forceinline__ Call<C> sub(const Call<C>& a, const Call<C>& b) {
  return {sub(a.e, b.e)};
}
template <class C>
__device__ __forceinline__ Call<C> dbl(const Call<C>& a) {
  return {dbl(a.e)};
}
template <class C>
__device__ __forceinline__ Pt<Call<C>> wrap(const Pt<C>& p) {
  return {{p.x}, {p.y}, {p.z}};
}
template <class C>
__device__ __forceinline__ Pt<C> unwrap(const Pt<Call<C>>& p) {
  return {p.x.e, p.y.e, p.z.e};
}
"""

# one design per source: oz_rows(group, p, batch, n, width, out, stream) or
# oz_chain(group, p, out, n, times, every_step, stream)
ROWS = {
    "thread": r"""
template <class C>
__global__ void __launch_bounds__(kT)
k(PointPtrs p, size_t batch, size_t n, size_t width, size_t rows,
  PointPtrs out) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= batch * width) return;
  const size_t b = i / width, lane = i - b * width;
  Pt<C> acc = pt_identity<C>();
#pragma unroll 1
  for (size_t r = 0; r < rows; r++) {
    const size_t pos = lane * rows + r;
    acc = pt_add(acc, pos < n ? load_point<C>(p, batch * n, b * n + pos)
                              : pt_identity<C>());
  }
  store_point(acc, out, batch * width, i);
}
#define THREADS_PER_CHAIN 1
#define SMEM(C) 0
""",
    "staged": r"""
// R rows of the block's kT chains in shared memory, [word][row][chain]
// with the chain axis padded to kT + 1: word w of row j of chain t at
// (w R + j) (kT + 1) + t
template <class C> struct Rows { static constexpr int R = sizeof(C) == 32 ? 8 : 4; };
template <class C>
__global__ void __launch_bounds__(kT)
k(PointPtrs p, size_t batch, size_t n, size_t width, size_t rows,
  PointPtrs out) {
  extern __shared__ uint32_t sm[];
  constexpr int R = Rows<C>::R, W = 3 * (int)(sizeof(C) / 4), P = kT + 1;
  __shared__ size_t off[kT];
  __shared__ unsigned lim[kT];
  const size_t chains = batch * width, stride = batch * n;
  const size_t first = (size_t)blockIdx.x * kT, i = first + threadIdx.x;
  {
    size_t o = 0;
    unsigned l = 0;
    if (i < chains) {
      const size_t b = i / width, lane = i - b * width;
      o = b * n + lane * rows;
      const size_t avail = n > lane * rows ? n - lane * rows : 0;
      l = (unsigned)(avail < rows ? avail : rows);
    }
    off[threadIdx.x] = o;
    lim[threadIdx.x] = l;
  }
  Pt<C> acc = pt_identity<C>();
#pragma unroll 1
  for (size_t r0 = 0; r0 < rows; r0 += R) {
    __syncthreads();
#pragma unroll 4
    for (int q = threadIdx.x; q < W * kT * R; q += kT) {
      const int w = q / (kT * R), rem = q - w * (kT * R);
      const int t = rem / R, j = rem - t * R;
      uint32_t v = 0;
      if (r0 + j < lim[t])
        v = p.c[w >> 3][(size_t)(w & 7) * stride + off[t] + r0 + j];
      sm[(w * R + j) * P + t] = v;
    }
    __syncthreads();
#pragma unroll 1
    for (int j = 0; j < R && r0 + j < rows; j++) {
      PointPtrs s;
#pragma unroll
      for (int c = 0; c < 6; c++) s.c[c] = sm + (c * 8 * R + j) * P;
      acc = pt_add(acc, r0 + j < lim[threadIdx.x]
                            ? load_point<C>(s, (size_t)R * P, threadIdx.x)
                            : pt_identity<C>());
    }
  }
  if (i < chains) store_point(acc, out, chains, i);
}
#define THREADS_PER_CHAIN 1
#define SMEM(C) ((size_t)3 * (sizeof(C) / 4) * Rows<C>::R * (kT + 1) * 4)
""",
    "warp": r"""
template <class C>
__global__ void __launch_bounds__(kT)
k(PointPtrs p, size_t batch, size_t n, size_t width, size_t rows,
  PointPtrs out) {
  typedef typename lanes::Spread<C, lanes::WarpLanes>::type S;
  const size_t i = ((size_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (i >= batch * width) return;
  const size_t b = i / width, lane = i - b * width;
  Pt<S> acc;
  lanes::coord_zero(acc.x);
  lanes::coord_one(acc.y);
  lanes::coord_zero(acc.z);
#pragma unroll 1
  for (size_t r = 0; r < rows; r++) {
    const size_t pos = lane * rows + r;
    Pt<S> q;
    if (pos < n) {
      q = lanes::load_point<S>(p, batch * n, b * n + pos);
    } else {
      lanes::coord_zero(q.x);
      lanes::coord_one(q.y);
      lanes::coord_zero(q.z);
    }
    acc = lanes::pt_add(acc, q);
  }
  lanes::store_point(acc, out, batch * width, i);
}
#define THREADS_PER_CHAIN 32
#define SMEM(C) 0
""",
    "group": r"""
// rcb.cuh's formulas over one group's own spread elements: each product
// a Montgomery product on the group (lanes::mont_mul), the four groups of
// a warp on four chains
namespace lanes {
template <class M, class L>
__device__ __forceinline__ LFp<M, L> mul(const LFp<M, L>& a,
                                         const LFp<M, L>& b) {
  return {mont_mul<M, L>(a.w, b.w)};
}
template <class M, class L>
__device__ __forceinline__ LFp2<M, L> mul(const LFp2<M, L>& a,
                                          const LFp2<M, L>& b) {
  const LFp<M, L> t0 = mul(a.c0, b.c0), t1 = mul(a.c1, b.c1);
  const LFp<M, L> s = mul(add(a.c0, a.c1), add(b.c0, b.c1));
  return {sub(t0, mul_small<(unsigned)-M::kNr>(t1)), sub(sub(s, t0), t1)};
}
template <class M, class L>
__device__ __forceinline__ LFp<M, L> mul_b3(const LFp<M, L>& a) {
  return mul_small<M::kB3>(a);
}
template <class M, class L>
__device__ __forceinline__ LFp2<M, L> mul_b3(const LFp2<M, L>& a) {
  const typename L::U32 k = word_index<L>();
  const LFp2<M, L> b3 = {{pick<B3C0Word, M, L>(k)},
                         {pick<B3C1Word, M, L>(k)}};
  return mul(a, b3);
}
template <class M, class L>
__device__ __forceinline__ LFp<M, L> choose(bool c, const LFp<M, L>& a,
                                            const LFp<M, L>& b) {
  return {c ? a.w : b.w};
}
template <class M, class L>
__device__ __forceinline__ LFp2<M, L> choose(bool c, const LFp2<M, L>& a,
                                             const LFp2<M, L>& b) {
  return {choose(c, a.c0, b.c0), choose(c, a.c1, b.c1)};
}
template <class M, class L>
__device__ __forceinline__ void store_mine(const LFp<M, L>& c,
                                           const PointPtrs& p, int ci,
                                           size_t n, size_t i, bool on) {
  L::store(p.c[ci], n, i, word_index<L>(), c.w, on);
}
template <class M, class L>
__device__ __forceinline__ void store_mine(const LFp2<M, L>& c,
                                           const PointPtrs& p, int ci,
                                           size_t n, size_t i, bool on) {
  L::store(p.c[2 * ci], n, i, word_index<L>(), c.c0.w, on);
  L::store(p.c[2 * ci + 1], n, i, word_index<L>(), c.c1.w, on);
}
}  // namespace lanes
template <class C>
__global__ void __launch_bounds__(kT)
k(PointPtrs p, size_t batch, size_t n, size_t width, size_t rows,
  PointPtrs out) {
  typedef typename lanes::Spread<C, lanes::WarpLanes>::type S;
  const size_t t = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t chains = batch * width;
  if (((t >> 5) << 2) >= chains) return;        // the whole warp
  const bool live = (t >> 3) < chains;
  const size_t i = live ? t >> 3 : chains - 1;
  const size_t b = i / width, lane = i - b * width;
  Pt<S> id;
  lanes::coord_zero(id.x);
  lanes::coord_one(id.y);
  lanes::coord_zero(id.z);
  Pt<S> acc = id;
#pragma unroll 1
  for (size_t r = 0; r < rows; r++) {
    const size_t pos = lane * rows + r;
    const bool in = pos < n;
    const Pt<S> q = lanes::load_point<S>(p, batch * n,
                                         b * n + (in ? pos : 0));
    Pt<S> e;
    e.x = lanes::choose(in, q.x, id.x);
    e.y = lanes::choose(in, q.y, id.y);
    e.z = lanes::choose(in, q.z, id.z);
    acc = ::pt_add(acc, e);
  }
  lanes::store_mine(acc.x, out, 0, chains, i, live);
  lanes::store_mine(acc.y, out, 1, chains, i, live);
  lanes::store_mine(acc.z, out, 2, chains, i, live);
}
#define THREADS_PER_CHAIN 8
#define SMEM(C) 0
""",
    "thread_call": CALL + r"""
template <class C>
__global__ void __launch_bounds__(kT)
k(PointPtrs p, size_t batch, size_t n, size_t width, size_t rows,
  PointPtrs out) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= batch * width) return;
  const size_t b = i / width, lane = i - b * width;
  Pt<Call<C>> acc = wrap(pt_identity<C>());
#pragma unroll 1
  for (size_t r = 0; r < rows; r++) {
    const size_t pos = lane * rows + r;
    acc = pt_add(acc, wrap(pos < n ? load_point<C>(p, batch * n, b * n + pos)
                                   : pt_identity<C>()));
  }
  store_point(unwrap(acc), out, batch * width, i);
}
#define THREADS_PER_CHAIN 1
#define SMEM(C) 0
""",
}

ROWS_ENTRY = r"""
template <class C>
static int launch(PointPtrs p, size_t batch, size_t n, size_t width,
                  PointPtrs out, cudaStream_t s) {
  const size_t rows = (n + width - 1) / width;
  const size_t threads = batch * width * THREADS_PER_CHAIN;
  const unsigned g = (unsigned)((threads + kT - 1) / kT);
  const size_t smem = SMEM(C);
  if (smem > 0) {
    const cudaError_t e = cudaFuncSetAttribute(
        k<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  k<C><<<g, kT, smem, s>>>(p, batch, n, width, rows, out);
  return (int)cudaGetLastError();
}
extern "C" int oz_rows(int group, const unsigned long long* p,
                       long long batch, long long n, long long width,
                       const unsigned long long* out, void* stream) {
  const int cnt = 3 * group;
  cudaStream_t s = (cudaStream_t)stream;
  if (group == 1)
    return launch<G1Coord>(make_ptrs(p, cnt), batch, n, width,
                           make_ptrs(out, cnt), s);
  return launch<G2Coord>(make_ptrs(p, cnt), batch, n, width,
                         make_ptrs(out, cnt), s);
}
"""

CHAINS = {
    "thread": r"""
template <class C, bool EVERY>
__global__ void __launch_bounds__(kT)
k(PointPtrs p, PointPtrs out, size_t n, int times) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Pt<C> q = load_point<C>(p, n, i);
#pragma unroll 1
  for (int j = 0; j < times; j++) {
    q = pt_double(q);
    if (EVERY) store_point(q, out, n * times, i * times + j);
  }
  if (!EVERY) store_point(q, out, n, i);
}
#define THREADS_PER_POINT 1
""",
}

CHAIN_ENTRY = r"""
template <class C>
static int launch(PointPtrs p, PointPtrs out, size_t n, int times, int every,
                  cudaStream_t s) {
  const unsigned g =
      (unsigned)((n * THREADS_PER_POINT + kT - 1) / kT);
  if (every)
    k<C, true><<<g, kT, 0, s>>>(p, out, n, times);
  else
    k<C, false><<<g, kT, 0, s>>>(p, out, n, times);
  return (int)cudaGetLastError();
}
extern "C" int oz_chain(int group, const unsigned long long* p,
                        const unsigned long long* out, long long n,
                        int times, int every, void* stream) {
  const int cnt = 3 * group;
  cudaStream_t s = (cudaStream_t)stream;
  if (group == 1)
    return launch<G1Coord>(make_ptrs(p, cnt), make_ptrs(out, cnt), n, times,
                           every, s);
  return launch<G2Coord>(make_ptrs(p, cnt), make_ptrs(out, cnt), n, times,
                         every, s);
}
"""


def _sources(only=None):
    out = {f"rows_{k}": PRELUDE + v + ROWS_ENTRY for k, v in ROWS.items()}
    out.update({f"chain_{k}": PRELUDE + v + CHAIN_ENTRY
                for k, v in CHAINS.items()})
    return {k: v for k, v in out.items() if only is None or k in only}


def build(only=None) -> dict:
    """Each design's shared library (name -> (ctypes library, ptxas
    lines)), one nvcc per design, all started together; ``only``: the
    names (``rows_<design>``, ``chain_<design>``) to build, else all."""
    srcs = _sources(only)
    consts = kernels.constants_header()
    h = hashlib.sha256(consts.encode())
    for name in kernels.HEADERS:
        h.update((kernels.CSRC / name).read_bytes())
    for name in sorted(srcs):
        h.update(srcs[name].encode())
    out_dir = kernels.BUILD_ROOT / f"chain-designs-{h.hexdigest()[:16]}"
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "constants.cuh").write_text(consts)
    nvcc = kernels._nvcc()

    def one(name):
        cu = out_dir / f"{name}.cu"
        cu.write_text(srcs[name])
        so = out_dir / f"lib{name}.so"
        r = subprocess.run([nvcc, *kernels.NVCC_FLAGS, "-shared", "-I",
                            str(kernels.CSRC), "-I", str(out_dir), str(cu),
                            "-o", str(so)], capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{r.stderr}")
        return name, so, r.stdout + r.stderr

    with concurrent.futures.ThreadPoolExecutor(len(srcs)) as pool:
        built = list(pool.map(one, sorted(srcs)))
    libs = {}
    vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    addrs = ctypes.POINTER(ctypes.c_ulonglong)
    for name, so, log in built:
        lib = ctypes.CDLL(str(so))
        if name.startswith("rows_"):
            fn = lib.oz_rows
            fn.argtypes = [ci, addrs, ll, ll, ll, addrs, vp]
        else:
            fn = lib.oz_chain
            fn.argtypes = [ci, addrs, addrs, ll, ci, ci, vp]
        fn.restype = ctypes.c_int
        libs[name] = (fn, _ptxas(log))
    return libs


def _ptxas(log: str) -> list:
    """(kernel, registers, spill stores, spill loads) per function."""
    out, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and name:
            stack = int(m.group(1))
            spill = (int(m.group(2)), int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append({"kernel": name,
                        "group": "G2" if "Fp2I" in name else "G1",
                        "registers": int(m.group(1)),
                        "spill_stores": spill[0], "spill_loads": spill[1],
                        "stack_frame": stack})
            name = None
    return out


def _time_ms(fn, dev, reps: int = 5) -> tuple:
    out = fn()
    out = fn()
    del out
    torch.cuda.synchronize(dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize(dev)
    return start.elapsed_time(end) / reps, out


def _rand_point(gen, cd, shape, dev):
    comps = []
    for _ in range(3 * cd):
        w = torch.randint(-2**31, 2**31, (8,) + shape, dtype=torch.int64,
                          device=dev, generator=gen).to(torch.int32)
        w[7] &= 0x0FFFFFFF                       # below 2^252 < q
        comps.append(w)
    return comps


def _equal(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


def _flat(p):
    out = []
    for c in p:
        out.extend(c if isinstance(c, tuple) else (c,))
    return out


def _rebuild(comps, cd):
    if cd == 1:
        return tuple(comps)
    return tuple((comps[i], comps[i + 1]) for i in range(0, 6, 2))


def _launch(fn, dev, *args):
    rc = fn(*args, ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if rc != 0:
        raise RuntimeError(f"launch failed: error {rc}")


def main(only=None, num_win: int = 15, nbk: int = 1 << 16,
         width: int = 2048, table_times: int = 255,
         abel_times: int = 16) -> list:
    dev = _device.resolve(None)
    libs = build(only)
    gen = torch.Generator(device=dev).manual_seed(11)
    results, failed = [], []

    def rec(obj):
        results.append(obj)
        print(json.dumps(obj), flush=True)

    for cd, g in ((1, bn254.G1.name), (2, bn254.G2.name)):
        pts = _rand_point(gen, cd, (num_win, nbk), dev)
        want = _flat(kernels.lane_row_sums_plain(g, _rebuild(pts, cd),
                                                 width))
        designs = [(n[5:], f) for n, (f, _) in libs.items()
                   if n.startswith("rows_")]
        for name, fn in designs + [("library", None)]:
            def run(fn=fn):
                if fn is None:
                    return _flat(kernels.lane_row_sums(
                        g, _rebuild(pts, cd), width))
                outs = [torch.empty((8, num_win, width), dtype=torch.int32,
                                    device=dev) for _ in pts]
                _launch(fn, dev, cd, kernels._addr_array(pts), num_win, nbk,
                        width, kernels._addr_array(outs))
                return outs
            ms, got = _time_ms(run, dev)
            ok = _equal(got, want)
            rec({"design": f"lane_row_sums {name}", "group": g,
                 "shape": [num_win, width, -(-nbk // width)], "ms": ms,
                 "equal": ok,
                 "ptxas": libs.get(f"rows_{name}", (None, None))[1]})
            if not ok:
                failed.append(f"lane_row_sums {name} {g}")
        del pts, want
        # the library's kernel over fewer and more windows (2,048 chains a
        # window): its time against the work, from one window, where a
        # chain's latency shows, to twice the main path's
        for nw in (1, 4, 2 * num_win):
            pts = _rand_point(gen, cd, (nw, nbk), dev)
            ms, _ = _time_ms(lambda: kernels.lane_row_sums(
                g, _rebuild(pts, cd), width), dev)
            rec({"design": "lane_row_sums library", "group": g,
                 "shape": [nw, width, -(-nbk // width)], "ms": ms,
                 "equal": None, "ptxas": None})
            del pts
        for npts, times, every in ((1, table_times, True),
                                   (num_win, abel_times, False)):
            p = _rand_point(gen, cd, (npts,), dev)
            want = _flat(kernels.double_points_plain(g, _rebuild(p, cd),
                                                     times, every))
            designs = [(n[6:], f) for n, (f, _) in libs.items()
                       if n.startswith("chain_")]
            for name, fn in designs + [("library", None)]:
                def run(fn=fn):
                    if fn is None:
                        return _flat(kernels.double_points(
                            g, _rebuild(p, cd), times, every))
                    shape = (8, npts) + ((times,) if every else ())
                    outs = [torch.empty(shape, dtype=torch.int32, device=dev)
                            for _ in p]
                    _launch(fn, dev, cd, kernels._addr_array(p),
                            kernels._addr_array(outs), npts, times,
                            int(every))
                    return outs
                ms, got = _time_ms(run, dev)
                ok = _equal(got, want)
                rec({"design": f"double_points {name}", "group": g,
                     "points": npts, "times": times, "every_step": every,
                     "ms": ms, "equal": ok,
                     "ptxas": libs.get(f"chain_{name}", (None, None))[1]})
                if not ok:
                    failed.append(f"double chain {name} {g}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    if failed:
        raise AssertionError(f"differ from the plain version: {failed}")
    return results


if __name__ == "__main__":
    main(sys.argv[1:] or None)
    sys.exit(0)
