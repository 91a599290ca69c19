"""Designs of the batch inversion (``kernels.batch_inv_rows``), timed side by
side on the card at the main path's two shapes: BN254a Fq [8, 2^21] with
5 % zeros (a packed query's affine conversion) and [8, 557,056] (the
fixed-base window table of 17 windows of 2^15).

Each design is one lane per thread (forward sweep of prefix products,
inversion of the lane total, backward sweep), built here with nvcc into
``build/`` from the source below, and differs in how the lane total is
inverted, whether the sweeps load a row's words ahead of the product
before it, and in the lanes and threads a block:

  ``fermat``   the lane total raised to q - 2 (``pow_exp``), loads not
               ahead, 64 threads a block, 2^15 lanes: the design before
               safegcd;
  ``safegcd a lane, loads not ahead``  the same with ``inv_safegcd``,
               2^15 and 2^16 lanes;
  ``safegcd a lane``  ``field.cuh``'s sweeps (loads ahead) around one
               ``inv_safegcd`` a lane, 64 or 128 threads a block, 2^15,
               2^16, 2^17 or 2^18 lanes;
  ``block``    ``field.cuh`` ``batch_inv_block``, the library's: a third
               level over the same sweeps, a block's lane totals
               multiplied in shared memory (inclusive prefix and suffix
               products, Hillis-Steele, each lane's in registers between
               the levels, two barriers a level), one safegcd inversion a
               block (its first thread), each lane's inverse the product
               of its exclusive prefix, its exclusive suffix and the
               block's inverse; 128 or 256 threads a block, 2^15 to 2^18
               lanes;
  ``block, products in shared buffers``  the same with the products in
               two shared buffers a level reads and writes in turn (one
               barrier a level; each phase a loop over the block's lanes,
               which a host harness could run in turn), 128 threads;

and the library's ``batch_inv_rows`` beside them.  Before them, the
inversion of one element a thread at [8, 1] and [8, 4096]: the library's
``inv_safegcd`` (divsteps as selects), the same with libsecp256k1's
divsteps as written (masks), and the Fermat chain, each timed over 50
launches from one C call (the device's time, not the wrapper's).  Each is
compared word for word with the plain version, then timed.

    python -m octopuszk_tpu_torch.scripts.inv_designs

Prints one JSON line per design and shape (ms per launch by CUDA events
over 20 launches after two warm-up launches; ptxas registers and spills), then the card's
name and power limit.  Needs the card and raises without one, or if a
design's words differ from the plain version's (after every design has
run).
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import subprocess
import sys

import torch

from octopuszk_tpu_torch.fields.spec import FQ
from octopuszk_tpu_torch.ops import kernels
from octopuszk_tpu_torch.scripts.chain_designs import _ptxas, _time_ms
from octopuszk_tpu_torch.utils import device as _device

SOURCE = r"""
#include <cuda_runtime.h>
#include "curve.cuh"
namespace {
// the sweeps before the loads ran ahead: each row's words loaded just
// before its product; the lane total raised to p - 2 (FERMAT, the design
// before safegcd) or inverted by inv_safegcd
template <class M, bool FERMAT>
__device__ __forceinline__ void unfetched_lane(const uint32_t* a,
                                               uint32_t* out, size_t n,
                                               size_t lanes, size_t l,
                                               const Exponent& pm2) {
  const size_t rows = batch_inv_rows_count(n, lanes, l);
  if (FERMAT && rows == 0) return;
  Fp<M> carry = fp_one<M>();
#pragma unroll 1
  for (size_t r = 0; r < rows; r++) {
    const size_t pos = l + r * lanes;
    fp_store<M>(out, n, pos, carry);
    const Fp<M> x = fp_load<M>(a, n, pos);
    if (!is_zero(x)) carry = mul(carry, x);
  }
  if constexpr (FERMAT) carry = pow_exp(carry, pm2);
  else carry = inv_safegcd<M, WarpVote>(rows ? carry : fp_zero<M>());
#pragma unroll 1
  for (size_t r = rows; r-- > 0;) {
    const size_t pos = l + r * lanes;
    const Fp<M> x = fp_load<M>(a, n, pos);
    if (is_zero(x)) {
      fp_store<M>(out, n, pos, fp_zero<M>());
      continue;
    }
    fp_store<M>(out, n, pos, mul(carry, fp_load<M>(out, n, pos)));
    carry = mul(carry, x);
  }
}

// one safegcd inversion a lane, over field.cuh's sweeps (every thread of a
// warp reaches the vote; a lane past ``lanes`` inverts zero)
template <class M>
__device__ __forceinline__ void safegcd_lane(const uint32_t* a, uint32_t* out,
                                             size_t n, size_t lanes,
                                             size_t l) {
  const size_t rows = batch_inv_rows_count(n, lanes, l);
  const Fp<M> total = batch_inv_forward<M>(a, out, n, lanes, l, rows);
  batch_inv_backward<M>(a, out, n, lanes, l, rows,
                        inv_safegcd<M, WarpVote>(rows ? total : fp_zero<M>()));
}

// the third level with each lane's prefix and suffix products in two
// shared buffers, where the library's batch_inv_block keeps them in
// registers: a level reads one buffer and writes the other (one barrier a
// level), every phase a loop over the block's lanes (BlockSched: one a
// thread), so that a host harness could run the phases in turn
template <class M, int T>
__device__ __forceinline__ void buffered_block(const uint32_t* a,
                                               uint32_t* out, size_t n,
                                               size_t lanes) {
  constexpr unsigned W = 8 * T;
  __shared__ uint32_t smem[4 * W + 8];
  BlockSched sched;
  const size_t base = (size_t)blockIdx.x * T;
  for (unsigned t = sched.first(); t < (unsigned)T; t += sched.step()) {
    const size_t l = base + t;
    const Fp<M> total = batch_inv_forward<M>(
        a, out, n, lanes, l, batch_inv_rows_count(n, lanes, l));
    fp_store<M>(smem, T, t, total);
    fp_store<M>(smem + 2 * W, T, t, total);
  }
  sched.barrier();
  unsigned src = 0;
#pragma unroll 1
  for (unsigned d = 1; d < (unsigned)T; d <<= 1, src ^= 1) {
    const uint32_t* pre = smem + src * W;
    const uint32_t* suf = smem + (2 + src) * W;
    for (unsigned t = sched.first(); t < (unsigned)T; t += sched.step()) {
      Fp<M> p = fp_load<M>(pre, T, t), s = fp_load<M>(suf, T, t);
      if (t >= d) p = mul(fp_load<M>(pre, T, t - d), p);
      if (t + d < (unsigned)T) s = mul(s, fp_load<M>(suf, T, t + d));
      fp_store<M>(smem + (src ^ 1) * W, T, t, p);
      fp_store<M>(smem + (2 + (src ^ 1)) * W, T, t, s);
    }
    sched.barrier();
  }
  const uint32_t* pre = smem + src * W;
  const uint32_t* suf = smem + (2 + src) * W;
  if (sched.first() == 0)
    fp_store<M>(smem + 4 * W, 1, 0,
                inv_safegcd<M, OneThread>(fp_load<M>(pre, T, T - 1)));
  sched.barrier();
  for (unsigned t = sched.first(); t < (unsigned)T; t += sched.step()) {
    const size_t l = base + t;
    Fp<M> inv = fp_load<M>(smem + 4 * W, 1, 0);
    if (t > 0) inv = mul(inv, fp_load<M>(pre, T, t - 1));
    if (t + 1 < (unsigned)T) inv = mul(inv, fp_load<M>(suf, T, t + 1));
    batch_inv_backward<M>(a, out, n, lanes, l,
                          batch_inv_rows_count(n, lanes, l), inv);
  }
}

// libsecp256k1's secp256k1_modinv32_divsteps_30 as it is written: every
// choice a mask
__device__ __forceinline__ int32_t masks_divsteps_30(int32_t zeta, uint32_t f,
                                                     uint32_t g,
                                                     sgcd::Trans& t) {
  uint32_t u = 1u, v = 0u, q = 0u, r = 1u;
#pragma unroll
  for (int i = 0; i < 30; i++) {
    uint32_t c1 = (uint32_t)(zeta >> 31);
    const uint32_t c2 = 0u - (g & 1u);
    const uint32_t x = (f ^ c1) - c1, y = (u ^ c1) - c1, z = (v ^ c1) - c1;
    g += x & c2;
    q += y & c2;
    r += z & c2;
    c1 &= c2;
    zeta = (zeta ^ (int32_t)c1) - 1;
    f += g & c1;
    u += q & c1;
    v += r & c1;
    g >>= 1;
    u <<= 1;
    v <<= 1;
  }
  t = {(int32_t)u, (int32_t)v, (int32_t)q, (int32_t)r};
  return zeta;
}

// inv_safegcd over masks_divsteps_30
template <class M>
__device__ __forceinline__ Fp<M> inv_masks(const Fp<M>& a) {
  sgcd::S30 d = {}, e = {}, f, g = sgcd::from_words(a);
  e.v[0] = 1;
#pragma unroll
  for (int i = 0; i < 9; i++) f.v[i] = M::p30(i);
  int32_t zeta = -1;
#pragma unroll 1
  for (int b = 0; b < 20; b++) {
    if (WarpVote::all(sgcd::is_zero(g))) break;
    sgcd::Trans t;
    zeta = masks_divsteps_30(zeta, (uint32_t)f.v[0], (uint32_t)g.v[0], t);
    sgcd::update_de<M>(d, e, t);
    sgcd::update_fg(f, g, t);
  }
  sgcd::normalize<M>(d, f.v[8]);
  Fp<M> r3;
#pragma unroll
  for (int k = 0; k < 8; k++) r3.v[k] = M::r3(k);
  return mul(sgcd::to_words<M>(d), r3);
}

// one thread an element: 0 the library's inv_safegcd, 1 inv_masks, 2 the
// Fermat chain
template <int D>
__global__ void __launch_bounds__(64)
inv_k(const uint32_t* __restrict__ a, uint32_t* __restrict__ out, size_t n,
      Exponent pm2) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const Fp<CurveFq> x = i < n ? fp_load<CurveFq>(a, n, i) : fp_zero<CurveFq>();
  Fp<CurveFq> y;
  if constexpr (D == 0) y = inv_safegcd<CurveFq, WarpVote>(x);
  else if constexpr (D == 1) y = inv_masks<CurveFq>(x);
  else y = pow_exp(x, pm2);
  if (i < n) fp_store<CurveFq>(out, n, i, y);
}

// kind: 0 fermat, 1 safegcd a lane with the loads not ahead, 2 safegcd a
// lane, 3 the library's block (field.cuh batch_inv_block), 4 the block
// with its products in shared buffers
template <int T, int KIND>
__global__ void __launch_bounds__(T)
k(const uint32_t* __restrict__ a, uint32_t* out, size_t n, size_t lanes,
  Exponent pm2) {
  const size_t l = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if constexpr (KIND == 0) {
    unfetched_lane<CurveFq, true>(a, out, n, lanes, l, pm2);
  } else if constexpr (KIND == 1) {
    unfetched_lane<CurveFq, false>(a, out, n, lanes, l, pm2);
  } else if constexpr (KIND == 2) {
    safegcd_lane<CurveFq>(a, out, n, lanes, l);
  } else if constexpr (KIND == 4) {
    buffered_block<CurveFq, T>(a, out, n, lanes);
  } else {
    __shared__ uint32_t smem[batch_inv_smem_words(T)];
    BlockSched sync;
    batch_inv_block<CurveFq, T>(a, out, n, lanes, blockIdx.x, threadIdx.x,
                                smem, sync);
  }
}

template <int T, int KIND>
int launch(const void* a, void* out, size_t n, size_t lanes,
           const Exponent& e, cudaStream_t s) {
  k<T, KIND><<<(unsigned)((lanes + T - 1) / T), T, 0, s>>>(
      (const uint32_t*)a, (uint32_t*)out, n, lanes, e);
  return (int)cudaGetLastError();
}
}  // namespace

// design: 0 fermat, 1 safegcd a lane with the loads not ahead (64
// threads); 2 / 3 safegcd a lane at 64 / 128 threads; 4 / 5 block of 128 /
// 256; 6 block of 128 with its products in shared buffers
extern "C" int oz_design(int design, const void* a, void* out, long long n,
                         long long lanes, const unsigned* pm2, int top,
                         void* stream) {
  if (n <= 0 || lanes <= 0 || lanes > n) return (int)cudaErrorInvalidValue;
  Exponent e;
  for (int k = 0; k < 8; k++) e.w[k] = pm2[k];
  e.top = top;
  cudaStream_t s = (cudaStream_t)stream;
  switch (design) {
    case 0: return launch<64, 0>(a, out, n, lanes, e, s);
    case 1: return launch<64, 1>(a, out, n, lanes, e, s);
    case 2: return launch<64, 2>(a, out, n, lanes, e, s);
    case 3: return launch<128, 2>(a, out, n, lanes, e, s);
    case 4: return launch<128, 3>(a, out, n, lanes, e, s);
    case 5: return launch<256, 3>(a, out, n, lanes, e, s);
    default: return launch<128, 4>(a, out, n, lanes, e, s);
  }
}

// ``reps`` launches of inversion design ``design`` (inv_k) one after the
// other on the stream
extern "C" int oz_inv_design(int design, const void* a, void* out,
                             long long n, int reps, const unsigned* pm2,
                             int top, void* stream) {
  if (n <= 0 || reps <= 0) return (int)cudaErrorInvalidValue;
  Exponent e;
  for (int k = 0; k < 8; k++) e.w[k] = pm2[k];
  e.top = top;
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned g = (unsigned)((n + 63) / 64);
  for (int r = 0; r < reps; r++) {
    if (design == 0) inv_k<0><<<g, 64, 0, s>>>((const uint32_t*)a, (uint32_t*)out, n, e);
    else if (design == 1) inv_k<1><<<g, 64, 0, s>>>((const uint32_t*)a, (uint32_t*)out, n, e);
    else inv_k<2><<<g, 64, 0, s>>>((const uint32_t*)a, (uint32_t*)out, n, e);
  }
  return (int)cudaGetLastError();
}
"""

# inversion designs (one thread an element): name -> id in oz_inv_design
INV_DESIGNS = {"inv_safegcd (selects)": 0,
               "inv_safegcd, libsecp256k1's masks": 1,
               "Fermat chain (mont_pow)": 2}
INV_REPS = 50

# (name, design id, threads a block, lane counts)
LANES = (1 << 15, 1 << 16, 1 << 17, 1 << 18)
DESIGNS = [("fermat", 0, 64, (1 << 15,)),
           ("safegcd a lane, loads not ahead", 1, 64, (1 << 15, 1 << 16)),
           ("safegcd a lane", 2, 64, LANES),
           ("safegcd a lane", 3, 128, LANES),
           ("block", 4, 128, LANES), ("block", 5, 256, LANES),
           ("block, products in shared buffers", 6, 128, LANES)]


def build():
    """The designs' shared library (one nvcc) and its ptxas lines."""
    consts = kernels.constants_header()
    h = hashlib.sha256(consts.encode() + SOURCE.encode())
    for name in kernels.HEADERS:
        h.update((kernels.CSRC / name).read_bytes())
    out_dir = kernels.BUILD_ROOT / f"inv-designs-{h.hexdigest()[:16]}"
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "constants.cuh").write_text(consts)
    cu, so = out_dir / "inv_designs.cu", out_dir / "libinv_designs.so"
    cu.write_text(SOURCE)
    r = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared",
                        "-I", str(kernels.CSRC), "-I", str(out_dir), str(cu),
                        "-o", str(so)], capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{r.stderr}")
    lib = ctypes.CDLL(str(so))
    vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    words = ctypes.POINTER(ctypes.c_uint)
    lib.oz_design.argtypes = [ci, vp, vp, ll, ll, words, ci, vp]
    lib.oz_inv_design.argtypes = [ci, vp, vp, ll, ci, words, ci, vp]
    lib.oz_design.restype = lib.oz_inv_design.restype = ctypes.c_int
    return lib, _ptxas(r.stdout + r.stderr)


def _rand_fq(gen, n, dev):
    w = torch.randint(-2**31, 2**31, (8, n), dtype=torch.int64, device=dev,
                      generator=gen).to(torch.int32)
    w[7] &= 0x0FFFFFFF                           # below 2^252 < q
    return w


def main(sizes=(1 << 21, 557_056)) -> list:
    dev = _device.resolve(None)
    lib, ptxas = build()
    fn = lib.oz_design
    words, top = kernels._exponent(FQ.p_minus_2)
    gen = torch.Generator(device=dev).manual_seed(14)
    results, failed = [], []

    def rec(obj, ok, what):
        results.append(obj)
        print(json.dumps(obj), flush=True)
        if not ok:
            failed.append(what)

    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    for cnt in (1, 4096):
        a = _rand_fq(gen, cnt, dev)
        want = kernels.inv_plain(FQ, a)
        for name, d in INV_DESIGNS.items():
            out = torch.empty_like(a)

            def run(reps):
                rc = lib.oz_inv_design(d, a.data_ptr(), out.data_ptr(), cnt,
                                       reps, words, top, stream)
                if rc != 0:
                    raise RuntimeError(f"launch failed: error {rc}")
            run(1)
            torch.cuda.synchronize(dev)
            ok = torch.equal(out, want)
            run(2)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            run(INV_REPS)
            end.record()
            torch.cuda.synchronize(dev)
            rec({"design": name, "shape": [8, cnt],
                 "ms": start.elapsed_time(end) / INV_REPS, "equal": ok},
                ok, f"{name} [8, {cnt}]")
    for n in sizes:
        a = _rand_fq(gen, n, dev)
        a[:, torch.rand(n, device=dev, generator=gen) < 0.05] = 0
        want = kernels.batch_inv_rows_plain(FQ, a)
        runs = [(f"{name}, {t} threads", lanes,
                 lambda d=d, lanes=lanes: _run(fn, d, a, lanes, words, top))
                for name, d, t, lane_counts in DESIGNS
                for lanes in lane_counts if lanes <= n]
        runs.append((f"library, {kernels.INV_LANES} lanes",
                     min(kernels.INV_LANES, n),
                     lambda: kernels.batch_inv_rows(FQ, a)))
        for name, lanes, run in runs:
            ok = torch.equal(run(), want)
            ms, _ = _time_ms(run, dev, 20)
            rec({"design": f"batch_inv_rows {name}", "shape": [8, n],
                 "lanes": lanes, "ms": ms, "equal": ok},
                ok, f"{name} at {lanes} lanes, n = {n}")
        del a, want
    print(json.dumps({"ptxas": ptxas}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    if failed:
        raise AssertionError(f"differ from the plain version: {failed}")
    return results


def _run(fn, design, a, lanes, words, top):
    out = torch.empty_like(a)
    rc = fn(design, a.data_ptr(), out.data_ptr(), a.shape[1], lanes, words,
            top, ctypes.c_void_p(torch.cuda.current_stream(a.device)
                                 .cuda_stream))
    if rc != 0:
        raise RuntimeError(f"launch failed: error {rc}")
    return out


if __name__ == "__main__":
    main()
    sys.exit(0)
