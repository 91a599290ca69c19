"""Tensor-core Montgomery experiment: kernel (b) against the SOS product
with its reduction as Toeplitz matmuls (ops/mxu_mont.py).

Port of ``scripts/mxu_experiment.py``, under its metric names.  Measures
on the card, with CUDA events:

  1. elementwise throughput on [16, n]: ``u32_mul`` and ``u32_add`` (int32
     tensors: the same bit patterns as uint32, which wrap alike) and
     ``f32_mul``, eight chained operations per call;
  2. ``mxu_toeplitz_64x32``: the [64, 32] x [32, n] bfloat16 Toeplitz
     matmul of the reduction, float32 result, in Gmac/s;
  3. per field, ``mont_mul_cios`` (kernel b, through fields/fp.py
     mont_mul) against ``mont_mul_sos_mxu``, checked equal over the whole
     batch before either is timed, and ``sos_mxu_speedup_vs_cios`` (the
     CIOS time over the SOS time) with ``"backend": "cuda"`` and the card.

Usage: python -m octopuszk_tpu_torch.scripts.mxu_experiment [log2_n]
(default 20; BN254a Fr and Fq).  Prints one JSON line per measurement.
It needs the card and raises without one, or if the two products differ.
"""

from __future__ import annotations

import json
import sys

import torch

from octopuszk_tpu_torch.fields import fp
from octopuszk_tpu_torch.fields.spec import FQ, FR
from octopuszk_tpu_torch.ops import mxu_mont
from octopuszk_tpu_torch.utils import device as _device


def _bench_s(fn, dev, iters: int = 20) -> float:
    """Seconds per call: two warm-up calls, then CUDA events around
    ``iters`` calls."""
    fn()
    fn()
    torch.cuda.synchronize(dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize(dev)
    return start.elapsed_time(end) / iters / 1e3


def _chain(x, y, op):
    for _ in range(8):
        x = op(x, y)
    return x


def _canonical(gen, n, dev):
    """Random words below 2^252 (< p for BN254a's Fr and Fq)."""
    w = torch.randint(-2**31, 2**31, (8, n), dtype=torch.int64, device=dev,
                      generator=gen).to(torch.int32)
    w[7] &= 0x0FFFFFFF
    return w


def main(log2n: int = 20, specs=(FR, FQ)) -> list:
    dev = _device.resolve(None)             # the card; raises without one
    n = 1 << log2n
    gen = torch.Generator(device=dev).manual_seed(7)
    results = []

    def rec(obj):
        results.append(obj)
        print(json.dumps(obj), flush=True)

    def rate(name, seconds, work, unit, **extra):
        rec({"metric": name, "n": n, **extra, "seconds": seconds,
             "rate": work / seconds / 1e9, "unit": unit})

    # --- elementwise operations, 8 chained per call
    a16 = torch.randint(0, 1 << 16, (16, n), dtype=torch.int32, device=dev,
                        generator=gen)
    b16 = torch.randint(0, 1 << 16, (16, n), dtype=torch.int32, device=dev,
                        generator=gen)
    af, bf = a16.float(), b16.float()
    for name, x, y, op in (("u32_mul", a16, b16, torch.mul),
                           ("u32_add", a16, b16, torch.add),
                           ("f32_mul", af, bf, torch.mul)):
        rate(name, _bench_s(lambda: _chain(x, y, op), dev) / 8, 16 * n,
             "Gop/s")

    # --- the reduction's Toeplitz matmul on the tensor cores
    _, p8 = mxu_mont.redc_mats(FR, dev)
    x8 = mxu_mont._split8(a16.to(torch.int64))
    rate("mxu_toeplitz_64x32",
         _bench_s(lambda: mxu_mont.matmul(p8, x8), dev), 64 * 32 * n,
         "Gmac/s")

    # --- the two Montgomery products, equal before they are timed
    card = torch.cuda.get_device_name(dev)
    for spec in specs:
        a, b = _canonical(gen, n, dev), _canonical(gen, n, dev)
        got_c = fp.mont_mul(spec, a, b)
        got_s = mxu_mont.mont_mul_sos_mxu(spec, a, b)
        differ = int((got_c != got_s).any(0).sum())
        if differ:
            raise AssertionError(f"{spec.name}: mont_mul_sos_mxu differs from "
                                 f"kernel (b) at {differ} of {n} elements")
        del got_c, got_s
        dt_c = _bench_s(lambda: fp.mont_mul(spec, a, b), dev)
        dt_s = _bench_s(lambda: mxu_mont.mont_mul_sos_mxu(spec, a, b), dev,
                        iters=5)
        rate("mont_mul_cios", dt_c, n, "Gelem/s", field=spec.name)
        rate("mont_mul_sos_mxu", dt_s, n, "Gelem/s", field=spec.name)
        rec({"metric": "sos_mxu_speedup_vs_cios", "field": spec.name,
             "value": dt_c / dt_s, "backend": "cuda", "device": card,
             "n": n, "equal": True})
    return results


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 20)
