#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port end to end on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``octopuszk_tpu_torch/csrc`` into ``build/``,
holds each kernel against its plain PyTorch version on the card (exact
equality: the values are integers), times both, then runs the serial
Groth16 path on BN254a at 2^20 constraints through the package's entry
points, in three ways that must give the same proof:

* ``packed``: serial_construct -> setup -> prove -> verify;
* ``unpacked``: the same CRS unpacked in memory into projective point
  batches (``msm.packed_to_points``), proved by the sort-based Pippenger
  (kernel h);
* ``streamed``: the same CRS written with ``serialize.save_crs`` to a
  temporary directory, read back with ``load_crs(stream=True)`` (queries in
  pinned host memory) and proved by staging them to the card.

The second curve, BN254b, has a path of its own (``bn254b``: construct ->
setup -> packed prove -> verify at the same size, then the same CRS
unpacked and proved through kernel h; both proofs equal, verified, a
tampered input rejected), its own kernel records (every kernel and variant
but the row gather, which knows no curve, at the main path's shapes; for
the two kernels whose plain version's time grows with its output, it
computes a part that stands alone, named in the record's ``plain_part``:
2^18 of g's 2^21 lanes, two of the fixed-base table's 17 windows) and two
MSMs in the ``oracle`` line; its path and the ``zksnark-large`` app must
launch every kernel they are built on with BN254b operands
(``kernels.CURVE_LAUNCHES``).  Every record carries its ``curve``.

The distributed prover has a path of its own (``dist``): construct at
the same size, a mesh of four shards (``parallel/mesh.py make_mesh(4)``:
shard i on card i % the cards present, all four on one card on a one-card
machine; each launch on its shard's card), ``shard_r1cs`` ->
``distributed_setup`` -> ``distributed_prove`` (the 4-step NTT with
all-to-alls, the per-shard MSMs and their reduction) -> ``verify``; its
proof must equal the packed path's point for point (the same seeds), a
tampered input must be rejected, and it must launch every kernel from (a)
to (g).  Then (``dist crs``) the distributed CRS gathered to the serial
form (``gather_crs``) and proved by the serial prover, and the packed
path's CRS sharded (``shard_crs``) and proved by ``distributed_prove``,
must both give the same proof.

The reference's test fields, which belong to no curve (SMALL, a 62-bit
NTT prime; LARGE, the 255-bit BLS12-381 scalar field), have a kernel
library of their own (``kernels.TEST_FIELDS``: the field kernels only),
their own records at BN254a's field shapes and a path (``test fields``:
at 2^20 elements each, ntt -> intt and coset_ntt -> coset_intt round
trips, the NTTs at three points against python ints, H = A B - C through
``mul_sub``, ``batch_inv_rows`` and ``fp.inv`` (kernel ``inv``) times
their input equal to one, ``pow_const``, a sample of 4,096 of each result
against python ints;
every field kernel must launch with the test fields' operands).  The
``mxu`` phase runs the port's tensor-core Montgomery experiment
(``scripts/mxu_experiment.py``: kernel b against ``ops/mxu_mont.py``,
BN254a Fr and Fq at 2^20, equal over the whole batch, its lines printed
as the script prints them).  The ``native`` line (before the kernel
records) times the host marshaling of 2^20 ints with the native library
(``utils/native.py``, built beside the kernels) and with numpy, says the
words are equal and which one the prover's ``assignment`` stage takes
(numpy's: ``bigint.ints_to_words``).

Then the packed path once more at four times the constraints (``path
2^22`` at the default ``--log2``: ``scripts/large_prove.py``'s ``run`` in
its streamed form, one setup, a prove with the queries on the card and the
same prove with them in pinned host memory, staged to the card chunk by
chunk; each verified, a tampered input rejected, each stage's device
memory in the path line's ``stage_bytes`` and each prove's own peak in
``stage_peak_bytes``, the bytes pinned and staged); the two proofs must be
equal word for word, and setup must cut each query's fixed-base
evaluation into two chunks of 2^``msm.FIXED_CHUNK_LOG`` scalars or more.

Then it runs the port's gather experiment (``gather``: kernel i against
``torch.index_select`` over 2^21 rows of 128 words), checks that an index
out of range makes kernel i fail (in child processes), and runs every
serial app of the port's profiler through ``profiler.main`` (``profiler
<app> <log2>``, the reference's apps and printed lines, plus ``zksnark``
with 1023 inputs; ``zksnark-large`` is Groth16 on BN254b); a verifying app
must verify, and the ``bace`` proof is
verified again beside a tampered one that must be rejected.  Then five
apps of the profiler's distributed form over four shards (``profiler 4
<app> <log2>``: fft, vmsm-g1, which runs kernel h per shard, witness,
zksnark-large, bace).

Each path and app runs with the launch counts set to 0 and must launch the
kernels it is built on.  Four variable-base MSMs (BN254a packed and
unpacked, BN254b G1 and G2 packed) are checked against python-int curve
arithmetic.

Output: one JSON object per line (``env`` with each library's build
seconds, ``native``, one ``path`` per path (``dist`` with the mesh's
devices; ``test fields`` with its checks per field; ``mxu``),
``profile``, ``oracle``, ``gather_out_of_range``, one ``profiler`` per app,
``launches``, ``kernels``;
the gather experiment's and the apps' own lines between them), then the
card's name and power limit as
``nvidia-smi`` prints them, then the result line.  Exits non-zero if there
is no CUDA device, if the build fails, if any comparison differs or any
phase raises.

After the three paths two more packed proves run, one on the host clock
and one under ``torch.profiler`` (``profile`` line: the warm prove's wall
time, stages and launches per wrapper, device busy time and idle share).
Every prove's stages split the witness map into its matvecs, transforms
and H (``witness-map:*``).  The ``kernels`` line holds, for each kernel
and variant, its time beside its bound, its plain version's and, where
one exists, a library call's, and its launches per path; a ``launches``
line holds the counts per path and kernel (and per curve); the ``env``
line holds ptxas's registers and spills for every kernel and unit.
``double_points`` has one record per doubling chain of the main path (the
Abel sum's, the window table's; the window combine's is now inside
``combine_windows``), timed per chain: one launch each.  The records of
chains (``double_points``, ``lane_row_sums``, ``tree_sum``,
``prefix_sum``, ``combine_windows``, ``mont_pow``) carry
``critical_path_rounds`` beside
the operations bound:
the dependent rounds of field products on one chain's path (one product a
round on a thread, up to four on a warp); ``inv`` the divsteps, matrix
updates and products of its slowest element.  The chains of
``mont_mul`` and ``add_points`` that run as one launch each (``mont_pow``,
``inv``, ``batch_inv_rows``, ``window_table``, ``lane_row_sums``,
``tree_sum``, ``prefix_sum``, ``combine_windows``) have records at the
main path's shapes (``combine_windows`` also at four accumulators, one
warp each; ``prefix_sum`` also at three short rows of 37, so that a row
has a tail past its tiles and classes of two lengths), and so has
``ntt_block``, which runs every stage of a
sub-transform in one launch: the two 4-step passes of the witness map's
coset NTT and coset iNTT, one 2^12 transform, and the coset NTT routed
through the nested 4-step (the cap lowered for the call, so that columns
and rows are 4-steps of their own) against the one-level 4-step, bit for
bit.  ``butterfly``, the
reference's per-stage kernel, keeps its record though no path launches it.

``--log2 N`` cuts the constraint count to 2^N (never below 2^13 on the
card: up to 2^12 the 4-step NTT is not run).
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import csv
import dataclasses
import json
import os
import random
import re
import subprocess
import sys
import tempfile
import time

import torch

from octopuszk_tpu_torch.curves import bn254, host_curve
from octopuszk_tpu_torch.curves.family import bn254b
from octopuszk_tpu_torch.fields import fp
from octopuszk_tpu_torch.fields.spec import FR
from octopuszk_tpu_torch.models.groth16 import (
    prover, serialize, setup, verifier)
from octopuszk_tpu_torch.ops import kernels, msm, ntt
from octopuszk_tpu_torch.parallel import dgroth16, mesh as pmesh
from octopuszk_tpu_torch.relations import construct
from octopuszk_tpu_torch.scripts import large_prove
from octopuszk_tpu_torch.utils import bigint, native

QUERIES = ("query_a", "query_b_g1", "query_b_g2", "query_h", "delta_abc_g1")

HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet
SM_COUNT, INT32_LANES_PER_SM = 132, 64
MADS_PER_MONT_MUL = 2 * 2 * 8 * 8   # 2*8*8 mad.lo/mad.hi pairs
ELEM_BYTES = 32

REPLACES = {
    "butterfly": "octopuszk_tpu/ops/pallas_ops.py:486",
    "mont_mul": "octopuszk_tpu/ops/pallas_ops.py:451",
    "mul_sub": "octopuszk_tpu/ops/pallas_ops.py:463",
    "add_points": "octopuszk_tpu/ops/pallas_ops.py:181",
    "double_points": "octopuszk_tpu/ops/pallas_ops.py:189",
    "scan_accumulate_mixed": "octopuszk_tpu/ops/pallas_ops.py:355",
    "scan_accumulate_mixed_total": "octopuszk_tpu/ops/pallas_ops.py:434",
    "scan_accumulate": "octopuszk_tpu/ops/pallas_ops.py:272",
    "row_gather": "scripts/gather_experiment.py:30",
    # the chains of (b) and (d) launches that run as one launch each
    "mont_pow": "octopuszk_tpu/ops/pallas_ops.py:451",
    "inv": "octopuszk_tpu/ops/pallas_ops.py:451",
    "batch_inv_rows": "octopuszk_tpu/ops/pallas_ops.py:451",
    "window_table": "octopuszk_tpu/ops/pallas_ops.py:181",
    "combine_windows": "octopuszk_tpu/ops/pallas_ops.py:181",
    "lane_row_sums": "octopuszk_tpu/ops/pallas_ops.py:181",
    "tree_sum": "octopuszk_tpu/ops/pallas_ops.py:181",
    "prefix_sum": "octopuszk_tpu/ops/pallas_ops.py:181",
    # (a)'s stage-per-launch chain as one launch per sub-transform
    "ntt_block": "octopuszk_tpu/ops/pallas_ops.py:486",
}
SOURCE = {
    "butterfly": "octopuszk_tpu_torch/csrc/field_kernels.cu",
    "mont_mul": "octopuszk_tpu_torch/csrc/field_kernels.cu",
    "mul_sub": "octopuszk_tpu_torch/csrc/field_kernels.cu",
    "add_points": "octopuszk_tpu_torch/csrc/ec_kernels.cu",
    "double_points": "octopuszk_tpu_torch/csrc/ec_kernels.cu",
    "scan_accumulate_mixed": "octopuszk_tpu_torch/csrc/scan_kernels.cu",
    "scan_accumulate_mixed_total": "octopuszk_tpu_torch/csrc/scan_kernels.cu",
    "scan_accumulate": "octopuszk_tpu_torch/csrc/scan_kernels.cu",
    "row_gather": "octopuszk_tpu_torch/csrc/gather_kernels.cu",
    "mont_pow": "octopuszk_tpu_torch/csrc/field_kernels.cu",
    "inv": "octopuszk_tpu_torch/csrc/field_kernels.cu",
    "batch_inv_rows": "octopuszk_tpu_torch/csrc/field_kernels.cu",
    "window_table": "octopuszk_tpu_torch/csrc/table_kernels.cu",
    "combine_windows": "octopuszk_tpu_torch/csrc/table_kernels.cu",
    "lane_row_sums": "octopuszk_tpu_torch/csrc/bucket_kernels.cu",
    "tree_sum": "octopuszk_tpu_torch/csrc/bucket_kernels.cu",
    "prefix_sum": "octopuszk_tpu_torch/csrc/prefix_kernels.cu",
    "ntt_block": "octopuszk_tpu_torch/csrc/ntt_kernels.cu",
}
# the kernels each path is built on: each must launch at least once there
_BUCKET_KERNELS = {"add_points", "prefix_sum", "lane_row_sums", "tree_sum",
                   "combine_windows"}
# inv: the proof points' affine conversion
_PROVE_KERNELS = {"ntt_block", "mont_mul", "mul_sub", "double_points",
                  "inv"} | _BUCKET_KERNELS
# butterfly: the reference's per-stage kernel, on no path since ntt_block
_GROTH16_KERNELS = set(REPLACES) - {"scan_accumulate", "row_gather",
                                    "butterfly"}
# the distributed setup takes t^n on the host: no mont_pow
_DIST_GROTH16_KERNELS = _GROTH16_KERNELS - {"mont_pow"}
_FIXED_KERNELS = {"double_points", "window_table", "mont_mul",
                  "batch_inv_rows", "scan_accumulate_mixed_total"}
REQUIRED = {
    "packed": _GROTH16_KERNELS,
    "unpacked": _PROVE_KERNELS | {"scan_accumulate"},
    "streamed": _PROVE_KERNELS | {"scan_accumulate_mixed"},
    "gather": {"row_gather"},
    # BN254b: construct, setup, a packed and an unpacked prove
    "bn254b": _GROTH16_KERNELS | {"scan_accumulate"},
    # four shards: construct, shard, setup, prove
    "dist": _DIST_GROTH16_KERNELS,
    # the gathered CRS proved serially, the sharded serial CRS proved
    # distributed
    "dist crs": _PROVE_KERNELS | {"scan_accumulate_mixed"},
    # the test fields' NTTs, products, chains and H = A B - C
    "test fields": {"ntt_block", "mont_mul", "mul_sub", "mont_pow", "inv",
                    "batch_inv_rows"},
    # the tensor-core experiment's baseline, kernel (b)
    "mxu": {"mont_mul"},
}
# The profiler's serial apps, as ``profiler.main`` runs them, each with the
# kernels its path reaches; all at the main path's size but those in
# PROFILER_CUTS.
PROFILER_APPS = [
    (["fft"], {"ntt_block"}),
    (["lagrange"], {"mont_mul", "mont_pow", "batch_inv_rows"}),
    (["fmsm-g1"], _FIXED_KERNELS),
    (["fmsm-g2"], _FIXED_KERNELS),
    (["vmsm-g1"], _FIXED_KERNELS | _BUCKET_KERNELS | {"scan_accumulate_mixed"}),
    (["vmsm-g2"], _FIXED_KERNELS | _BUCKET_KERNELS | {"scan_accumulate_mixed"}),
    (["relation"], {"mont_mul"}),
    (["witness"], {"ntt_block", "mont_mul", "mul_sub"}),
    (["zksnark"], _GROTH16_KERNELS),
    (["zksnark", "--inputs=1023"], _GROTH16_KERNELS),
    (["zksnark-large"], _GROTH16_KERNELS),
    (["bace"], {"ntt_block", "mont_mul"}),
    (["matmul"], _GROTH16_KERNELS),
    (["regression"], _GROTH16_KERNELS),
    (["gaussian"], _GROTH16_KERNELS),
]
# The distributed form over four shards, ``profiler 4 <app> <log2>``
DIST_SHARDS = 4
DIST_PROFILER_APPS = [
    ([str(DIST_SHARDS), "fft"], {"ntt_block", "mont_mul"}),
    ([str(DIST_SHARDS), "vmsm-g1"],
     _FIXED_KERNELS | _BUCKET_KERNELS | {"scan_accumulate"}),
    ([str(DIST_SHARDS), "witness"], {"ntt_block", "mont_mul", "mul_sub"}),
    ([str(DIST_SHARDS), "zksnark-large"], _DIST_GROTH16_KERNELS),
    ([str(DIST_SHARDS), "bace"], {"ntt_block", "mont_mul"}),
]
# log2 steps below the main path's size, for the apps whose host work
# outgrows the script's time budget (PERF.md): regression's verifier is a
# python-int MSM over every public input, about 0.95 x its constraints
# (249,053 at 2^18: 156-361 s of the script, whose host time doubles
# between calls), gaussian took 116 s at 2^20 and matmul 22-28 s
PROFILER_CUTS = {"regression": 2, "gaussian": 2, "matmul": 2}
# the apps that run on BN254b: their kernels must launch with its operands
PROFILER_CURVES = {"zksnark-large": "bn254b"}
# field products per curve operation (products + those inside mul_b3)
MONT_MULS = {("add", 1): 12, ("add", 2): 12 * 3 + 2 * 3,
             ("double", 1): 8, ("double", 2): 8 * 3 + 3,
             ("mixed", 1): 11, ("mixed", 2): 11 * 3 + 2 * 3,
             ("identity add", 1): 3, ("identity add", 2): 3 * 3}
# operations of field.cuh's safegcd inversion: a divstep is 23 32-bit
# instructions in the compiled code (sm_90a SASS of inv_kernel); a batch
# of 30 divsteps' matrix updates, 90 32 x 32 -> 64-bit multiply-adds,
# counted as two 32-bit multiply-adds each (as a product's mad.lo / mad.hi
# pairs are)
DIVSTEP_OPS, BATCH_MADS = 23, 2 * 90
# dependent rounds of products per curve operation on one warp (lanes.cuh:
# a formula's independent products four at a time on the warp's 8-lane
# groups, an Fp2 product three of them; on G1 the products by b3 are adds)
WARP_ROUNDS = {("add", 1): 2 + 2, ("add", 2): 5 + 2 + 5,
               ("double", 1): 1 + 1, ("double", 2): 3 + 1 + 3}
# products in turn per add on each thread of a pair (rcb.cuh pt_add_pair:
# half of each level, and on G2 one of the two products by b3; the tree's
# levels and lane_row_sums' rows run one such add each)
PAIR_ROUNDS = {1: 3 + 3, 2: 9 + 3 + 9}
# products in turn per add of prefix_sum's kernel: one thread an add on G1
# (pt_add), a pair on G2 (pt_add_pair)
PREFIX_ROUNDS = {1: MONT_MULS["add", 1], 2: PAIR_ROUNDS[2]}


def prefix_mads(cd: int, batch: int, n: int) -> int:
    """Multiply-adds of prefix_sum's dataflow over [batch, n]: every
    element of every level an add, those of the identity (element j < 2^l
    at level l) at the 3 products that make them (rcb.cuh
    pt_add_identity: X Y, Y^2, Y Z), the others complete."""
    levels = (n - 1).bit_length()
    ident = sum(min(1 << lv, n) for lv in range(levels))
    prods = ((n * levels - ident) * MONT_MULS["add", cd]
             + ident * MONT_MULS["identity add", cd])
    return batch * MADS_PER_MONT_MUL * prods


def emit(obj):
    print(json.dumps(obj), flush=True)


def smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def time_ms(fn, dev, reps: int):
    """Mean time of one call: CUDA events around ``reps`` calls after two
    warm-up calls, synchronised.  Each call allocates its output while the
    previous one is still held, so the caching allocator settles on two
    alternating blocks only after the second call; before that the timed
    calls would include a device allocation.  Returns (ms, the last timed
    call's output)."""
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


# ---------------------------------------------------------------------------
# random inputs (made on the device from a seed)
# ---------------------------------------------------------------------------

def rand_field(gen, shape, dev):
    """Canonical field elements int32[8, *shape]: random words with the top
    word below 2^28, so the value is below 2^252 < p for Fr and Fq."""
    w = torch.randint(-2**31, 2**31, (8,) + tuple(shape), dtype=torch.int64,
                      device=dev, generator=gen).to(torch.int32)
    w[7] &= 0x0FFFFFFF
    return w


def rand_elems(gen, spec, shape, dev):
    """Canonical elements of any field, int32[8, *shape], over all of [0,
    p): random words below 2^b (b the modulus's bits, so below 2p), then
    one conditional subtract of p."""
    bits = spec.p.bit_length()
    w = torch.randint(-2**31, 2**31, (8,) + tuple(shape), dtype=torch.int64,
                      device=dev, generator=gen) & 0xFFFFFFFF
    full, rest = divmod(bits, 32)
    if full < 8:
        w[full] &= (1 << rest) - 1
        w[full + 1:] = 0
    return fp._i32(fp._cond_sub_p(spec, w))


def rand_point(gen, cd, shape, dev):
    """Three (G1) or six (G2) random coordinate components.  The formulas
    are polynomial, so kernel and plain version must agree on any field
    elements, on the curve or not."""
    comps = [rand_field(gen, shape, dev) for _ in range(3 * cd)]
    if cd == 1:
        return tuple(comps)
    return tuple((comps[i], comps[i + 1]) for i in range(0, 6, 2))


def rand_packed(gen, cd, n, dev):
    """A packed base of n rows with some identity (all-zero) rows."""
    rows = torch.cat([rand_field(gen, (n,), dev) for _ in range(2 * cd)]).T
    rows = rows.contiguous()
    rows[torch.rand(n, device=dev, generator=gen) < 0.05] = 0
    return rows


def flat(x):
    out = []
    for c in x if isinstance(x, (tuple, list)) else (x,):
        out.extend(flat(c) if isinstance(c, (tuple, list)) else [c])
    return out


def same(a, b) -> bool:
    fa, fb = flat(a), flat(b)
    return len(fa) == len(fb) and all(torch.equal(x, y) for x, y in zip(fa, fb))


# ---------------------------------------------------------------------------
# phase: every kernel against its plain version
# ---------------------------------------------------------------------------

def mads_per_product(spec) -> int:
    """The mad.lo / mad.hi pairs of a CIOS Montgomery product of the
    field's own width, w = ceil(bits / 32) words: w^2 for a * b and w^2
    for m * p, two MADs each (MADS_PER_MONT_MUL at w = 8)."""
    w = -(-spec.p.bit_length() // 32)
    return 2 * 2 * w * w


def fermat_products(spec) -> int:
    """Squares and products of the chain a^(p-2)."""
    pm2 = spec.p_minus_2
    return (pm2.bit_length() - 1) + (bin(pm2).count("1") - 1)


def divsteps_needed(x: int, p: int) -> int:
    """The divsteps of field.cuh's safegcd (zeta = -1 at the start, f = p,
    g = x) after which g is zero."""
    zeta, f, g, n = -1, p, x, 0
    while g:
        if g & 1:
            if zeta < 0:
                zeta, f, g = -zeta - 2, g, (g - f) >> 1
            else:
                zeta, g = zeta - 1, (g + f) >> 1
        else:
            zeta, g = zeta - 1, g >> 1
        n += 1
    return n


def safegcd_work(spec, a):
    """What the inversions of the elements of ``a`` need, from their
    values: (operations: each element's divsteps until g is zero, the
    matrix updates of its batches of 30 and the product by R^3; the
    critical path of the slowest element: its divsteps in whole batches,
    its matrix updates, one product)."""
    steps = [divsteps_needed(x, spec.p)
             for x in bigint.words_to_ints(a.cpu().numpy())]
    batches = [-(-s // 30) for s in steps]
    ops = sum(s * DIVSTEP_OPS + b * BATCH_MADS + mads_per_product(spec)
              for s, b in zip(steps, batches))
    return ops, {"divsteps": 30 * max(batches),
                 "matrix_updates": max(batches), "products": 1}


def bound(bytes_moved: float, mads: float, int32_rate: float):
    by_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    by_ops = mads / int32_rate * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def recorder(dev, reps: int, int32_rate: float, curve: str, records: list):
    """The function that times one kernel record of a library (``curve``:
    a curve's, or the test fields') and appends it to ``records``."""

    def record(name, variant, shape, kernel_fn, plain_fn, bytes_moved, mads,
               library_fn=None, part=None, critical=None):
        """kernel_fn, at ``shape``, is timed, and the output of its last
        timed launch is compared with plain_fn on the same inputs;
        library_fn, where given, is one PyTorch call that computes the same
        function, timed likewise.  ``part``: (what, take) where plain_fn
        computes only a part of the output, ``take`` cuts that part from
        the kernel's output (``plain_ms`` is then the part's time).
        ``critical``: for a chain, its critical path in dependent rounds of
        field products (``critical_path_rounds``; a round is one product on
        one thread, up to four on a warp, lanes.cuh; for ``inv`` a dict of
        divsteps, matrix updates and products), beside the operations
        bound."""
        ms, got = time_ms(kernel_fn, dev, reps)
        if part is not None:
            got = part[1](got)
        library_ms = None
        if library_fn is not None:
            library_ms, _ = time_ms(library_fn, dev, reps)
        for _ in range(2):          # a second pass where the first was short
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            want = plain_fn()
            torch.cuda.synchronize(dev)
            plain_ms = (time.perf_counter() - t0) * 1e3
            if plain_ms > 1000:
                break
        ok = same(got, want)
        diff = max((int((x.to(torch.int64) - y.to(torch.int64)).abs().max())
                    for x, y in zip(flat(got), flat(want))), default=0)
        del got, want
        b_ms, b_by = bound(bytes_moved, mads, int32_rate)
        records.append({
            "name": name, "curve": curve, "variant": variant, "route": "cuda",
            "source": SOURCE[name], "replaces": REPLACES[name],
            "shape": shape, "equal": ok, "max_abs_err": diff, "ms": ms,
            "plain_ms": plain_ms, "plain_part": part and part[0],
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms,
            "critical_path_rounds": critical, "tolerance": "exact"})
        if not ok:
            raise SystemExit(f"kernel {name} ({variant}) differs from its "
                             f"plain version: {records[-1]}")

    return record


def ntt_records(record, gen, dev, log2: int, spec, tag: str, rand):
    """``ntt_block`` records of a field: the two 4-step passes of the
    witness map's coset NTT (columns with the coset powers as pre and the
    twiddles as post; rows through the transposed view) and of its coset
    iNTT (columns with the twiddles; rows with g^-i / n as post), at the
    domain of 2^log2, the tables as ops/ntt.py caches them; and one
    transform of 2^12 (B = 1), the longest one launch takes.  ``rand(gen,
    shape, dev)`` makes the inputs.  Bound: one product of the field's
    width per butterfly and per table element; bytes: x, the output, the tables once (a broadcast
    table counted as stored)."""

    def one(variant, x, tw, dif, pre, post):
        L = x.shape[1]
        count = x.numel() // (8 * L)
        tables = [t for t in (pre, post) if t is not None]
        prods = count * ((L // 2) * (L.bit_length() - 1) + L * len(tables))
        moved = ELEM_BYTES * (2 * x.numel() // 8 + tw.numel() // 8 + sum(
            t.untyped_storage().nbytes() // 4 // 8 for t in tables))
        record("ntt_block", variant, list(x.shape),
               lambda: kernels.ntt_block(spec, x, tw, dif, pre, post),
               lambda: kernels.ntt_block_plain(spec, x, tw, dif, pre, post),
               moved, mads_per_product(spec) * prods)

    n = 1 << log2
    R, C = 1 << ((log2 + 1) // 2), 1 << (log2 // 2)
    for inverse in (False, True):
        what = "coset iNTT" if inverse else "coset NTT"
        tw4 = ntt._four_step_twiddles(spec, R, C, inverse, dev)[..., None]
        coset = ntt._coset_table(spec, n, inverse, dev)
        x = rand(gen, (R, C, 1), dev)
        pre = None if inverse else coset.reshape(8, R, C, 1)
        one(f"{tag} 2^{log2} {what}, columns", x,
            ntt._stage_twiddles(spec, R, inverse, dev), not inverse, pre, tw4)
        post = coset.reshape(8, C, R, 1) if inverse else None
        one(f"{tag} 2^{log2} {what}, rows (transposed view)",
            rand(gen, (R, C, 1), dev).permute(0, 2, 1, 3),
            ntt._stage_twiddles(spec, C, inverse, dev), not inverse, None,
            post)
        del tw4, coset, x, pre, post
    L1 = kernels.NTT_BLOCK_MAX
    one(f"{tag} 2^{L1.bit_length() - 1} iNTT, one launch (B = 1)",
        rand(gen, (L1, 1), dev), ntt._stage_twiddles(spec, L1, True, dev),
        False, None, ntt._scale(spec, L1, dev)[:, :, None])


def nested_ntt_record(record, records, gen, dev, log2: int, spec,
                      tag: str):
    """``ntt_block`` through the nested 4-step: the coset NTT of 2^log2
    (BN254a: the witness map's) with the sub-transform cap
    (``ntt.BLOCK_MAX``) lowered for the call to half the columns' length,
    so that columns and rows are 4-steps of their own, with their tables
    applied by ``mont_mul`` (the route of a 2^25 domain's columns of 2^13
    under the cap of 2^12).  Held bit for bit against the same transform
    through the one-level 4-step on the kernels (``equals_one_level``, its
    time ``one_level_ms``) and on ``ntt_block``'s plain version (``plain_ms``).
    Bound: the one-level 4-step's work, one product a butterfly and one a
    coset power and a twiddle; bytes: x, the output and the two tables."""
    n = 1 << log2
    R, C = 1 << ((log2 + 1) // 2), 1 << (log2 // 2)
    cap = R // 2
    x = rand_field(gen, (n,), dev)

    def nested():
        saved, ntt.BLOCK_MAX = ntt.BLOCK_MAX, cap
        try:
            return ntt.coset_ntt(spec, x)
        finally:
            ntt.BLOCK_MAX = saved

    def one_level(block):
        tw4 = ntt._four_step_twiddles(spec, R, C, False, dev)[..., None]
        pre = ntt._coset_table(spec, n, False, dev).reshape(8, R, C, 1)
        y = block(spec, x.reshape(8, R, C, 1),
                  ntt._stage_twiddles(spec, R, False, dev), True, pre, tw4)
        return block(spec, y.permute(0, 2, 1, 3),
                     ntt._stage_twiddles(spec, C, False, dev), True, None,
                     None).reshape(8, n)

    record("ntt_block", f"{tag} 2^{log2} coset NTT through the nested "
           f"4-step (cap 2^{cap.bit_length() - 1}: columns 2^{R.bit_length() - 1}"
           f" and rows 2^{C.bit_length() - 1} as 4-steps)", [8, n], nested,
           lambda: one_level(kernels.ntt_block_plain), 4 * ELEM_BYTES * n,
           mads_per_product(spec) * (n // 2 * log2 + 2 * n))
    one_ms, want = time_ms(lambda: one_level(kernels.ntt_block), dev, 5)
    equal = bool(torch.equal(nested(), want))
    records[-1].update(equals_one_level=equal, one_level_ms=one_ms)
    if not equal:
        raise SystemExit(f"the nested 4-step differs from the one-level "
                         f"4-step: {records[-1]}")


def check_test_field_kernels(dev, log2: int, int32_rate: float, reps: int):
    """The records of the test fields' library (SMALL, LARGE: the field
    kernels built for fields of no curve) at BN254a's main-path shapes:
    ``butterfly`` [8, 2^(log2-1)] (off the path), ``ntt_block``'s coset
    passes at 2^log2 and its 2^12 transform, ``mont_mul`` and ``mul_sub``
    [8, 2^log2], ``mont_pow`` of p - 2 and ``inv`` [8, 1] and [8, 4096],
    ``batch_inv_rows`` [8, 2^log2] with 5 % zeros.  A bound counts the
    products of the field's own width (``mads_per_product``: SMALL's two
    words, though the kernels run the eight-word CIOS for every field); a
    Fermat chain counts the squares and products of this field's p - 2,
    ``inv`` the divsteps and updates its inputs need (``safegcd_work``)."""
    gen = torch.Generator(device=dev).manual_seed(21)
    records = []
    record = recorder(dev, reps, int32_rate, kernels.TEST_FIELDS, records)
    n, half = 1 << log2, 1 << (log2 - 1)
    fields = kernels.LIBRARIES[kernels.TEST_FIELDS]
    for spec, tag in zip(fields.specs(), fields.tags):
        def rand(g, shape, d, spec=spec):
            return rand_elems(g, spec, shape, d)

        mads = mads_per_product(spec)

        for dif in (True, False):
            a, b, w = (rand(gen, (half,), dev) for _ in range(3))
            record("butterfly", f"{tag} {'DIF' if dif else 'DIT'} (off the "
                   "path)", [8, half],
                   lambda: kernels.butterfly(spec, a, b, w, dif),
                   lambda: kernels.butterfly_plain(spec, a, b, w, dif),
                   5 * ELEM_BYTES * half, mads * half)
        ntt_records(record, gen, dev, log2, spec, tag, rand)
        a, b, c = (rand(gen, (n,), dev) for _ in range(3))
        record("mont_mul", tag, [8, n],
               lambda: kernels.mont_mul(spec, a, b),
               lambda: kernels.mont_mul_plain(spec, a, b),
               3 * ELEM_BYTES * n, mads * n)
        record("mul_sub", tag, [8, n],
               lambda: kernels.mul_sub(spec, a, b, c),
               lambda: kernels.mul_sub_plain(spec, a, b, c),
               4 * ELEM_BYTES * n, mads * n)
        inversion_records(record, gen, spec, tag, "p - 2", rand, dev)
        a = rand(gen, (n,), dev)
        a[:, torch.rand(n, device=dev, generator=gen) < 0.05] = 0
        nonzero = int((a != 0).any(0).sum())
        record("batch_inv_rows", f"{tag}, {min(kernels.INV_LANES, n)} lanes",
               [8, n],
               lambda: kernels.batch_inv_rows(spec, a),
               lambda: kernels.batch_inv_rows_plain(spec, a),
               2 * ELEM_BYTES * n, mads * 3 * nonzero)
        del a, b, c, w
    drop_test_field_tables()
    return records


def inversion_records(record, gen, spec, tag: str, pm2_name: str, rand, dev):
    """``mont_pow`` of p - 2 (the Fermat chain, a general exponent for the
    kernel) and ``inv`` (safegcd) on the same inputs, [8, 1] (a proof
    point's affine conversion) and [8, 4096]; the plain version of both is
    the Fermat chain.  Bounds: the chain's products; the divsteps and
    updates these inputs need (``safegcd_work``)."""
    pm2, mads = spec.p_minus_2, mads_per_product(spec)
    fermat = fermat_products(spec)
    for cnt in (1, 4096):
        a = rand(gen, (cnt,), dev)
        record("mont_pow", f"{tag}, {pm2_name}", [8, cnt],
               lambda: kernels.mont_pow(spec, a, pm2),
               lambda: kernels.mont_pow_plain(spec, a, pm2),
               2 * ELEM_BYTES * cnt, mads * fermat * cnt, critical=fermat)
        ops, crit = safegcd_work(spec, a)
        record("inv", f"{tag}, safegcd", [8, cnt],
               lambda: kernels.inv(spec, a),
               lambda: kernels.inv_plain(spec, a),
               2 * ELEM_BYTES * cnt, ops, critical=crit)


def drop_test_field_tables():
    """Free the NTT tables that the test fields' phases left in ops/ntt.py's
    cache (about 0.3 GB at 2^20), so that the later paths' peak memory
    counts only their own."""
    names = {s.name for s in kernels.LIBRARIES[kernels.TEST_FIELDS].specs()}
    for key in [k for k in ntt._TABLES if k[1] in names]:
        del ntt._TABLES[key]
    torch.cuda.empty_cache()


# the lanes of (g) whose totals a part-only check holds to the plain version
PART_LANES = 1 << 18


def check_kernels(dev, log2: int, int32_rate: float, reps: int,
                  curve: str = "bn254a", whole: bool = True):
    """Returns one record per kernel and variant of a curve, every kernel
    launched at the shapes the main path gives it at 2^log2 constraints.
    ``whole``: compare the whole output with the plain version; else, for
    (g) and the window table, whose plain versions' time grows with their
    lanes and windows, a part of the output that stands alone (named in
    the record's ``plain_part``; the plain version computes that part
    only).  The row
    gather, which knows no curve, has its records with the first curve."""
    gen = torch.Generator(device=dev).manual_seed(20)
    records = []
    cv = kernels.LIBRARIES[curve].bundle()
    fr, fq = cv.fr, cv.fq
    groups = ((1, cv.g1.name), (2, cv.g2.name))

    record = recorder(dev, reps, int32_rate, curve, records)

    n = 1 << log2
    # (a) butterfly: one stage over the 2^log2 elements pairs half of them
    # (the reference's per-stage kernel; no path launches it since
    # ntt_block; the Fq instance is built as well)
    half = n // 2
    for spec, tag in ((fr, "Fr"), (fq, "Fq")):
        for dif in (True, False):
            a, b, w = (rand_field(gen, (half,), dev) for _ in range(3))
            record("butterfly", f"{tag} {'DIF' if dif else 'DIT'} (off the "
                   "path since ntt_block)", [8, half],
                   lambda: kernels.butterfly(spec, a, b, w, dif),
                   lambda: kernels.butterfly_plain(spec, a, b, w, dif),
                   5 * ELEM_BYTES * half, MADS_PER_MONT_MUL * half)
    ntt_records(record, gen, dev, log2, fr, "Fr", rand_field)
    if curve == "bn254a":
        nested_ntt_record(record, records, gen, dev, log2, fr, "Fr")
    # (b) mont_mul: Fr at the NTT size, Fq at the packed-query size
    for spec, tag, cnt in ((fr, "Fr", n), (fq, "Fq", 2 * n)):
        a, b = rand_field(gen, (cnt,), dev), rand_field(gen, (cnt,), dev)
        record("mont_mul", tag, [8, cnt],
               lambda: kernels.mont_mul(spec, a, b),
               lambda: kernels.mont_mul_plain(spec, a, b),
               3 * ELEM_BYTES * cnt, MADS_PER_MONT_MUL * cnt)
    # (b)'s chains: the inversion of one element (an MSM result's affine
    # conversion) and of 4,096, by ``inv`` and by the Fermat chain of
    # ``mont_pow``; ``mont_pow`` at its main-path use, t^n in
    # lagrange_coeffs; the batch inversion of a packed query (2^(log2+1)
    # points, some zero) and of a fixed-base table (17 windows of 2^15 at
    # 2^20).  A batch inversion needs 3 products per non-zero element and
    # one inversion (about 2e4 operations, below 1e-5 of the rest: left
    # out, which only lowers the bound), however it groups its lanes.
    inversion_records(record, gen, fq, "Fq", "q - 2", rand_field, dev)
    t1 = rand_field(gen, (1,), dev)
    record("mont_pow", f"Fr, t^n, n = 2^{log2} (lagrange_coeffs)", [8, 1],
           lambda: kernels.mont_pow(fr, t1, n),
           lambda: kernels.mont_pow_plain(fr, t1, n),
           2 * ELEM_BYTES, MADS_PER_MONT_MUL * log2, critical=log2)
    w_table = msm._choose_w_packed(2 * n)
    table_entries = -(-msm.SCALAR_BITS // w_table) << w_table
    for cnt in (2 * n, table_entries):
        a = rand_field(gen, (cnt,), dev)
        a[:, torch.rand(cnt, device=dev, generator=gen) < 0.05] = 0
        nonzero = int((a != 0).any(0).sum())
        record("batch_inv_rows", f"Fq, {min(kernels.INV_LANES, cnt)} lanes",
               [8, cnt],
               lambda: kernels.batch_inv_rows(fq, a),
               lambda: kernels.batch_inv_rows_plain(fq, a),
               2 * ELEM_BYTES * cnt, MADS_PER_MONT_MUL * 3 * nonzero)
    # (c) mul_sub
    for spec, tag in ((fr, "Fr"), (fq, "Fq")):
        a, b, c = (rand_field(gen, (n,), dev) for _ in range(3))
        record("mul_sub", tag, [8, n],
               lambda: kernels.mul_sub(spec, a, b, c),
               lambda: kernels.mul_sub_plain(spec, a, b, c),
               4 * ELEM_BYTES * n, MADS_PER_MONT_MUL * n)
    del a, b, c, w

    # Pippenger plan of the main path: queries padded to 2^(log2+1)
    _, lanes, chunk_m, _ = msm._plan_packed(2 * n, None, 22)
    rows = chunk_m // lanes
    cwin = msm._choose_c_large(chunk_m)
    num_win = -(-255 // cwin)
    nb = (1 << (cwin - 1)) + 1
    w_fixed = msm._choose_w_packed(2 * n) if 2 * n >= msm.FIXED_PACKED_MIN \
        else msm._choose_w(2 * n)
    outerc = -(-msm.SCALAR_BITS // w_fixed)
    for cd, g in groups:
        pt_bytes = 3 * cd * ELEM_BYTES
        add_mads = MONT_MULS["add", cd] * MADS_PER_MONT_MUL
        # (d) add_points at the bucket phase's shape [num_win, 2^(c-1)+1]
        p = rand_point(gen, cd, (num_win, nb), dev)
        q = rand_point(gen, cd, (num_win, nb), dev)
        cnt = num_win * nb
        record("add_points", g, [8, num_win, nb],
               lambda: kernels.add_points(g, p, q),
               lambda: kernels.add_points_plain(g, p, q),
               3 * pt_bytes * cnt, add_mads * cnt)
        # (d)'s chains at the main path's shapes: the fixed-base table of
        # one base; the Abel sum's row loop (msm._scan_sum over 2^(c-1)
        # buckets in 2,048 lanes) and its tree across the lanes; the lane
        # prefix of the bucket sums (4,096 lanes); the window combine
        # (an entry's masked adds run in increasing bit order, so the entry
        # without its top bit is the prefix of its chain: the same words
        # need one add per entry with a non-zero digit)
        # (a part: the first and the last window; window k alone is the
        # table of one window of the base [2^(k w)] G = powers[k w - 1])
        base1 = rand_point(gen, cd, (), dev)
        powers = rand_point(gen, cd, (outerc * w_fixed,), dev)
        entries = outerc << w_fixed
        ends = [0, outerc - 1]

        def table_part():
            parts = [flat(kernels.window_table_plain(
                g, base1 if k == 0 else msm._map_coords(
                    powers, lambda c: c[..., k * w_fixed - 1]),
                msm._map_coords(powers, lambda c: c[..., k * w_fixed:]),
                w_fixed, 1)) for k in ends]
            return [torch.cat(cs, dim=1) for cs in zip(*parts)]

        record("window_table", f"{g}, w = {w_fixed}, outerc = {outerc}",
               [8, outerc, 1 << w_fixed],
               lambda: kernels.window_table(g, base1, powers, w_fixed, outerc),
               (lambda: kernels.window_table_plain(g, base1, powers, w_fixed,
                                                   outerc)) if whole
               else table_part,
               pt_bytes * (1 + outerc * w_fixed + entries),
               add_mads * (entries - outerc),
               part=None if whole else (
                   f"windows {ends} of {outerc}",
                   lambda out: [c[:, ends] for c in flat(out)]))
        del base1, powers
        nbk = nb - 1
        width = min(2048, nbk)
        rows_s = -(-nbk // width)
        rest = rand_point(gen, cd, (num_win, nbk), dev)
        record("lane_row_sums", f"{g} [{num_win} win, {width} lanes, "
               f"{rows_s} rows]", [8, num_win, nbk],
               lambda: kernels.lane_row_sums(g, rest, width),
               lambda: kernels.lane_row_sums_plain(g, rest, width),
               pt_bytes * num_win * (nbk + width),
               add_mads * num_win * width * rows_s,
               critical=rows_s * PAIR_ROUNDS[cd])
        del rest
        tot = rand_point(gen, cd, (num_win, width), dev)
        lt = rand_point(gen, cd, (num_win, lanes), dev)
        tree_levels = (width - 1).bit_length()
        tree_nodes = sum(-(-width // (2 << lv)) for lv in range(tree_levels))
        levels = (lanes - 1).bit_length()
        record("tree_sum", f"{g} [{num_win} win, {width} lanes]",
               [8, num_win, width],
               lambda: kernels.tree_sum(g, tot),
               lambda: kernels.tree_sum_plain(g, tot),
               pt_bytes * num_win * (width + 1),
               add_mads * num_win * tree_nodes,
               critical=tree_levels * PAIR_ROUNDS[cd])
        record("prefix_sum", f"{g} [{num_win} win, {lanes} lanes]",
               [8, num_win, lanes],
               lambda: kernels.prefix_sum(g, lt),
               lambda: kernels.prefix_sum_plain(g, lt),
               2 * pt_bytes * num_win * lanes,
               prefix_mads(cd, num_win, lanes),
               critical=levels * PREFIX_ROUNDS[cd])
        # a row's tail past its tiles, classes of two lengths
        short = rand_point(gen, cd, (3, 37), dev)
        record("prefix_sum", f"{g} [3 rows, 37 lanes] (not a main-path "
               "shape)", [8, 3, 37],
               lambda: kernels.prefix_sum(g, short),
               lambda: kernels.prefix_sum_plain(g, short),
               2 * pt_bytes * 3 * 37, prefix_mads(cd, 3, 37),
               critical=6 * PREFIX_ROUNDS[cd])
        del tot, lt, short
        # the main path's one accumulator, and four (one warp each)
        for acc_shape, variant in (
                ((), f"{g} [{num_win} windows], c = {cwin}"),
                ((4,), f"{g} [4 x {num_win} windows], c = {cwin} (not a "
                       "main-path shape)")):
            nacc = 4 if acc_shape else 1
            wins = rand_point(gen, cd, acc_shape + (num_win,), dev)
            record("combine_windows", variant, [8, *acc_shape, num_win],
                   lambda: kernels.combine_windows(g, wins, cwin),
                   lambda: kernels.combine_windows_plain(g, wins, cwin),
                   pt_bytes * nacc * (num_win + 1),
                   MADS_PER_MONT_MUL * nacc * num_win * (
                       cwin * MONT_MULS["double", cd] + MONT_MULS["add", cd]),
                   critical=num_win * (cwin * WARP_ROUNDS["double", cd]
                                       + WARP_ROUNDS["add", cd]))
        del wins
        # (e) double_points: one double of one point per window, the
        # doubling chains of the main path in one launch each (the Abel
        # sum's c - 1 on one point per window, the window combine's c on
        # one point, the fixed-base window table's outerc * w on one point,
        # every step kept), and one double over 2^16 points
        p1 = _first(p)
        record("double_points", g, [8, num_win],
               lambda: kernels.double_points(g, p1),
               lambda: kernels.double_points_plain(g, p1),
               6 * cd * ELEM_BYTES * num_win,
               MONT_MULS["double", cd] * MADS_PER_MONT_MUL * num_win,
               critical=MONT_MULS["double", cd])
        one = _first(p1)
        for variant, pt, times, every in (
                ("Abel chain", p1, cwin - 1, False),
                ("window combine chain (off the path: combine_windows)",
                 one, cwin, False),
                ("window table chain, every step", one, outerc * w_fixed,
                 True)):
            npts = jac_leaf(pt).numel() // 8
            outs = npts * (times if every else 1)
            record("double_points", f"{g} {variant}, times = {times}",
                   [8, *jac_leaf(pt).shape[1:]],
                   lambda: kernels.double_points(g, pt, times, every),
                   lambda: kernels.double_points_plain(g, pt, times, every),
                   3 * cd * ELEM_BYTES * (npts + outs),
                   MONT_MULS["double", cd] * MADS_PER_MONT_MUL * npts * times,
                   critical=times * (WARP_ROUNDS["double", cd] if times > 1
                                     else MONT_MULS["double", cd]))
        record("double_points", g + " (2^16 points, not a main-path shape)",
               [8, num_win, nb],
               lambda: kernels.double_points(g, p),
               lambda: kernels.double_points_plain(g, p),
               6 * cd * ELEM_BYTES * cnt,
               MONT_MULS["double", cd] * MADS_PER_MONT_MUL * cnt,
               critical=MONT_MULS["double", cd])
        del p, q, p1, one

        # (f) scan_accumulate_mixed: all windows of the one chunk
        base = rand_packed(gen, cd, chunk_m, dev)
        idx2 = torch.stack([
            (torch.randperm(chunk_m, device=dev, generator=gen) << 1)
            | torch.randint(0, 2, (chunk_m,), device=dev, generator=gen)
            for _ in range(num_win)]).to(torch.int32)
        view = idx2.view(num_win, lanes, rows).transpose(1, 2)
        live = int((base[(idx2 >> 1).long().reshape(-1)] != 0).any(1).sum())
        record("scan_accumulate_mixed", g, [num_win, rows, lanes],
               lambda: kernels.scan_accumulate_mixed(g, base, view),
               lambda: kernels.scan_accumulate_mixed_plain(g, base, view),
               base.numel() * 4 + idx2.numel() * 4
               + 3 * cd * ELEM_BYTES * idx2.numel(),
               MONT_MULS["mixed", cd] * MADS_PER_MONT_MUL * live)
        del base, idx2, view

        # (g) scan_accumulate_mixed_total: fixed-base evaluation, one lane
        # per scalar of the 2^(log2+1) bucket, one row per window (a part:
        # the last PART_LANES lanes; the lanes are independent)
        w = w_fixed
        table = rand_packed(gen, cd, outerc << w, dev)
        table[:: 1 << w] = 0        # digit 0 of every window: the identity
        digits = torch.randint(0, 1 << w, (outerc, 2 * n), device=dev,
                               generator=gen)
        digits += torch.arange(outerc, device=dev)[:, None] << w
        idx2 = (digits << 1).to(torch.int32)[None]
        live = int((table[digits.reshape(-1)] != 0).any(1).sum())
        pl = min(PART_LANES, 2 * n)
        record("scan_accumulate_mixed_total", g, [1, outerc, 2 * n],
               lambda: kernels.scan_accumulate_mixed_total(g, table, idx2),
               lambda: _total_plain_sliced(
                   g, table, idx2 if whole else idx2[:, :, -pl:]),
               table.numel() * 4 + idx2.numel() * 4
               + 3 * cd * ELEM_BYTES * 2 * n,
               MONT_MULS["mixed", cd] * MADS_PER_MONT_MUL * live,
               part=None if whole else (
                   f"lanes {2 * n - pl}..{2 * n - 1} of {2 * n}",
                   lambda out: [c[..., -pl:] for c in flat(out)]))
        del table, digits, idx2

        # (h) scan_accumulate: the unpacked prove's Pippenger, all windows
        # of one MSM over a 2^(log2+1) query in one launch
        npts = 2 * n
        c_u, lanes_u = msm._choose_c(npts), msm._choose_lanes(npts)
        rows_u, win_u = npts // lanes_u, -(-msm.SCALAR_BITS // c_u)
        pts = rand_point(gen, cd, (npts,), dev)
        order = torch.stack([torch.randperm(npts, device=dev, generator=gen)
                             for _ in range(win_u)]).to(torch.int32)
        view = order.view(win_u, lanes_u, rows_u).transpose(1, 2)
        record("scan_accumulate", g, [win_u, rows_u, lanes_u],
               lambda: kernels.scan_accumulate(g, pts, view),
               lambda: kernels.scan_accumulate_plain(g, pts, view),
               3 * cd * ELEM_BYTES * npts + order.numel() * 4
               + 3 * cd * ELEM_BYTES * order.numel(),
               MONT_MULS["add", cd] * MADS_PER_MONT_MUL * order.numel())
        del pts, order, view
        torch.cuda.empty_cache()

    # (i) row_gather: a permutation of 2^(log2+1) rows (the packed query
    # length), at the reference experiment's width and at the packed G1
    # and G2 point rows; the library call is torch.index_select
    rows_g = 2 * n
    for width in (128, 16, 32) if curve == kernels.GATHER_CURVE else ():
        table = torch.randint(-2**31, 2**31, (rows_g, width), dtype=torch.int64,
                              device=dev, generator=gen).to(torch.int32)
        idx = torch.randperm(rows_g, device=dev, generator=gen).to(torch.int32)
        idx_long = idx.long()
        record("row_gather", f"W = {width}", [rows_g, width],
               lambda: kernels.row_gather(table, idx),
               lambda: kernels.row_gather_plain(table, idx),
               2 * rows_g * width * 4 + rows_g * 4, 0,
               library_fn=lambda: torch.index_select(table, 0, idx_long))
        del table, idx, idx_long
    torch.cuda.empty_cache()
    return records


_BAD_GATHER = """
import os, torch
from octopuszk_tpu_torch.ops import kernels
table = torch.zeros((64, 16), dtype=torch.int32, device="cuda")
idx = torch.tensor([0, {bad}], dtype=torch.int32, device="cuda")
try:
    kernels.row_gather(table, idx)
    torch.cuda.synchronize()
except RuntimeError as e:
    print(str(e).strip().splitlines()[0], flush=True)
    os._exit(0)
os._exit(3)
"""


def check_gather_bounds():
    """An index outside [0, R) must abort row_gather and raise at the next
    synchronisation.  That leaves the process's CUDA context unusable, so
    each case runs in a process of its own (the build is reused)."""
    procs = [(bad, subprocess.Popen(
        [sys.executable, "-c", _BAD_GATHER.format(bad=bad)],
        cwd=os.path.dirname(os.path.abspath(__file__)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for bad in (64, -1)]
    out = {}
    for bad, proc in procs:
        text, _ = proc.communicate(timeout=300)
        out[str(bad)] = {"raised": proc.returncode == 0,
                         "message": text.strip().splitlines()[-1:]}
    emit({"gather_out_of_range": out})
    if not all(v["raised"] for v in out.values()):
        raise SystemExit("row_gather did not fail on an index out of range")


def _total_plain_sliced(g, table, idx2, lanes_per_slice=1 << 17):
    """The plain lane totals over all lanes of ``idx2``.  Lanes are
    independent, so the plain version runs on slices of the lane axis, which
    bounds its int64 temporaries, and the slices are joined."""
    parts = [flat(kernels.scan_accumulate_mixed_total_plain(
        g, table, idx2[:, :, lo:lo + lanes_per_slice]))
        for lo in range(0, idx2.shape[2], lanes_per_slice)]
    return [torch.cat(comp, dim=-1) for comp in zip(*parts)]


def _first(point):
    """First slice of a point batch along its last axis."""
    if isinstance(point, tuple):
        return tuple(_first(c) for c in point)
    return point[..., 0].contiguous()


def jac_leaf(point):
    """One word tensor of a point (all share its shape)."""
    return flat(point)[0]


# ---------------------------------------------------------------------------
# phase: the main path
# ---------------------------------------------------------------------------

# launches per path, curve and kernel (``drive``)
CURVE_COUNTS = {}


def drive(dev, name: str, fn, required=None, curve=None):
    """Run one path with the launch counts and the peak-memory mark set
    to 0 just before it; returns (its result, its launch counts) and keeps
    its counts per curve in CURVE_COUNTS.  Fails if a kernel the path is
    built on (``required``, by default REQUIRED[name]) was never launched,
    or, where ``curve`` is given, never launched with that curve's
    operands."""
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize(dev)
    launches = dict(kernels.LAUNCHES)
    CURVE_COUNTS[name] = {c: dict(v) for c, v in kernels.CURVE_LAUNCHES.items()}
    required = REQUIRED[name] if required is None else required
    idle = sorted(k for k in required if launches[k] == 0
                  or (curve and CURVE_COUNTS[name][curve][k] == 0))
    if idle:
        raise SystemExit(f"kernels never launched on the {name} path"
                         f"{' with ' + curve + ' operands' if curve else ''}:"
                         f" {idle}")
    return out, launches


def check_proof(name, crs, primary, proof, want, stages, extra, launches,
                dev, curve=None):
    """Verify, reject a tampered input, compare with the packed path's
    proof; emit the path line.  Fails on any wrong result.  ``curve``: a
    curve bundle (default BN254a)."""
    cv = curve
    t0 = time.perf_counter()
    accepted = verifier.verify(crs.verification_key, primary, proof, curve=cv)
    stages["verify"] = time.perf_counter() - t0
    bad = list(primary)
    bad[1] = (bad[1] + 1) % (FR.p if cv is None else cv.fr.p)
    rejected = not verifier.verify(crs.verification_key, bad, proof, curve=cv)
    g1, g2 = ((host_curve.g1_is_on_curve, host_curve.g2_is_on_curve)
              if cv is None else
              (cv.g1.host.is_on_curve, cv.g2.host.is_on_curve))
    on_curve = g1(proof.a) and g2(proof.b) and g1(proof.c)
    equal = want is None or (proof.a, proof.b, proof.c) == (
        want.a, want.b, want.c)
    out = {"name": name, **extra, "verify": accepted,
           "tampered_input_rejected": rejected, "proof_on_curve": on_curve,
           "proof_equals_packed_path": equal, "seconds": stages,
           "peak_memory_bytes": torch.cuda.max_memory_allocated(dev),
           "launches": launches}
    emit({"path": out})
    if not (accepted and rejected and on_curve and equal):
        raise SystemExit(f"the {name} path produced a wrong result")


def run_paths(dev, log2: int):
    """The three paths at 2^log2 constraints, on one CRS.  Returns the
    launch counts per path, the packed path's CRS and assignment (for the
    profiled prove and the ``dist`` path) and its proof."""
    ni = 3
    counts = {}

    def packed_path():
        stages, setup_stages, prove_stages = {}, {}, {}
        t0 = time.perf_counter()
        r1cs, primary, aux = construct.serial_construct(
            (1 << log2) - ni, ni, seed=5, device=dev)
        torch.cuda.synchronize(dev)
        stages["construct"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        crs = setup.setup(r1cs, seed=6, stage_seconds=setup_stages)
        stages["setup"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        proof = prover.prove(crs.proving_key, primary, aux, seed=7,
                             stage_seconds=prove_stages)
        stages["prove"] = time.perf_counter() - t0
        return (crs, primary, aux, proof, stages,
                {"setup_seconds": setup_stages, "prove_seconds": prove_stages})

    (crs, primary, aux, proof, stages, extra), counts["packed"] = drive(
        dev, "packed", packed_path)
    pk = crs.proving_key
    sizes = {"constraints": (1 << log2) - ni, "inputs": ni, "curve": "bn254a",
             "domain": 1 << log2, "query_rows": int(pk.query_a.shape[0])}
    check_proof("packed", crs, primary, proof, None, stages,
                {**sizes, **extra}, counts["packed"], dev)

    def unpacked_path():
        stages, prove_stages = {}, {}
        t0 = time.perf_counter()
        upk = dataclasses.replace(pk, packed=False, **{
            q: msm.packed_to_points(bn254.G2 if q == "query_b_g2"
                                    else bn254.G1, getattr(pk, q))
            for q in QUERIES})
        torch.cuda.synchronize(dev)
        stages["unpack"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        got = prover.prove(upk, primary, aux, seed=7,
                           stage_seconds=prove_stages)
        stages["prove"] = time.perf_counter() - t0
        return got, stages, {"prove_seconds": prove_stages}

    (uproof, stages, extra), counts["unpacked"] = drive(
        dev, "unpacked", unpacked_path)
    check_proof("unpacked", crs, primary, uproof, proof, stages,
                {**sizes, **extra}, counts["unpacked"], dev)

    def streamed_path():
        stages, prove_stages = {}, {}
        with tempfile.TemporaryDirectory() as tmp:
            path = f"{tmp}/crs.npz"
            t0 = time.perf_counter()
            serialize.save_crs(path, crs)
            stages["save_crs"] = time.perf_counter() - t0
            file_bytes = os.path.getsize(path)
            t0 = time.perf_counter()
            loaded = serialize.load_crs(path, stream=True)
            torch.cuda.synchronize(dev)
            stages["load_crs"] = time.perf_counter() - t0
        lpk = loaded.proving_key
        if not (all(getattr(lpk, q).is_pinned() for q in QUERIES)
                and lpk.r1cs.a.val.is_cuda):
            raise SystemExit("load_crs(stream=True) did not keep the queries "
                             "in pinned host memory beside a device R1CS")
        t0 = time.perf_counter()
        got = prover.prove(lpk, primary, aux, seed=7,
                           stage_seconds=prove_stages)
        stages["prove"] = time.perf_counter() - t0
        return (loaded, got, stages,
                {"crs_file_bytes": file_bytes, "prove_seconds": prove_stages})

    (loaded, sproof, stages, extra), counts["streamed"] = drive(
        dev, "streamed", streamed_path)
    check_proof("streamed", loaded, primary, sproof, proof, stages,
                {**sizes, **extra}, counts["streamed"], dev)
    return counts, (crs, primary, aux), proof


def run_bn254b(dev, log2: int):
    """The BN254b path at 2^log2 constraints: construct -> setup -> packed
    prove, then the same CRS unpacked in memory (``msm.packed_to_points``)
    and proved through the sort-based Pippenger (kernel h), all in one
    drive; both proofs must verify and be equal, a tampered input must be
    rejected.  Every kernel must launch with BN254b operands.  Returns the
    launch counts."""
    ni = 3
    cv = bn254b()

    def path():
        stages, setup_stages, prove_stages, uprove_stages = {}, {}, {}, {}
        t0 = time.perf_counter()
        r1cs, primary, aux = construct.serial_construct(
            (1 << log2) - ni, ni, seed=5, spec=cv.fr, device=dev)
        torch.cuda.synchronize(dev)
        stages["construct"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        crs = setup.setup(r1cs, seed=6, curve=cv, stage_seconds=setup_stages)
        stages["setup"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        proof = prover.prove(crs.proving_key, primary, aux, seed=7, curve=cv,
                             stage_seconds=prove_stages)
        stages["prove"] = time.perf_counter() - t0
        pk = crs.proving_key
        t0 = time.perf_counter()
        upk = dataclasses.replace(pk, packed=False, **{
            q: msm.packed_to_points(cv.g2 if q == "query_b_g2" else cv.g1,
                                    getattr(pk, q))
            for q in QUERIES})
        torch.cuda.synchronize(dev)
        stages["unpack"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        uproof = prover.prove(upk, primary, aux, seed=7, curve=cv,
                              stage_seconds=uprove_stages)
        stages["prove_unpacked"] = time.perf_counter() - t0
        return (crs, primary, proof, uproof, stages,
                {"setup_seconds": setup_stages, "prove_seconds": prove_stages,
                 "prove_unpacked_seconds": uprove_stages,
                 "query_rows": int(pk.query_a.shape[0])})

    (crs, primary, proof, uproof, stages, extra), launches = drive(
        dev, "bn254b", path, curve="bn254b")
    sizes = {"constraints": (1 << log2) - ni, "inputs": ni, "curve": "bn254b",
             "domain": 1 << log2,
             "unpacked_proof_equals_packed": (uproof.a, uproof.b, uproof.c)
             == (proof.a, proof.b, proof.c)}
    check_proof("bn254b", crs, primary, uproof, proof, stages,
                {**sizes, **extra}, launches, dev, curve=cv)
    return launches


# the test fields' path: elements held against python ints, and the
# exponent of its power check
SAMPLE = 4096
POW_EXP = 0x1234567890ABCDEF


def _horner(coeffs, x: int, p: int) -> int:
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * x + c) % p
    return acc


def _test_field(dev, gen, spec, n: int, stages: dict) -> dict:
    """One test field through the port's entry points at n elements, each
    result checked; returns what was checked (all must be True)."""
    p = spec.p
    rinv = pow(1 << 256, -1, p)
    one = fp.constant(spec.one_mont_words, (n,), dev)
    x = rand_elems(gen, spec, (n,), dev)
    edges = [0, 1, p - 1, p - 2]
    x[:, :len(edges)] = torch.from_numpy(
        bigint.ints_to_words(edges).copy()).to(dev)
    t0 = time.perf_counter()
    y = ntt.ntt(spec, x)
    back = ntt.intt(spec, y)
    yc = ntt.coset_ntt(spec, x)
    backc = ntt.coset_intt(spec, yc)
    torch.cuda.synchronize(dev)
    stages["ntt, intt, coset_ntt, coset_intt"] = time.perf_counter() - t0
    b, c = rand_elems(gen, spec, (n,), dev), rand_elems(gen, spec, (n,), dev)
    t0 = time.perf_counter()
    h = kernels.mul_sub(spec, x, b, c)
    h_alt = fp.sub(spec, fp.mont_mul(spec, x, b), c)
    torch.cuda.synchronize(dev)
    stages["mul_sub, mont_mul"] = time.perf_counter() - t0
    z = x.clone()
    z[:, torch.rand(n, device=dev, generator=gen) < 0.05] = 0
    zero = fp.is_zero(z)
    t0 = time.perf_counter()
    zi = fp.batch_inv_rows(spec, z)
    zprod = fp.mont_mul(spec, zi, z)
    torch.cuda.synchronize(dev)
    stages["batch_inv_rows"] = time.perf_counter() - t0
    s = x[:, -SAMPLE:].contiguous()
    t0 = time.perf_counter()
    s_inv = fp.inv(spec, s)
    s_pow = fp.pow_const(spec, s, POW_EXP)
    torch.cuda.synchronize(dev)
    stages["inv, pow_const"] = time.perf_counter() - t0

    # python ints: the NTTs at two points, the rest on a sample
    t0 = time.perf_counter()
    xs = bigint.words_to_ints(x.cpu().numpy())
    w = spec.rou_of_order(n)
    ys = bigint.words_to_ints(y[:, [1, n - 1]].cpu().numpy())
    yc1 = bigint.words_to_ints(yc[:, 1].cpu().numpy())[0]
    ntt_ok = (ys == [_horner(xs, w, p), _horner(xs, pow(w, n - 1, p), p)]
              and yc1 == _horner(xs, spec.generator * w % p, p))
    pos = torch.randperm(n, device=dev, generator=gen)[:SAMPLE]

    def ints(t):
        return bigint.words_to_ints(t[:, pos].cpu().numpy())

    xv, bv, cv, hv, zv, ziv = (ints(t) for t in (x, b, c, h, z, zi))
    sv = bigint.words_to_ints(s.cpu().numpy())
    sample_ok = {
        "mul_sub": hv == [(u * v * rinv - w_) % p
                          for u, v, w_ in zip(xv, bv, cv)],
        "batch_inv_rows": ziv == [pow(u, -1, p) * (1 << 512) % p if u else 0
                                  for u in zv],
        "inv": bigint.words_to_ints(s_inv.cpu().numpy()) == [
            pow(u, -1, p) * (1 << 512) % p if u else 0 for u in sv],
        "pow_const": bigint.words_to_ints(s_pow.cpu().numpy()) == [
            pow(u * rinv % p, POW_EXP, p) * (1 << 256) % p for u in sv]}
    stages["python ints"] = time.perf_counter() - t0
    return {
        "ntt_intt_round_trip": torch.equal(back, x),
        "coset_round_trip": torch.equal(backc, x),
        "ntt_at_two_points_and_coset_at_one": ntt_ok,
        "mul_sub_equals_mont_mul_then_sub": torch.equal(h, h_alt),
        "batch_inv_rows_times_input_is_one": bool(
            (fp.eq(zprod, one) | zero).all() and fp.is_zero(zi[:, zero]).all()),
        "inv_times_input_is_one_where_nonzero": bool(
            (fp.eq(fp.mont_mul(spec, s_inv, s), one[:, :SAMPLE])
             | fp.is_zero(s)).all()),
        **{f"sample_{k}": v for k, v in sample_ok.items()}}


def run_test_fields(dev, log2: int):
    """The test fields of no curve (SMALL, 62 bits; LARGE, 255 bits) at
    2^log2 elements each through fields/fp.py and ops/ntt.py: ntt -> intt
    and coset_ntt -> coset_intt give the input back (the NTTs also equal
    the polynomial at two points, the coset NTT at one); H = A B - C
    through mul_sub equals the product then the subtract;
    ``batch_inv_rows`` (5 % zeros) times its input is one where the input
    is not zero; ``inv`` and ``pow_const`` on 4,096; a sample of 4,096
    elements of each result held against python ints.  Every field kernel
    must launch with the test fields' operands.  Returns the launch
    counts."""
    gen = torch.Generator(device=dev).manual_seed(22)
    n = 1 << log2

    def path():
        out = {}
        for spec in kernels.LIBRARIES[kernels.TEST_FIELDS].specs():
            stages = {}
            checks = _test_field(dev, gen, spec, n, stages)
            out[spec.name] = {"p_bits": spec.p.bit_length(), "n": n,
                              "checks": checks, "seconds": stages}
        return out

    out, launches = drive(dev, "test fields", path, curve=kernels.TEST_FIELDS)
    drop_test_field_tables()
    emit({"path": {"name": "test fields", "fields": out,
                   "peak_memory_bytes": torch.cuda.max_memory_allocated(dev),
                   "launches": launches}})
    if not all(all(f["checks"].values()) for f in out.values()):
        raise SystemExit("the test fields' path produced a wrong result")
    return launches


def run_mxu(dev, log2: int):
    """The tensor-core Montgomery experiment at 2^log2 (it prints its
    lines): kernel (b) against ops/mxu_mont.py, BN254a Fr and Fq, equal
    over the whole batch (it raises otherwise).  Returns the launch
    counts."""
    from octopuszk_tpu_torch.scripts import mxu_experiment
    t0 = time.perf_counter()
    _, launches = drive(dev, "mxu", lambda: mxu_experiment.main(log2))
    emit({"path": {"name": "mxu", "log2": log2,
                   "seconds": time.perf_counter() - t0,
                   "peak_memory_bytes": torch.cuda.max_memory_allocated(dev),
                   "launches": launches}})
    return launches


def run_native(log2: int):
    """The host marshaling of 2^log2 Fr-sized ints both ways, the native
    library (utils/native.py, built with the script's kernels) against the
    numpy path: the words must be equal.  Prints each one's time and the
    path the prover's ``assignment`` stage takes (``ints_to_words``:
    numpy's)."""
    n = 1 << log2
    rng = random.Random(13)
    xs = [rng.randrange(FR.p) for _ in range(n)]

    def timed(fn):
        t0 = time.perf_counter()
        out = fn()
        return out, time.perf_counter() - t0

    raw, pack_s = timed(lambda: bigint.ints_to_bytes(xs))
    w_native, native_s = timed(lambda: native.bytes_to_words(raw, n, 32))
    w_numpy, numpy_s = timed(lambda: bigint.bytes_to_words_numpy(raw, n))
    r_native, rnative_s = timed(lambda: native.words_to_bytes(w_numpy))
    r_numpy, rnumpy_s = timed(
        lambda: bigint.words_to_bytes_numpy(w_numpy.view("uint32")))
    _, ints_s = timed(lambda: bigint.ints_to_words(xs))
    equal = (w_native is not None and (w_native == w_numpy).all()
             and r_native == r_numpy == raw)
    emit({"native": {
        "library": os.path.relpath(native.path(), os.path.dirname(
            os.path.abspath(__file__))),
        "assignment_path": "numpy",
        "n": n, "int_to_bytes_loop_s": pack_s,
        "bytes_to_words_s": {"native": native_s, "numpy": numpy_s},
        "words_to_bytes_s": {"native": rnative_s, "numpy": rnumpy_s},
        "ints_to_words_s": ints_s, "equal": bool(equal)}})
    if not equal:
        raise SystemExit("the native marshaling differs from numpy's")


def run_dist(dev, log2: int, crs, proof):
    """The distributed prover over four shards at 2^log2 constraints on
    BN254a: construct, ``shard_r1cs``, ``distributed_setup`` and
    ``distributed_prove`` with the packed path's seeds, then ``verify``;
    the proof must equal the packed path's ``proof`` and a tampered input
    must be rejected.  Then the distributed CRS gathered and proved by the
    serial prover, and the packed path's ``crs`` sharded and proved by
    ``distributed_prove``: both proofs must equal it too.  Returns the
    launch counts of both drives."""
    ni = 3
    mesh = pmesh.make_mesh(DIST_SHARDS)
    devices = [str(d) for d in mesh.devices]

    def dist_path():
        stages, setup_stages, prove_stages = {}, {}, {}
        t0 = time.perf_counter()
        r1cs, primary, aux = construct.serial_construct(
            (1 << log2) - ni, ni, seed=5, device=dev)
        torch.cuda.synchronize(dev)
        stages["construct"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        sr = dgroth16.shard_r1cs(mesh, r1cs)
        del r1cs
        torch.cuda.synchronize(dev)
        stages["shard_r1cs"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        dcrs = dgroth16.distributed_setup(mesh, sr, seed=6,
                                          stage_seconds=setup_stages)
        stages["setup"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        dproof = dgroth16.distributed_prove(
            mesh, dcrs.proving_key, primary, aux, seed=7,
            stage_seconds=prove_stages)
        stages["prove"] = time.perf_counter() - t0
        return (dcrs, primary, aux, dproof, stages,
                {"setup_seconds": setup_stages, "prove_seconds": prove_stages})

    (dcrs, primary, aux, dproof, stages, extra), counts = drive(
        dev, "dist", dist_path)
    sizes = {"constraints": (1 << log2) - ni, "inputs": ni, "curve": "bn254a",
             "domain": 1 << log2, "shards": DIST_SHARDS, "devices": devices,
             "query_rows_per_shard": [
                 int(q.shape[0]) for q in dcrs.proving_key.query_a]}
    check_proof("dist", dcrs, primary, dproof, proof, stages,
                {**sizes, **extra}, counts, dev)

    def crs_paths():
        stages, gprove_stages, sprove_stages = {}, {}, {}
        t0 = time.perf_counter()
        gathered = dgroth16.gather_crs(mesh, dcrs)
        torch.cuda.synchronize(dev)
        stages["gather_crs"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        gproof = prover.prove(gathered.proving_key, primary, aux, seed=7,
                              stage_seconds=gprove_stages)
        stages["prove_gathered"] = time.perf_counter() - t0
        del gathered
        t0 = time.perf_counter()
        sharded = dgroth16.shard_crs(mesh, crs)
        torch.cuda.synchronize(dev)
        stages["shard_crs"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        sproof = dgroth16.distributed_prove(
            mesh, sharded.proving_key, primary, aux, seed=7,
            stage_seconds=sprove_stages)
        stages["prove_sharded"] = time.perf_counter() - t0
        return gproof, sproof, stages, {
            "prove_gathered_seconds": gprove_stages,
            "prove_sharded_seconds": sprove_stages}

    (gproof, sproof, stages, extra), ccounts = drive(dev, "dist crs",
                                                     crs_paths)
    same_g = (gproof.a, gproof.b, gproof.c) == (proof.a, proof.b, proof.c)
    check_proof("dist crs", crs, primary, sproof, proof, stages,
                {**sizes, **extra, "gathered_proof_equals_packed": same_g},
                ccounts, dev)
    if not same_g:
        raise SystemExit("the gathered CRS's serial proof differs from the "
                         "packed path's")
    return {"dist": counts, "dist crs": ccounts}


def run_large(dev, log2: int):
    """The packed path at 2^log2 constraints through
    ``scripts/large_prove.py``'s ``run`` in its streamed form: construct,
    one setup, a prove with the queries on the card, then the same prove
    from pinned host memory; each verified, a tampered input rejected, each
    stage's device memory (``stage_bytes``, ``stage_peak_bytes``: each
    prove's own peak) and the bytes staged to the card in the path line.
    Fails unless both proofs verify and are equal word for word, the
    tampered input is rejected, the streamed prove staged every query from
    host memory and setup cut each query's fixed-base evaluation into
    chunks of 2^FIXED_CHUNK_LOG scalars (four at 2^22, two or more from
    2^21).  Returns the launch counts."""
    name = f"2^{log2}"
    out, launches = drive(
        dev, name, lambda: large_prove.run(log2, dev, stream=True),
        required=_GROTH16_KERNELS)
    emit({"path": {"name": name, **out, "launches": launches}})
    chunks = out["fixed_base_chunks_per_query"]
    want = -(-out["query_rows"] // (1 << msm.FIXED_CHUNK_LOG))
    streamed = out["streamed"]
    if not (out["ok"] and chunks == want and (chunks >= 2 or log2 < 21)):
        raise SystemExit(f"the {name} path produced a wrong result or did "
                         f"not chunk its fixed-base evaluation ({chunks} "
                         f"chunks a query, {want} planned)")
    if not (streamed["proof_equals_resident"] and streamed["all_pinned"]
            and streamed["staged_bytes"] == streamed["pinned_host_bytes"]):
        raise SystemExit(f"the {name} path's streamed prove differs from "
                         f"the resident one or did not stage its queries: "
                         f"{streamed}")
    return {name: launches}


def run_gather(dev, log2: int):
    """The port's gather experiment over 2^(log2+1) rows, as its command
    line runs it (it prints its two lines).  Returns its launch counts."""
    from octopuszk_tpu_torch.scripts import gather_experiment
    t0 = time.perf_counter()
    _, launches = drive(dev, "gather", lambda: gather_experiment.main(log2 + 1))
    emit({"path": {"name": "gather", "log2_rows": log2 + 1,
                   "seconds": time.perf_counter() - t0,
                   "peak_memory_bytes": torch.cuda.max_memory_allocated(dev),
                   "launches": launches}})
    return launches


def run_profiler(dev, log2: int, apps):
    """Apps of the port's profiler through ``profiler.main`` (each prints
    the reference's lines; a verifying app asserts ok), with the launch
    counts reset per app; ``apps``: (argv less the size, the kernels the
    app must launch), the distributed form's argv led by its shard count.
    After the serial ``bace`` the same proof is recomputed, verified, and a
    tampered one must be rejected.  Returns the launch counts per app."""
    from octopuszk_tpu_torch.models.bace import prover as bprover, verifier as bverifier
    from octopuszk_tpu_torch.profiler import profiler
    counts = {}
    with tempfile.TemporaryDirectory() as tmp:
        for k, (args, required) in enumerate(apps):
            lead = 2 if args[0].isdigit() else 1        # [ndev] app
            app = args[lead - 1]
            size = log2 - PROFILER_CUTS.get(app, 0)
            argv = args[:lead] + [str(size)] + args[lead:]
            name = "profiler " + " ".join(argv)
            events = os.path.join(tmp, str(k))
            t0 = time.perf_counter()
            rc, counts[name] = drive(
                dev, name, lambda: profiler.main(argv, events_dir=events),
                required, PROFILER_CURVES.get(app))
            seconds = time.perf_counter() - t0
            if rc != 0:
                raise SystemExit(f"{name} returned {rc}")
            with open(os.path.join(events, f"{app}.csv")) as f:
                records = {r["name"]: float(r["seconds"])
                           for r in csv.DictReader(f)}
            line = {"app": app, "argv": argv, "log2": size,
                    "seconds": seconds, "records": records,
                    "peak_memory_bytes": torch.cuda.max_memory_allocated(dev),
                    "launches": counts[name]}
            if app == "bace" and lead == 1:
                n = 1 << size
                c = profiler.bace_circuit()
                inputs = profiler._rand_scalars(2 * n, device=dev)
                proof = bprover.compute_proof(FR, c, inputs, n)
                bad = proof.clone()
                bad[0, 0] += 1
                line["verify"] = bverifier.verify_proof(FR, c, proof, inputs, n)
                line["tampered_proof_rejected"] = not bverifier.verify_proof(
                    FR, c, bad, inputs, n)
                if not (line["verify"] and line["tampered_proof_rejected"]):
                    emit({"profiler": line})
                    raise SystemExit("the bace proof did not verify, or a "
                                     "tampered one was accepted")
            emit({"profiler": line})
            torch.cuda.empty_cache()
    return counts


# the device kernels of the inversions, by name in the profiler's trace
INVERSION_KERNELS = ("inv_kernel", "mont_pow_kernel", "batch_inv_rows_kernel")
# the tree's, the add's and the prefix's kernels, whose records (the
# wrapper's time) the host's time per call can hide on G1
TREE_ADD_KERNELS = ("tree_sum_kernel", "add_points_kernel",
                    "add_points_pair_kernel", "prefix_sum_kernel")


def profile_prove(dev, crs, primary, aux):
    """Two more proves: one timed on the host clock, with its stages and
    its launches per wrapper, one under torch.profiler for the device's
    busy time (the sum over device kernels; tracing slows the host, so the
    idle share is reckoned against the untraced wall time), the kernels
    that take most of it, the inversions' kernels (device time of a
    call, which the records of one element cannot show where the
    wrapper's host time is longer) and likewise the tree's and the
    add's."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize(dev)
    kernels.reset_launch_counts()
    stages = {}
    t0 = time.perf_counter()
    prover.prove(crs.proving_key, primary, aux, seed=7, stage_seconds=stages)
    torch.cuda.synchronize(dev)
    wall_ms = (time.perf_counter() - t0) * 1e3
    launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        prover.prove(crs.proving_key, primary, aux, seed=7)
        torch.cuda.synchronize(dev)
    traced_wall_ms = (time.perf_counter() - t0) * 1e3

    def self_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))

    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and self_us(e) > 0]
    busy_ms = sum(self_us(e) for e in events) / 1e3
    top = sorted(events, key=self_us, reverse=True)[:12]
    emit({"profile": {
        "what": "prove, warm",
        "wall_ms": wall_ms, "traced_wall_ms": traced_wall_ms,
        "device_busy_ms": busy_ms,
        "device_idle_share": 1 - busy_ms / wall_ms,
        "prove_seconds": stages, "launches": launches,
        "device_kernels": len(events),
        "kernel_launches": sum(e.count for e in events),
        "top_by_device_time": [
            {"name": e.key[:80], "calls": e.count, "ms": self_us(e) / 1e3}
            for e in top],
        "inversion_kernels": [
            {"name": e.key[:80], "calls": e.count, "ms": self_us(e) / 1e3}
            for e in events if any(k in e.key for k in INVERSION_KERNELS)],
        "tree_add_kernels": [
            {"name": e.key[:80], "calls": e.count, "ms": self_us(e) / 1e3}
            for e in events if any(k in e.key for k in TREE_ADD_KERNELS)]}})


# ---------------------------------------------------------------------------
# phase: one MSM against python-int curve arithmetic
# ---------------------------------------------------------------------------

def run_oracle(dev, n: int):
    g1 = bn254.G1
    rng = random.Random(11)
    base = g1.point_to_device(
        g1.host.mul(g1.generator_affine, rng.randrange(1, FR.p)), dev)
    gen = torch.Generator(device=dev).manual_seed(12)
    pts = msm.fixed_base_msm(g1, base, rand_field(gen, (n,), dev))
    packed = msm.points_to_packed(g1, pts)
    scalars = rand_field(gen, (n,), dev)
    scalars[:, 0] = 0                           # a zero scalar
    lanes = min(64, n)
    got = g1.points_to_host(msm._map_coords(
        msm.pippenger_msm_packed(g1, packed, scalars, lanes=lanes),
        lambda c: c[..., None]))[0]
    from octopuszk_tpu_torch.utils.bigint import words_to_ints
    host_pts = g1.points_to_host(pts)
    host_scalars = words_to_ints(scalars.cpu().numpy())
    got_unpacked = g1.points_to_host(msm._map_coords(
        msm.pippenger_msm(g1, pts, scalars), lambda c: c[..., None]))[0]
    want = msm.pippenger_host(g1, host_scalars, host_pts)
    ok = (got == want and all(host_curve.g1_is_on_curve(p) for p in host_pts))
    ok_unpacked = got_unpacked == want
    equal = [ok, ok_unpacked]
    # BN254b: a packed MSM on each group against its python-int arithmetic
    cv = bn254b()
    for grp in (cv.g1, cv.g2):
        base = grp.point_to_device(
            grp.host.mul(grp.generator_affine, rng.randrange(1, cv.fr.p)), dev)
        pts = msm.fixed_base_msm(grp, base, rand_field(gen, (n,), dev))
        scalars = rand_field(gen, (n,), dev)
        scalars[:, 0] = 0
        got = grp.points_to_host(msm._map_coords(
            msm.pippenger_msm_packed(grp, msm.points_to_packed(grp, pts),
                                     scalars, lanes=lanes),
            lambda c: c[..., None]))[0]
        host_pts = grp.points_to_host(pts)
        want = msm.pippenger_host(grp, words_to_ints(scalars.cpu().numpy()),
                                  host_pts)
        equal.append(got == want
                     and all(grp.host.is_on_curve(p) for p in host_pts))
    emit({"oracle": {"msm": ["pippenger_msm_packed G1", "pippenger_msm G1",
                             "pippenger_msm_packed bn254b-G1",
                             "pippenger_msm_packed bn254b-G2"],
                     "n": n, "lanes": lanes,
                     "against": "msm.pippenger_host over host ints (BN254a: "
                                "host_curve; BN254b: the bundle's host ops)",
                     "equal": equal}})
    if not all(equal):
        raise SystemExit("an MSM disagrees with the host oracle")


def ptxas_summary():
    """Registers and spills per kernel, from each library's build's ptxas
    output, with the library (``curve``) and source it was compiled
    from."""
    out, cur = [], None
    lines = [(curve, src, line) for curve in kernels.LIBRARIES
             for src, text in kernels.compile_log(curve).items()
             for line in text.splitlines()]
    for curve, src, line in lines:
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            # mangled name less its anonymous-namespace prefix and arguments
            name = re.sub(r"^_ZN\d+_GLOBAL__N__\w+_cu_[0-9a-f]{8}\d\d", "",
                          m.group(1)).split("Ev")[0]
            cur = {"curve": curve, "source": src, "entry": name,
                   "registers": None,
                   "spill_stores": 0, "spill_loads": 0}
            out.append(cur)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and cur:       # the entry and the functions it calls
            cur["spill_stores"] += int(m.group(1))
            cur["spill_loads"] += int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            cur["registers"] = int(m.group(1))
    return out


def unit_seconds(curve):
    """Seconds from the start of a library's build in this process to the
    last write of each source's compiler log (None where the library was
    already built)."""
    if curve not in kernels.build_seconds:
        return None
    d = kernels.build(curve).parent
    t0 = (d / "constants.cuh").stat().st_mtime
    return {src: (d / (src[:-3] + ".log")).stat().st_mtime - t0
            for src in kernels.sources(curve)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--log2", type=int, default=20)
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device", file=sys.stderr)
        return 1
    if 1 << args.log2 <= ntt.BLOCK_MAX:
        print(f"--log2 {args.log2} does not run the 4-step NTT (it starts "
              f"above 2^{ntt.BLOCK_MAX.bit_length() - 1})", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor() as pool:   # build + load
        built = [pool.submit(native.build)] + [
            pool.submit(kernels.lib, c) for c in kernels.LIBRARIES]
        for b in built:
            b.result()
    card = smi("name,power.limit")
    sm_mhz = float(smi("clocks.max.sm").split()[0])
    int32_rate = SM_COUNT * INT32_LANES_PER_SM * sm_mhz * 1e6
    emit({"env": {
        "python": sys.version.split()[0], "torch": torch.__version__,
        "cuda": torch.version.cuda, "card": card,
        "clocks_max_sm_mhz": sm_mhz,
        "int32_mads_per_s_derived": int32_rate,
        "build_seconds": kernels.build_seconds,
        "build_unit_seconds": {c: unit_seconds(c) for c in kernels.LIBRARIES},
        "ptxas": ptxas_summary()}})

    phases = {"build": time.perf_counter() - t_start}

    @contextlib.contextmanager
    def phase(name):
        t0 = time.perf_counter()
        yield
        phases[name] = time.perf_counter() - t0

    with phase("native"):
        run_native(args.log2)
    with phase("kernels"):
        records = check_kernels(dev, args.log2, int32_rate, reps=5)
        torch.cuda.empty_cache()
    with phase("kernels bn254b"):
        records += check_kernels(dev, args.log2, int32_rate, reps=5,
                                 curve="bn254b", whole=False)
        torch.cuda.empty_cache()
    with phase("kernels test fields"):
        records += check_test_field_kernels(dev, args.log2, int32_rate,
                                            reps=5)
    with phase("paths"):
        counts, proving_inputs, packed_proof = run_paths(dev, args.log2)
    with phase("path bn254b"):
        counts["bn254b"] = run_bn254b(dev, args.log2)
        torch.cuda.empty_cache()
    with phase("path test fields"):
        counts["test fields"] = run_test_fields(dev, args.log2)
    with phase("mxu"):
        counts["mxu"] = run_mxu(dev, args.log2)
        torch.cuda.empty_cache()
    with phase("profile and oracle"):
        profile_prove(dev, *proving_inputs)
        run_oracle(dev, 1 << 12)
    with phase("path dist"):
        counts.update(run_dist(dev, args.log2, proving_inputs[0],
                               packed_proof))
        del proving_inputs, packed_proof
        torch.cuda.empty_cache()
    with phase(f"path 2^{args.log2 + 2}"):
        counts.update(run_large(dev, args.log2 + 2))
        torch.cuda.empty_cache()
    with phase("gather"):
        counts["gather"] = run_gather(dev, args.log2)
        check_gather_bounds()
    with phase("profiler apps"):
        counts.update(run_profiler(dev, args.log2, PROFILER_APPS))
    with phase("profiler dist apps"):
        counts.update(run_profiler(dev, args.log2, DIST_PROFILER_APPS))
    for r in records:              # the launches with the record's curve
        r["launches_per_path"] = {
            p: CURVE_COUNTS[p][r["curve"]][r["name"]] for p in counts}
        r["launches"] = sum(r["launches_per_path"].values())
    emit({"launches": counts, "by_curve": CURVE_COUNTS})
    emit({"kernels": records})
    print(card, flush=True)
    emit({"total_seconds": time.perf_counter() - t_start,
          "phase_seconds": phases})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
