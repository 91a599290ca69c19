"""The hand-written CUDA kernels: build, load, wrappers, plain versions.

Nine kernels (sources under ``csrc/``) replace the Pallas kernels of the
same names in ``octopuszk_tpu/ops/pallas_ops.py`` and, for ``row_gather``,
``_pallas_gather`` in ``scripts/gather_experiment.py``; nine more run, in
one launch each, the chains of ``butterfly``, ``mont_mul`` and
``add_points`` launches that the main path made (the reference runs those
loops inside one compiled program; ``inv`` runs the inverse that the
reference computes as a ``mont_mul`` chain by another algorithm, safegcd,
whose inverse is the same unique value):

=================================  ====================  ==============
wrapper                            source                chain of
=================================  ====================  ==============
``butterfly``                      field_kernels.cu
``mont_mul``                       field_kernels.cu
``mul_sub``                        field_kernels.cu
``add_points``                     ec_kernels.cu
``double_points``                  ec_kernels.cu
``scan_accumulate_mixed``          scan_kernels.cu
``scan_accumulate_mixed_total``    scan_kernels.cu
``scan_accumulate``                scan_kernels.cu
``row_gather``                     gather_kernels.cu
``ntt_block``                      ntt_kernels.cu        ``butterfly``
``mont_pow``                       field_kernels.cu      ``mont_mul``
``inv``                            field_kernels.cu      ``mont_mul``
``batch_inv_rows``                 field_kernels.cu      ``mont_mul``
``window_table``                   table_kernels.cu      ``add_points``
``combine_windows``                table_kernels.cu      ``add_points``
``lane_row_sums``                  bucket_kernels.cu     ``add_points``
``tree_sum``                       bucket_kernels.cu     ``add_points``
``prefix_sum``                     prefix_kernels.cu     ``add_points``
=================================  ====================  ==============

Each wrapper takes word tensors (``int32[8, ...]``, see fields/fp.py; the
row gather takes rows ``int32[R, W]``).  For
a tensor on the CPU it evaluates the plain PyTorch version beside it
(``*_plain``); for a tensor on the card it launches its kernel on the
card the operands lie on, on that card's current stream, without
synchronising, or raises.  Operands on two devices raise ``ValueError`` on
either path.  There is no fallback and no size threshold.
``CURVE_LAUNCHES`` counts kernel launches per wrapper and library,
``LAUNCHES`` per wrapper.

Every kernel but the row gather is one of a library, and a library is a
pair of fields: ``LIBRARIES`` holds one entry per library.  The curves of
curves/family.py (BN254a, whose groups are ``G1`` and ``G2``; BN254b,
whose groups are ``bn254b-G1`` and ``bn254b-G2``) have a library each,
with Fr as field 0 and Fq as field 1 and every kernel.  The reference's
test fields, which belong to no curve, have one with the field kernels (a,
b, c, b's chains, ``ntt_block``) alone: field 0 is ``SMALL`` (62 bits),
field 1 ``LARGE`` (255 bits).  A field spec or a group name picks its
library; one that no library knows raises ``ValueError``.

Build: each library is built at its first use: ``nvcc`` compiles each of
its sources for ``sm_90a`` with its definitions (``-DOZ_CURVE_BN254B`` for
BN254b, ``-DOZ_TEST_FIELDS`` for the test fields, read by
csrc/curve.cuh), all sources at once, and links a shared library with a
plain C interface under ``build/``, keyed by a hash of the sources, the
definitions and the constants written from the field specs
(``constants_header``); it is loaded with ``ctypes``.  The row gather,
which knows no field, is built into BN254a's library.
"""

from __future__ import annotations

import collections.abc
import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import time
import typing

import numpy as np
import torch

from octopuszk_tpu_torch.curves import family
from octopuszk_tpu_torch.fields import fp
from octopuszk_tpu_torch.fields.spec import (
    FieldSpec, HALF_BITS, HALF_MASK, LARGE, SMALL)
from octopuszk_tpu_torch.utils.bigint import NUM_WORDS

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = pathlib.Path(__file__).resolve().parent.parent.parent / "build"


class Library(typing.NamedTuple):
    """One kernel library."""
    specs: typing.Callable      # -> (field 0's spec, field 1's spec)
    tags: tuple                 # their constants' tags in constants.cuh
    bundle: typing.Callable | None  # its curve in curves/family.py (groups)
    defs: tuple                 # nvcc definitions
    sources: tuple              # under csrc/
    entries: tuple              # the entry points it exports


FIELD_SOURCES = ("field_kernels.cu", "ntt_kernels.cu")
FIELD_ENTRIES = ("oz_butterfly", "oz_mont_mul", "oz_mul_sub", "oz_ntt_block",
                 "oz_mont_pow", "oz_inv", "oz_batch_inv_rows")
CURVE_SOURCES = ("field_kernels.cu", "ec_kernels.cu", "scan_kernels.cu",
                 "ntt_kernels.cu", "table_kernels.cu", "bucket_kernels.cu",
                 "prefix_kernels.cu")
CURVE_ENTRIES = FIELD_ENTRIES + (
    "oz_add_points", "oz_double_points", "oz_scan_mixed", "oz_scan_full",
    "oz_window_table", "oz_combine_windows", "oz_lane_row_sums",
    "oz_tree_sum", "oz_prefix_sum")


def _curve_library(bundle, tag, defs, extra_sources=(), extra_entries=()):
    return Library(lambda: (bundle().fr, bundle().fq),
                   ("FR" + tag, "FQ" + tag), bundle, defs, CURVE_SOURCES + extra_sources,
                   CURVE_ENTRIES + extra_entries)


LIBRARIES = {
    "bn254a": _curve_library(family.bn254a, "", (), ("gather_kernels.cu",),
                             ("oz_row_gather",)),
    "bn254b": _curve_library(family.bn254b, "B", ("-DOZ_CURVE_BN254B",)),
    "fields": Library(lambda: (SMALL, LARGE), ("SMALL", "LARGE"), None,
                      ("-DOZ_TEST_FIELDS",), FIELD_SOURCES, FIELD_ENTRIES),
}
# the library of the test fields, and the one that holds the row gather
TEST_FIELDS = "fields"
GATHER_CURVE = "bn254a"
HEADERS = ("field.cuh", "fp2.cuh", "rcb.cuh", "grid.cuh", "ntt.cuh",
           "curve.cuh", "lanes.cuh", "prefix.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

KERNEL_NAMES = ("butterfly", "mont_mul", "mul_sub", "add_points",
                "double_points", "scan_accumulate_mixed",
                "scan_accumulate_mixed_total", "scan_accumulate",
                "row_gather", "mont_pow", "inv", "batch_inv_rows",
                "window_table", "combine_windows", "lane_row_sums",
                "tree_sum", "prefix_sum", "ntt_block")
# launches per library and wrapper (the row gather's under GATHER_CURVE)
CURVE_LAUNCHES = {c: dict.fromkeys(KERNEL_NAMES, 0) for c in LIBRARIES}


class _Totals(collections.abc.Mapping):
    """Launches per wrapper, summed over the libraries."""

    def __getitem__(self, name):
        return sum(counts[name] for counts in CURVE_LAUNCHES.values())

    def __iter__(self):
        return iter(KERNEL_NAMES)

    def __len__(self):
        return len(KERNEL_NAMES)


LAUNCHES = _Totals()

_libs = {}
build_seconds = {}      # library -> wall time of this process's build of it


def reset_launch_counts():
    for counts in CURVE_LAUNCHES.values():
        for k in counts:
            counts[k] = 0


@functools.cache
def _fields():
    """field name -> (library, id in its entry points: 0 = Fr, 1 = Fq of a
    curve; 0 = SMALL, 1 = LARGE of the test fields)"""
    return {spec.name: (name, fid) for name, library in LIBRARIES.items()
            for fid, spec in enumerate(library.specs())}


@functools.cache
def _groups():
    """group name -> (library, coordinate dimension: 1 = Fq, G1; 2 = Fq2,
    G2)"""
    return {g.name: (name, cd) for name, library in LIBRARIES.items()
            if library.bundle is not None
            for cd, g in ((1, library.bundle().g1), (2, library.bundle().g2))}


# ---------------------------------------------------------------------------
# build and load
# ---------------------------------------------------------------------------

def _words_macro(x: int) -> str:
    return "{" + ", ".join(
        f"0x{(x >> (32 * k)) & 0xFFFFFFFF:08x}u" for k in range(NUM_WORDS)) + "}"


def _modulus_macros(tag: str, spec: FieldSpec) -> list:
    """A modulus's words, one in Montgomery form and -p^-1 mod 2^32; for
    field.cuh's safegcd inversion p in nine 30-bit limbs, p^-1 mod 2^30
    and the words of R^3 mod p (the product by it turns the inverse of
    a R into a^-1 R).  Raises ValueError for p >= 2^255: field.cuh's add
    and product need 2p below 2^256 (the bound is argued there)."""
    if spec.p >= 1 << 255:
        raise ValueError(f"{spec.name}: the kernels need p < 2^255")
    limbs = ", ".join(str((spec.p >> (30 * i)) & (2**30 - 1))
                      for i in range(9))
    return [f"#define {tag}_P_WORDS {_words_macro(spec.p)}",
            f"#define {tag}_ONE_WORDS {_words_macro(spec.r_mod_p)}",
            f"#define {tag}_N0INV 0x{spec.n0inv32:08x}u",
            f"#define {tag}_P30_LIMBS {{{limbs}}}",
            f"#define {tag}_PINV30 0x{pow(spec.p, -1, 1 << 30):08x}u",
            f"#define {tag}_R3_WORDS "
            f"{_words_macro(pow(spec.r_mod_p, 3, spec.p))}"]


def constants_header() -> str:
    """constants.cuh: for every library, the moduli and Montgomery
    constants of its fields and, for a curve's Fq, the Fp2 non-residue and
    3 b on G1 and on the G2 twist; all as preprocessor macros.  Raises
    ValueError for a modulus of 2^255 or more."""
    lines = ["// generated from the field specs by ops/kernels.py",
             "#pragma once"]
    for library in LIBRARIES.values():
        for tag, spec in zip(library.tags, library.specs()):
            lines += _modulus_macros(tag, spec)
        if library.bundle is not None:
            cv, tq = library.bundle(), library.tags[1]
            lines += [f"#define {tq}_NR ({cv.nr})",
                      f"#define {tq}_G1_B3 {cv.b3}u",
                      f"#define {tq}_G2_B3_C0_WORDS "
                      f"{_words_macro(cv.fq.to_mont(cv.b3_g2[0]))}",
                      f"#define {tq}_G2_B3_C1_WORDS "
                      f"{_words_macro(cv.fq.to_mont(cv.b3_g2[1]))}"]
    return "\n".join(lines) + "\n"


def _nvcc() -> str:
    exe = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(exe):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return exe


def sources(library: str) -> tuple:
    """The sources of a library."""
    return LIBRARIES[library].sources


def build(library: str) -> pathlib.Path:
    """Compile a library's kernels (one nvcc per source, all started
    together) and link them into one shared library.  Returns its path; a
    library already built from the same sources is reused."""
    defs = LIBRARIES[library].defs
    consts = constants_header()
    h = hashlib.sha256(consts.encode())
    for name in HEADERS + sources(library):
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS + defs).encode())
    out_dir = BUILD_ROOT / f"kernels-{library}-{h.hexdigest()[:16]}"
    lib_path = out_dir / "liboctopuszk_kernels.so"
    if lib_path.exists():
        return lib_path
    t0 = time.perf_counter()
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "constants.cuh").write_text(consts)
    nvcc = _nvcc()
    procs = []
    for src in sources(library):
        obj = out_dir / (src[:-3] + ".o")
        log = open(out_dir / (src[:-3] + ".log"), "w")
        cmd = [nvcc, *NVCC_FLAGS, *defs, "-I", str(CSRC), "-I", str(out_dir),
               "-c", str(CSRC / src), "-o", str(obj)]
        procs.append((src, obj, log, subprocess.Popen(
            cmd, stdout=log, stderr=subprocess.STDOUT)))
    objs = []
    failed = []
    for src, obj, log, proc in procs:
        proc.wait()
        log.close()
        if proc.returncode != 0:
            failed.append(f"{src} ({library}):\n"
                          + (out_dir / (src[:-3] + ".log")).read_text())
        objs.append(str(obj))
    if failed:
        raise RuntimeError("nvcc failed\n" + "\n".join(failed))
    tmp = out_dir / f"liboctopuszk_kernels.{os.getpid()}.so"
    link = subprocess.run(
        [nvcc, "-shared", "-o", str(tmp), *objs],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError("nvcc link failed\n" + link.stdout)
    os.replace(tmp, lib_path)
    build_seconds[library] = time.perf_counter() - t0
    return lib_path


def compile_log(library: str) -> dict:
    """What ptxas said (registers, spills) in a library's build directory,
    by source."""
    path = build(library).parent
    return {src: (path / (src[:-3] + ".log")).read_text()
            for src in sources(library)}


def _argtypes():
    """Each entry point's C argument types."""
    vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    addrs = ctypes.POINTER(ctypes.c_ulonglong)
    words = ctypes.POINTER(ctypes.c_uint)
    return {
        "oz_butterfly": [ci, ci, vp, vp, vp, vp, vp, ll, vp],
        "oz_mont_mul": [ci, vp, vp, vp, ll, vp],
        "oz_mul_sub": [ci, vp, vp, vp, vp, ll, vp],
        "oz_add_points": [ci, addrs, addrs, addrs, ll, vp],
        "oz_double_points": [ci, addrs, addrs, ll, ci, ci, vp],
        "oz_scan_mixed": [ci, ci, vp, vp, ll, ll, ll, ci, ci, ci, addrs, vp],
        "oz_scan_full": [ci, vp, vp, ll, ll, ll, ci, ci, ci, addrs, vp],
        "oz_ntt_block": [ci, ci, vp, vp, vp, ctypes.POINTER(ll), vp, vp, ci,
                         ll, ll, vp],
        "oz_mont_pow": [ci, vp, vp, ll, words, ci, vp],
        "oz_inv": [ci, vp, vp, ll, vp],
        "oz_batch_inv_rows": [ci, vp, vp, ll, ll, vp],
        "oz_window_table": [ci, addrs, addrs, ll, ci, ci, addrs, vp, vp],
        "oz_combine_windows": [ci, addrs, ll, ci, ci, addrs, vp],
        "oz_lane_row_sums": [ci, addrs, ll, ll, ll, addrs, vp],
        "oz_tree_sum": [ci, addrs, addrs, ll, ll, addrs, vp, vp],
        "oz_prefix_sum": [ci, addrs, ll, ll, addrs, vp, vp],
        "oz_row_gather": [vp, ll, vp, ll, ci, vp, vp],
    }


def lib(library: str):
    """A library's loaded kernels (built at its first use)."""
    if library not in _libs:
        cdll = ctypes.CDLL(str(build(library)))
        types = _argtypes()
        for name in LIBRARIES[library].entries:
            fn = getattr(cdll, name)
            fn.argtypes, fn.restype = types[name], ctypes.c_int
        _libs[library] = cdll
    return _libs[library]


def _launch(fn, device, *args):
    """Call entry point ``fn`` with ``args`` and a stream on ``device``,
    the card the operands lie on: it is made the current device for the
    call (the launch, and a cooperative launch's grid size, follow the
    current device), and the stream is that device's current stream.
    Returns the entry point's code."""
    with torch.cuda.device(device):
        return fn(*args, ctypes.c_void_p(
            torch.cuda.current_stream(device).cuda_stream))


def _check(rc: int, name: str):
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: error {rc}")


def _addr_array(tensors):
    return (ctypes.c_ulonglong * len(tensors))(*[t.data_ptr() for t in tensors])


def _field_entry(spec: FieldSpec, name: str):
    """(entry point ``name`` of the field's library, the field's id there,
    the library)."""
    try:
        curve, fid = _fields()[spec.name]
    except KeyError:
        raise ValueError(f"no kernel for field {spec.name}") from None
    return getattr(lib(curve), name), fid, curve


def _group(group_name: str):
    """(curve, coordinate dimension) of a group the kernels know."""
    try:
        return _groups()[group_name]
    except KeyError:
        raise ValueError(f"no kernel for group {group_name}") from None


def _group_entry(group_name: str, name: str):
    """(entry point ``name`` of the group's curve, the curve)."""
    curve = _group(group_name)[0]
    return getattr(lib(curve), name), curve


def _field_operands(*tensors):
    """Broadcast word tensors to one shape; check type, layout and device.
    Returns contiguous tensors."""
    for t in tensors:
        if t.dtype != torch.int32 or t.dim() < 1 or t.shape[0] != NUM_WORDS:
            raise TypeError(
                f"expected int32[8, ...] words, got {t.dtype}{tuple(t.shape)}")
        if t.device != tensors[0].device:
            raise ValueError("operands lie on different devices")
    shape = fp.broadcast_shape(*tensors)
    return [t.expand(shape).contiguous() for t in tensors]


def _count(t: torch.Tensor) -> int:
    return t.numel() // NUM_WORDS


# ---------------------------------------------------------------------------
# (b) mont_mul, (c) mul_sub, (a) butterfly
# ---------------------------------------------------------------------------

def mont_mul_plain(spec: FieldSpec, a, b):
    """(a * b * R^-1) mod p: CIOS over the sixteen 16-bit halves of the
    words, held in int64 (one round per limb of a: add a_i * b, add m * p,
    shift one limb down), then one conditional subtract."""
    a, b = torch.broadcast_tensors(a, b)
    al, bl = fp.split16(a), fp.split16(b)
    p16 = fp.split16(torch.from_numpy(spec.p_words).to(a.device)).reshape(
        (2 * NUM_WORDS,) + (1,) * (a.dim() - 1))
    zrow = torch.zeros_like(al[:1])
    t = torch.zeros_like(al)
    for i in range(2 * NUM_WORDS):
        u = t + al[i] * bl
        m = (u[0] * spec.n0inv16) & HALF_MASK
        u = u + m * p16
        carry = u[0] >> HALF_BITS
        t = torch.cat([u[1:], zrow])
        t[0] += carry
    s, cout = fp._ripple(t, HALF_BITS)
    return fp._i32(fp._cond_sub_p(spec, fp.join16(s), extra_ge=cout != 0))


def mont_mul(spec: FieldSpec, a, b):
    """Elementwise Montgomery product of two broadcastable word tensors."""
    a, b = _field_operands(a, b)
    if not a.is_cuda:
        return mont_mul_plain(spec, a, b)
    out = torch.empty_like(a)
    if out.numel() == 0:            # nothing to launch, nothing counted
        return out
    fn, fid, curve = _field_entry(spec, "oz_mont_mul")
    rc = _launch(fn, a.device, fid, a.data_ptr(), b.data_ptr(),
                 out.data_ptr(), _count(a))
    _check(rc, "mont_mul")
    CURVE_LAUNCHES[curve]["mont_mul"] += 1
    return out


def mul_sub_plain(spec: FieldSpec, a, b, c):
    return fp.sub(spec, mont_mul_plain(spec, a, b), c)


def mul_sub(spec: FieldSpec, a, b, c):
    """a * b - c fused (the witness map's H = A*B - C on the coset)."""
    a, b, c = _field_operands(a, b, c)
    if not a.is_cuda:
        return mul_sub_plain(spec, a, b, c)
    out = torch.empty_like(a)
    if out.numel() == 0:
        return out
    fn, fid, curve = _field_entry(spec, "oz_mul_sub")
    rc = _launch(fn, a.device, fid, a.data_ptr(), b.data_ptr(), c.data_ptr(),
                 out.data_ptr(), _count(a))
    _check(rc, "mul_sub")
    CURVE_LAUNCHES[curve]["mul_sub"] += 1
    return out


def butterfly_plain(spec: FieldSpec, a, b, w, dif: bool):
    if dif:
        return (fp.add(spec, a, b),
                mont_mul_plain(spec, fp.sub(spec, a, b), w))
    t = mont_mul_plain(spec, b, w)
    return fp.add(spec, a, t), fp.sub(spec, a, t)


def butterfly(spec: FieldSpec, a, b, w, dif: bool):
    """One radix-2 stage on paired operands: DIF (a + b, (a - b) * w),
    DIT (a + w * b, a - w * b).  Returns (sum, diff)."""
    a, b, w = _field_operands(a, b, w)
    if not a.is_cuda:
        return butterfly_plain(spec, a, b, w, dif)
    o0, o1 = torch.empty_like(a), torch.empty_like(a)
    if o0.numel() == 0:
        return o0, o1
    fn, fid, curve = _field_entry(spec, "oz_butterfly")
    rc = _launch(fn, a.device, fid, int(bool(dif)), a.data_ptr(), b.data_ptr(),
                 w.data_ptr(), o0.data_ptr(), o1.data_ptr(), _count(a))
    _check(rc, "butterfly")
    CURVE_LAUNCHES[curve]["butterfly"] += 1
    return o0, o1


# ---------------------------------------------------------------------------
# (a)'s chain: ntt_block
# ---------------------------------------------------------------------------

# the longest transform ntt_block takes: its shared-memory copy is 33 bytes
# an element (132 KB at 2^12)
NTT_BLOCK_MAX = 1 << 12


@functools.cache
def bitrev_perm(n: int, device) -> torch.Tensor:
    """The bit-reversal permutation of range(n), n a power of two."""
    logn = n.bit_length() - 1
    idx = np.arange(n, dtype=np.int64)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(logn):
        rev |= ((idx >> b) & 1) << (logn - 1 - b)
    return torch.from_numpy(rev).to(device)


def butterfly_stages_plain(spec: FieldSpec, x, tw_table, dif: bool):
    """All log2(n) butterfly stages along axis 1 of ``x``: int32[8, n] or
    int32[8, n, B] (B independent trailing batches).

    Stage with half-block m: element i pairs with i ^ m; the one with bit m
    clear receives the sum, the other the difference; the twiddle of
    position j = i mod m is tw_table[j * n / 2m].  DIF runs m = n/2 ... 1
    with the twiddle applied after the subtract, DIT m = 1 ... n/2."""
    n = x.shape[1]
    logn = n.bit_length() - 1
    tail = tuple(x.shape[2:])
    ones = (1,) * len(tail)
    for s in range(logn):
        m = 1 << (logn - 1 - s if dif else s)
        blocks = n // (2 * m)
        v = x.reshape((x.shape[0], blocks, 2, m) + tail)
        w = tw_table[:, ::blocks].reshape((x.shape[0], 1, m) + ones)
        o0, o1 = butterfly_plain(spec, v[:, :, 0], v[:, :, 1], w, dif)
        x = torch.stack([o0, o1], dim=2).reshape(x.shape)
    return x


def ntt_block_plain(spec: FieldSpec, x, tw, dif: bool, pre=None, post=None):
    """post * T(pre * x) along axis 1: the butterfly stages over the batch,
    the bit reversal after DIF or before DIT, the products by the tables."""
    shape = (NUM_WORDS,) + tuple(x.shape[1:])
    if pre is not None:
        x = mont_mul_plain(spec, x, pre)
    L = shape[1]
    x = x.reshape(NUM_WORDS, L, -1)
    perm = bitrev_perm(L, x.device)
    if dif:
        y = butterfly_stages_plain(spec, x, tw, True)[:, perm]
    else:
        y = butterfly_stages_plain(spec, x[:, perm], tw, False)
    y = y.reshape(shape)
    if post is not None:
        y = mont_mul_plain(spec, y, post)
    return y.contiguous()


def _ntt_operand(t, shape, what: str):
    """``t`` (int32 words) broadcast to ``shape``, or None."""
    if t is None:
        return None
    if t.dtype != torch.int32 or t.dim() != len(shape) or t.shape[0] != NUM_WORDS:
        raise TypeError(f"{what} must be int32[8, ...] of {len(shape)} axes, "
                        f"got {t.dtype}{tuple(t.shape)}")
    return t.expand(shape)


def ntt_block(spec: FieldSpec, x, tw, dif: bool, pre=None, post=None):
    """B independent radix-2 transforms along axis 1 of ``x`` in one launch,
    every stage in shared memory: post * T(pre * x), natural order in and
    out.

    ``x``: int32[8, L, B] or int32[8, L, B1, B2] (any strides; the batch
    entries are its trailing axes), L = 2^k with 2 <= L <= NTT_BLOCK_MAX.
    ``tw``: int32[8, L/2], tw[k] = omega^k for the transform's root omega of
    order L.  ``dif``: the stage order (DIF, bit reversal on the stores; or
    DIT, on the loads): the same values either way.  ``pre`` / ``post``:
    optional tables broadcast to x's shape, multiplied before the stages
    (coset powers) and after them (4-step twiddles, coset powers, 1/n).
    Returns a contiguous tensor of x's shape."""
    if x.dtype != torch.int32 or x.dim() not in (3, 4) or x.shape[0] != NUM_WORDS:
        raise TypeError(f"expected int32[8, L, B] or int32[8, L, B1, B2], "
                        f"got {x.dtype}{tuple(x.shape)}")
    L = x.shape[1]
    if L < 2 or L & (L - 1) or L > NTT_BLOCK_MAX:
        raise ValueError(f"transform length must be a power of two in "
                         f"[2, {NTT_BLOCK_MAX}], got {L}")
    if tw.dtype != torch.int32 or tuple(tw.shape) != (NUM_WORDS, L // 2):
        raise TypeError(f"tw must be int32[8, {L // 2}], got "
                        f"{tw.dtype}{tuple(tw.shape)}")
    pre_v = _ntt_operand(pre, x.shape, "pre")
    post_v = _ntt_operand(post, x.shape, "post")
    for t in (tw, pre_v, post_v):
        if t is not None and t.device != x.device:
            raise ValueError("operands lie on different devices")
    if not x.is_cuda:
        return ntt_block_plain(spec, x, tw, dif, pre_v, post_v)
    out = torch.empty(x.shape, dtype=torch.int32, device=x.device)
    if out.numel() == 0:
        return out
    tw = tw.contiguous()
    if x.dim() == 3:                  # one batch axis: the outer one is 1
        x, pre_v, post_v = (None if t is None else t.unsqueeze(2)
                            for t in (x, pre_v, post_v))
    strides = []
    for t in (x, pre_v, post_v):
        strides += [0, 0, 0, 0] if t is None else list(t.stride())
    inner = x.shape[3]
    fn, fid, curve = _field_entry(spec, "oz_ntt_block")
    rc = _launch(
        fn, out.device, fid, int(bool(dif)), x.data_ptr(),
        None if pre_v is None else pre_v.data_ptr(),
        None if post_v is None else post_v.data_ptr(),
        (ctypes.c_longlong * 12)(*strides), tw.data_ptr(), out.data_ptr(),
        L.bit_length() - 1, out.numel() // (NUM_WORDS * L), inner)
    _check(rc, "ntt_block")
    CURVE_LAUNCHES[curve]["ntt_block"] += 1
    return out


# ---------------------------------------------------------------------------
# (b)'s chains: mont_pow, inv, batch_inv_rows
# ---------------------------------------------------------------------------

# lanes of the batch inversion kernel, one thread each, 128 a block with
# one inversion (PERF.md has the lane counts and designs measured,
# scripts/inv_designs.py)
INV_LANES = 1 << 16


def _exponent(e: int):
    """A host exponent 0 <= e < 2^256 as eight C words and its top set bit
    (-1 for 0)."""
    if not isinstance(e, int) or not 0 <= e < 1 << 256:
        raise ValueError(f"exponent must be an int in [0, 2^256), got {e!r}")
    words = (ctypes.c_uint * NUM_WORDS)(
        *[(e >> (32 * k)) & 0xFFFFFFFF for k in range(NUM_WORDS)])
    return words, e.bit_length() - 1


def mont_pow_plain(spec: FieldSpec, a, e: int):
    """a^e by square-and-multiply, most significant bit first, over the
    plain product; a^0 is one."""
    if e == 0:
        return fp.constant(spec.one_mont_words, a.shape[1:], a.device)
    acc = a
    for bit in bin(e)[3:]:
        acc = mont_mul_plain(spec, acc, acc)
        if bit == "1":
            acc = mont_mul_plain(spec, acc, a)
    return acc


def mont_pow(spec: FieldSpec, a, e: int):
    """Elementwise a^e (Montgomery in and out) for a host exponent
    0 <= e < 2^256: the whole square-and-multiply chain in one launch."""
    words, top = _exponent(e)
    (a,) = _field_operands(a)
    if not a.is_cuda:
        return mont_pow_plain(spec, a, e)
    out = torch.empty_like(a)
    if out.numel() == 0:
        return out
    fn, fid, curve = _field_entry(spec, "oz_mont_pow")
    rc = _launch(fn, a.device, fid, a.data_ptr(), out.data_ptr(), _count(a),
                 words, top)
    _check(rc, "mont_pow")
    CURVE_LAUNCHES[curve]["mont_pow"] += 1
    return out


def inv_plain(spec: FieldSpec, a):
    """The reference's own inversion, a^(p-2) by the Fermat chain over the
    plain product; inv(0) = 0."""
    return mont_pow_plain(spec, a, spec.p_minus_2)


def inv(spec: FieldSpec, a):
    """Elementwise inverse (Montgomery in and out, zero -> zero) in one
    launch: one thread per element runs the safegcd inversion of
    csrc/field.cuh (at most 600 divsteps in batches of 30, each batch's
    2x2 matrix applied to the 30-bit limbs), not the Fermat chain.  The
    inverse is unique, so the words are the plain version's."""
    (a,) = _field_operands(a)
    if not a.is_cuda:
        return inv_plain(spec, a)
    out = torch.empty_like(a)
    if out.numel() == 0:
        return out
    fn, fid, curve = _field_entry(spec, "oz_inv")
    rc = _launch(fn, a.device, fid, a.data_ptr(), out.data_ptr(), _count(a))
    _check(rc, "inv")
    CURVE_LAUNCHES[curve]["inv"] += 1
    return out


def batch_inv_rows_plain(spec: FieldSpec, a, lanes: int = INV_LANES):
    """Two-level Montgomery trick over a flat [8, n] batch: lane l owns
    positions [l rows, (l+1) rows); lane-parallel exclusive prefix
    products, one Fermat inversion of the lane totals (the plain
    inversion), a backward sweep.  Zero maps to zero."""
    n = a.shape[-1]
    lanes = min(lanes, n)
    rows = -(-n // lanes)
    m = rows * lanes
    zmask = fp.is_zero(a)
    one = fp.constant(spec.one_mont_words, a.shape[1:], a.device)
    a_safe = torch.where(zmask, one, a)
    if m != n:
        a_safe = torch.cat([a_safe, fp.constant(spec.one_mont_words, (m - n,),
                                                a.device)], dim=-1)
    xr = a_safe.reshape(NUM_WORDS, lanes, rows).permute(2, 0, 1).contiguous()
    carry = fp.constant(spec.one_mont_words, (lanes,), a.device)
    excl = []
    for r in range(rows):                 # exclusive prefix products
        excl.append(carry)
        carry = mont_mul_plain(spec, carry, xr[r])
    carry = mont_pow_plain(spec, carry, spec.p_minus_2)
    invs = [None] * rows
    for r in range(rows - 1, -1, -1):
        invs[r] = mont_mul_plain(spec, carry, excl[r])
        carry = mont_mul_plain(spec, carry, xr[r])
    flat = torch.stack(invs, dim=-1).reshape(NUM_WORDS, m)[:, :n]
    return torch.where(zmask, torch.zeros_like(a), flat)


def batch_inv_rows(spec: FieldSpec, a):
    """Elementwise inverse of a flat int32[8, n] batch (zero -> zero) in one
    launch over ``INV_LANES`` lanes: one thread per lane runs the forward
    sweep of prefix products and, after its block of 128 lanes has
    multiplied their totals and inverted the product (one safegcd
    inversion a block), the backward sweep.  The kernel's lane l owns
    positions l, l + lanes, ..., the plain version's a contiguous run; the
    inverse is unique, so the words do not depend on the layout."""
    if a.dtype != torch.int32 or a.dim() != 2 or a.shape[0] != NUM_WORDS:
        raise TypeError(
            f"expected a flat int32[8, n] batch, got {a.dtype}{tuple(a.shape)}")
    if not a.is_cuda:
        return batch_inv_rows_plain(spec, a)
    a = a.contiguous()
    out = torch.empty_like(a)
    n = a.shape[1]
    if n == 0:
        return out
    fn, fid, curve = _field_entry(spec, "oz_batch_inv_rows")
    rc = _launch(fn, a.device, fid, a.data_ptr(), out.data_ptr(), n,
                 min(INV_LANES, n))
    _check(rc, "batch_inv_rows")
    CURVE_LAUNCHES[curve]["batch_inv_rows"] += 1
    return out


# ---------------------------------------------------------------------------
# (d) add_points, (e) double_points
# ---------------------------------------------------------------------------

_PLAIN_OPS = {}


def plain_ops(group_name: str):
    """The coordinate-field namespace of a group over the plain CIOS, with
    its curve's Fq, Fp2 non-residue and b3."""
    if group_name not in _PLAIN_OPS:
        from octopuszk_tpu_torch.curves import group_ops
        curve, cd = _group(group_name)
        cv = LIBRARIES[curve].bundle()
        _PLAIN_OPS[group_name] = (
            group_ops.make_fp_ops(cv.fq, b3=cv.b3, group_name=group_name,
                                  mul=mont_mul_plain) if cd == 1 else
            group_ops.make_fp2_ops(cv.fq, nr=cv.nr, b3=cv.b3_g2,
                                   group_name=group_name,
                                   mul=mont_mul_plain))
    return _PLAIN_OPS[group_name]


def _point_operands(group_name: str, *points):
    """Flatten points to component lists broadcast to one batch shape."""
    from octopuszk_tpu_torch.curves.group_ops import flatten_coords
    _, cd = _group(group_name)
    flats = [flatten_coords(p) for p in points]
    for f in flats:
        if len(f) != 3 * cd:
            raise TypeError(f"{group_name} point needs {3 * cd} components")
    comps = _field_operands(*[t for f in flats for t in f])
    k = 3 * cd
    return cd, [comps[i * k:(i + 1) * k] for i in range(len(points))]


def add_points_plain(group_name: str, p, q):
    from octopuszk_tpu_torch.curves import group_ops
    return group_ops.add_formula(plain_ops(group_name), p, q)


def add_points(group_name: str, p, q):
    """Batched complete projective add, P + Q."""
    from octopuszk_tpu_torch.curves.group_ops import rebuild_coords
    cd, (fp_, fq_) = _point_operands(group_name, p, q)
    if not fp_[0].is_cuda:
        return add_points_plain(group_name, rebuild_coords(fp_, cd),
                                rebuild_coords(fq_, cd))
    outs = [torch.empty_like(t) for t in fp_]
    if outs[0].numel() == 0:
        return rebuild_coords(outs, cd)
    fn, curve = _group_entry(group_name, "oz_add_points")
    rc = _launch(fn, fp_[0].device, cd, _addr_array(fp_), _addr_array(fq_),
                 _addr_array(outs), _count(fp_[0]))
    _check(rc, "add_points")
    CURVE_LAUNCHES[curve]["add_points"] += 1
    return rebuild_coords(outs, cd)


def double_points_plain(group_name: str, p, times: int = 1,
                        every_step: bool = False):
    """``times`` plain doublings; with ``every_step`` the intermediates
    [2^1]P .. [2^times]P stacked on a new trailing axis."""
    from octopuszk_tpu_torch.curves import group_ops
    ops = plain_ops(group_name)
    steps = []
    for _ in range(times):
        p = group_ops.double_formula(ops, p)
        if every_step:
            steps.append(group_ops.flatten_coords(p))
    if not every_step:
        return p
    return group_ops.rebuild_coords(
        [torch.stack(cs, dim=-1) for cs in zip(*steps)], ops.coord_dim)


def double_points(group_name: str, p, times: int = 1,
                  every_step: bool = False):
    """Batched complete projective doubling chain: [2^times]P in one launch.
    With ``every_step`` it returns every intermediate [2^j]P, j = 1 ..
    times, on a new trailing axis of each coordinate.  One double (times =
    1) runs one thread per point; a chain (times >= 2), bound by one
    point's dependent latency, runs one warp per point with each field
    element spread over eight lanes and a double's products on the warp's
    four groups of lanes (csrc/lanes.cuh)."""
    from octopuszk_tpu_torch.curves.group_ops import rebuild_coords
    if times < 1:
        raise ValueError(f"times must be at least 1, got {times}")
    cd, (fp_,) = _point_operands(group_name, p)
    if not fp_[0].is_cuda:
        return double_points_plain(group_name, rebuild_coords(fp_, cd), times,
                                   every_step)
    shape = fp_[0].shape + ((times,) if every_step else ())
    outs = [torch.empty(shape, dtype=torch.int32, device=fp_[0].device)
            for _ in fp_]
    if outs[0].numel() == 0:
        return rebuild_coords(outs, cd)
    fn, curve = _group_entry(group_name, "oz_double_points")
    rc = _launch(fn, fp_[0].device, cd, _addr_array(fp_), _addr_array(outs),
                 _count(fp_[0]), times, int(bool(every_step)))
    _check(rc, "double_points")
    CURVE_LAUNCHES[curve]["double_points"] += 1
    return rebuild_coords(outs, cd)


# ---------------------------------------------------------------------------
# (d)'s chains: window_table, combine_windows, lane_row_sums, tree_sum,
# prefix_sum
# ---------------------------------------------------------------------------

def _points_out(comps, shape):
    return [torch.empty(shape, dtype=torch.int32, device=comps[0].device)
            for _ in comps]


def _batch_rows(comps, what: str):
    """(batch rows, last axis) of components [8, *batch, n]."""
    shape = comps[0].shape
    if len(shape) < 2:
        raise TypeError(f"{what} needs a last batch axis, got {tuple(shape)}")
    n = shape[-1]
    batch = 1
    for d in shape[1:-1]:
        batch *= d
    return batch, n


def window_table_plain(group_name: str, base, powers, w: int, outerc: int):
    """The masked loop: per window a row of 2^w identities; for each bit
    b, [2^(win w + b)] G (``base`` for j = 0, ``powers[..., j - 1]``
    after) is added to every entry and kept where bit b of the entry's
    digit is set.  The windows are independent and run as one batch."""
    from octopuszk_tpu_torch.curves import group_ops
    ops = plain_ops(group_name)
    B = 1 << w
    dev = group_ops.leaf(base).device
    iota = torch.arange(B, device=dev)
    # [2^j] G for j = 0 .. outerc w - 1: base, then powers
    allp = [torch.cat([g.reshape(NUM_WORDS, 1), p[..., :outerc * w - 1]],
                      dim=-1)
            for g, p in zip(group_ops.flatten_coords(base),
                            group_ops.flatten_coords(powers))]
    first = torch.arange(outerc, device=dev) * w
    row = group_ops.infinity(ops, (outerc, B), dev)
    for b in range(w):
        has_bit = ((iota >> b) & 1) == 1
        g_b = group_ops.rebuild_coords(
            [c[:, first + b, None].expand(NUM_WORDS, outerc, B)
             for c in allp], ops.coord_dim)
        row = group_ops.select_point(
            ops, has_bit, add_points_plain(group_name, row, g_b), row)
    return row


def window_table(group_name: str, base, powers, w: int, outerc: int):
    """Fixed-base window table T[win][d] = [d 2^(w win)] G, coordinates
    [8, outerc, 2^w], in one launch of w rounds: round t makes the entries
    d in [2^t, 2^(t+1)) of every window, T[win][d - 2^t] + [2^(win w + t)]
    G (the masked loop's last add for d, so the same words), one add per
    entry; the first rounds on one block per window, the rest across the
    card behind a grid-wide barrier.  ``base``: the point G (batch-less
    [8] or [8, 1]); ``powers``: [8, k] with point j - 1 = [2^j] G, k >=
    outerc w - 1 (``double_points(..., every_step=True)``)."""
    from octopuszk_tpu_torch.curves.group_ops import rebuild_coords
    if not (isinstance(w, int) and isinstance(outerc, int)
            and 1 <= w <= 24 and outerc >= 1):
        raise ValueError(f"need 1 <= w <= 24 and outerc >= 1, got {w}, "
                         f"{outerc}")
    cd, (fb,) = _point_operands(group_name, base)
    _, (fpw,) = _point_operands(group_name, powers)
    if fb[0].numel() != NUM_WORDS:
        raise TypeError("base must be one point")
    if fpw[0].dim() != 2 or fpw[0].shape[1] < outerc * w - 1:
        raise TypeError(f"powers must be int32[8, >= {outerc * w - 1}] "
                        f"components, got {tuple(fpw[0].shape)}")
    if fb[0].device != fpw[0].device:
        raise ValueError("operands lie on different devices")
    if not fb[0].is_cuda:
        return window_table_plain(group_name, base, powers, w, outerc)
    fb = [c.reshape(NUM_WORDS, 1) for c in fb]
    outs = _points_out(fb, (NUM_WORDS, outerc, 1 << w))
    count = torch.zeros(1, dtype=torch.int32, device=fb[0].device)
    fn, curve = _group_entry(group_name, "oz_window_table")
    rc = _launch(fn, fb[0].device, cd, _addr_array(fb), _addr_array(fpw),
                 fpw[0].shape[1], w, outerc, _addr_array(outs),
                 count.data_ptr())
    _check(rc, "window_table")
    CURVE_LAUNCHES[curve]["window_table"] += 1
    return rebuild_coords(outs, cd)


def combine_windows_plain(group_name: str, wins, c: int):
    """From the identity, most significant window first: acc = [2^c] acc +
    W_j."""
    from octopuszk_tpu_torch.curves import group_ops
    ops = plain_ops(group_name)
    lf = group_ops.leaf(wins)
    acc = group_ops.infinity(ops, tuple(lf.shape[1:-1]), lf.device)
    for j in range(lf.shape[-1] - 1, -1, -1):
        if c:
            acc = double_points_plain(group_name, acc, c)
        acc = add_points_plain(group_name, acc, group_ops._map_coords(
            wins, lambda a: a[..., j]))
    return acc


def combine_windows(group_name: str, wins, c: int):
    """Pippenger's window combination in one launch: window results [8,
    *batch, num_win] (least significant window first) -> [8, *batch];
    one warp per accumulator doubles c times and adds per window, each
    field element spread over eight lanes and a formula's independent
    products on the warp's four groups of lanes (csrc/lanes.cuh)."""
    from octopuszk_tpu_torch.curves.group_ops import rebuild_coords
    if not isinstance(c, int) or c < 0:
        raise ValueError(f"c must be a non-negative int, got {c!r}")
    cd, (comps,) = _point_operands(group_name, wins)
    batch, num_win = _batch_rows(comps, "window results")
    if num_win == 0:
        raise ValueError("no window results to combine")
    if not comps[0].is_cuda:
        return combine_windows_plain(group_name, rebuild_coords(comps, cd), c)
    outs = _points_out(comps, comps[0].shape[:-1])
    if batch == 0:
        return rebuild_coords(outs, cd)
    fn, curve = _group_entry(group_name, "oz_combine_windows")
    rc = _launch(fn, comps[0].device, cd, _addr_array(comps), batch, num_win,
                 c, _addr_array(outs))
    _check(rc, "combine_windows")
    CURVE_LAUNCHES[curve]["combine_windows"] += 1
    return rebuild_coords(outs, cd)


def lane_row_sums_plain(group_name: str, p, width: int):
    """The identity-padded last axis as ``width`` lanes of rows = ceil(n /
    width) positions each (lane l owns [l rows, (l+1) rows)); per lane,
    from the identity, add the rows in order."""
    from octopuszk_tpu_torch.curves import group_ops
    ops = plain_ops(group_name)
    lf = group_ops.leaf(p)
    n = lf.shape[-1]
    rows = -(-n // width)
    if rows * width != n:
        pad = group_ops.infinity(ops, tuple(lf.shape[1:-1]) +
                                 (rows * width - n,), lf.device)
        p = tuple(group_ops._cat_coord(c, f) for c, f in zip(p, pad))
    p = group_ops._map_coords(
        p, lambda c: c.reshape(c.shape[:-1] + (width, rows)))
    acc = group_ops.infinity(ops, tuple(lf.shape[1:-1]) + (width,), lf.device)
    for r in range(rows):
        acc = add_points_plain(group_name, acc, group_ops._map_coords(
            p, lambda c: c[..., r]))
    return acc


def lane_row_sums(group_name: str, p, width: int):
    """The row loop of a two-level sum in one launch: points [8, *batch, n]
    -> lane totals [8, *batch, width] (1 <= width <= n), each (batch row,
    lane) adding its rows in order from the identity on two threads that
    split every add's products (csrc/rcb.cuh pt_add_pair)."""
    from octopuszk_tpu_torch.curves.group_ops import rebuild_coords
    cd, (comps,) = _point_operands(group_name, p)
    batch, n = _batch_rows(comps, "points")
    if not isinstance(width, int) or not 1 <= width <= n:
        raise ValueError(f"width must be in [1, {n}], got {width!r}")
    if not comps[0].is_cuda:
        return lane_row_sums_plain(group_name, rebuild_coords(comps, cd),
                                   width)
    outs = _points_out(comps, comps[0].shape[:-1] + (width,))
    if batch == 0:
        return rebuild_coords(outs, cd)
    fn, curve = _group_entry(group_name, "oz_lane_row_sums")
    rc = _launch(fn, comps[0].device, cd, _addr_array(comps), batch, n, width,
                 _addr_array(outs))
    _check(rc, "lane_row_sums")
    CURVE_LAUNCHES[curve]["lane_row_sums"] += 1
    return rebuild_coords(outs, cd)


def _hillis_steele(group_name: str, p, toward_front: bool):
    """Every level of a Hillis-Steele fold along the last axis: level l
    adds to element j element j + 2^l (suffix, ``toward_front``) or
    j - 2^l (prefix), the identity past either end."""
    from octopuszk_tpu_torch.curves import group_ops
    ops = plain_ops(group_name)
    n = group_ops.leaf(p).shape[-1]
    d = 1
    while d < n:
        p = add_points_plain(group_name, p, group_ops._shift_points(
            ops, p, d, toward_front))
        d *= 2
    return p


def tree_sum_plain(group_name: str, p):
    """Element 0 of the Hillis-Steele suffix fold."""
    from octopuszk_tpu_torch.curves import group_ops
    return group_ops._index_last(_hillis_steele(group_name, p, True), 0)


def prefix_sum_plain(group_name: str, p):
    """The Hillis-Steele inclusive prefix fold."""
    return _hillis_steele(group_name, p, False)


def _levels_launch(group_name, p, name):
    from octopuszk_tpu_torch.curves.group_ops import rebuild_coords
    cd, (comps,) = _point_operands(group_name, p)
    batch, n = _batch_rows(comps, "points")
    if n == 0:
        raise ValueError(f"{name} over an empty axis")
    tree = name == "tree_sum"
    if not comps[0].is_cuda:
        plain = tree_sum_plain if tree else prefix_sum_plain
        return plain(group_name, rebuild_coords(comps, cd))
    outs = _points_out(comps, comps[0].shape[:-1] if tree
                       else comps[0].shape)
    if batch == 0:
        return rebuild_coords(outs, cd)
    # the tree's counts of arrived subtrees (at most ceil(n / 2) a row) and
    # its scratch; the prefix's ticket and counts of arrived tiles a row
    words = batch * ((n + 1) // 2) if tree else 1 + batch
    count = torch.zeros(words, dtype=torch.int32, device=comps[0].device)
    fn, curve = _group_entry(group_name, "oz_" + name)
    scratch = [_points_out(comps, comps[0].shape)] if tree else []
    rc = _launch(fn, comps[0].device, cd, _addr_array(comps),
                 *map(_addr_array, scratch), batch, n, _addr_array(outs),
                 count.data_ptr())
    _check(rc, name)
    CURVE_LAUNCHES[curve][name] += 1
    return rebuild_coords(outs, cd)


def tree_sum(group_name: str, p):
    """Sum along the last axis in one launch: points [8, *batch, n] ->
    [8, *batch], element 0 of the Hillis-Steele suffix fold of
    group_ops.tree_reduce, computed as the pairwise tree that gives it
    (n - 1 adds and the adds with the identity past the end): subtrees of
    256 leaves on blocks, each add on two threads, the roots of a row's
    subtrees added by the last of its blocks to finish."""
    return _levels_launch(group_name, p, "tree_sum")


def prefix_sum(group_name: str, p):
    """Inclusive prefix sums along the last axis in one launch: every add
    of the Hillis-Steele dataflow (level l adds element j - 2^l into
    element j, the identity below 0), levels 0 .. 3 on tiles of a row in
    shared memory (each recomputing the 15 elements before it), then,
    after one wait for the row's tiles, the later levels on each residue
    class mod 16 of a row (which they never leave) in shared memory; each
    add on one thread (G1) or two (G2), G1's adds of the identity as (X Y,
    Y^2, Y Z), their words."""
    return _levels_launch(group_name, p, "prefix_sum")


# ---------------------------------------------------------------------------
# (f) scan_accumulate_mixed, (g) scan_accumulate_mixed_total
# ---------------------------------------------------------------------------

def _scan_operands(group_name: str, packed, idx2):
    _, cd = _group(group_name)
    if (packed.dtype != torch.int32 or packed.dim() != 2
            or packed.shape[1] != 2 * cd * NUM_WORDS
            or not packed.is_contiguous()):
        raise TypeError(
            f"packed base must be contiguous int32[n, {2 * cd * NUM_WORDS}], "
            f"got {packed.dtype}{tuple(packed.shape)}")
    if idx2.dtype != torch.int32 or idx2.dim() != 3:
        raise TypeError("idx2 must be int32[batch, rows, lanes]")
    if idx2.device != packed.device:
        raise ValueError("operands lie on different devices")
    if packed.is_cuda and packed.data_ptr() % 16 != 0:
        raise ValueError("packed base must be 16-byte aligned")
    return cd


def _scan_plain(group_name: str, packed, idx2, write_prefix: bool):
    """Per lane, mixed-add the gathered rows onto a projective running sum
    that starts at the identity: a Python loop over the rows."""
    from octopuszk_tpu_torch.curves import group_ops
    ops = plain_ops(group_name)
    cd = _scan_operands(group_name, packed, idx2)
    batch, rows, lanes = idx2.shape
    e = idx2.to(torch.int64)
    carry = group_ops.infinity(ops, (batch, lanes), packed.device)
    prefixes = []
    for r in range(rows):
        pts = packed[e[:, r] >> 1]                       # [batch, lanes, C]
        comps = list(pts.permute(2, 0, 1).reshape(
            2 * cd, NUM_WORDS, batch, lanes).unbind(0))
        negb = (e[:, r] & 1) != 0
        for i in range(cd, 2 * cd):                      # negate Y
            comps[i] = torch.where(negb, fp.neg(ops.spec, comps[i]),
                                   comps[i])
        q = group_ops.rebuild_coords(comps, cd)
        q_inf = ops.is_zero(q[1])                        # Y == 0: identity
        carry = group_ops.mixed_add(ops, carry, q, q_inf_mask=q_inf)
        if write_prefix:
            prefixes.append(carry)
    if not write_prefix:
        return carry
    flat = [torch.stack(cs, dim=2) for cs in zip(
        *[group_ops.flatten_coords(p) for p in prefixes])]
    return group_ops.rebuild_coords(flat, cd)


def _scan_launch(group_name, packed, idx2, write_prefix, name):
    from octopuszk_tpu_torch.curves.group_ops import rebuild_coords
    cd = _scan_operands(group_name, packed, idx2)
    batch, rows, lanes = idx2.shape
    shape = ((NUM_WORDS, batch, rows, lanes) if write_prefix
             else (NUM_WORDS, batch, lanes))
    outs = [torch.empty(shape, dtype=torch.int32, device=packed.device)
            for _ in range(3 * cd)]
    if outs[0].numel() == 0:
        return rebuild_coords(outs, cd)
    sb, sr, sl = idx2.stride()
    fn, curve = _group_entry(group_name, "oz_scan_mixed")
    rc = _launch(fn, packed.device, cd, int(write_prefix), packed.data_ptr(),
                 idx2.data_ptr(), sb, sr, sl, batch, rows, lanes,
                 _addr_array(outs))
    _check(rc, name)
    CURVE_LAUNCHES[curve][name] += 1
    return rebuild_coords(outs, cd)


def scan_accumulate_mixed_plain(group_name: str, packed, idx2):
    return _scan_plain(group_name, packed, idx2, True)


def scan_accumulate_mixed(group_name: str, packed, idx2):
    """Inclusive per-lane prefix sums of gathered affine rows.

    ``packed``: int32[n, 16 | 32], one affine point per row (identity = all
    zero).  ``idx2``: int32[batch, rows, lanes] (any strides), entries
    (point index << 1) | negate.  Lane (b, l) sums rows 0..r of its column;
    returns projective coordinates int32[8, batch, rows, lanes]."""
    if not packed.is_cuda:
        return scan_accumulate_mixed_plain(group_name, packed, idx2)
    return _scan_launch(group_name, packed, idx2, True,
                        "scan_accumulate_mixed")


def scan_accumulate_mixed_total_plain(group_name: str, packed, idx2):
    return _scan_plain(group_name, packed, idx2, False)


def scan_accumulate_mixed_total(group_name: str, packed, idx2):
    """The same scan, lane totals only: int32[8, batch, lanes]."""
    if not packed.is_cuda:
        return scan_accumulate_mixed_total_plain(group_name, packed, idx2)
    return _scan_launch(group_name, packed, idx2, False,
                        "scan_accumulate_mixed_total")


# ---------------------------------------------------------------------------
# (h) scan_accumulate
# ---------------------------------------------------------------------------

def _scan_full_operands(group_name: str, points, idx):
    """Check a point batch [n] and an index int32[batch, rows, lanes];
    returns (coord_dim, contiguous components)."""
    cd, (comps,) = _point_operands(group_name, points)
    if comps[0].dim() != 2:
        raise TypeError("points must be a flat batch of int32[8, n] "
                        f"components, got {tuple(comps[0].shape)}")
    if idx.dtype != torch.int32 or idx.dim() != 3:
        raise TypeError("idx must be int32[batch, rows, lanes]")
    if idx.device != comps[0].device:
        raise ValueError("operands lie on different devices")
    return cd, comps


def _full_scan_plain(group_name: str, idx, row_points, device):
    """Per lane, full-add the points of each row of ``idx`` onto a projective
    running sum that starts at the identity: a Python loop over the rows.
    ``row_points(e)`` gives the component list of the points an index
    tensor names."""
    from octopuszk_tpu_torch.curves import group_ops
    ops = plain_ops(group_name)
    batch, rows, lanes = idx.shape
    e = idx.to(torch.int64)
    carry = group_ops.infinity(ops, (batch, lanes), device)
    prefixes = []
    for r in range(rows):
        q = group_ops.rebuild_coords(row_points(e[:, r]), ops.coord_dim)
        carry = group_ops.add_formula(ops, carry, q)
        prefixes.append(group_ops.flatten_coords(carry))
    flat = [torch.stack(cs, dim=2) for cs in zip(*prefixes)]
    return group_ops.rebuild_coords(flat, ops.coord_dim)


def scan_accumulate_plain(group_name: str, points, idx):
    """The scan over the point batch's components, indexed directly."""
    _, comps = _scan_full_operands(group_name, points, idx)
    return _full_scan_plain(group_name, idx, lambda e: [c[:, e] for c in comps],
                            comps[0].device)


def _point_rows(comps):
    """The components int32[8, n] of a projective batch as rows
    int32[n, 24 | 48]: X, Y, Z (G2: X.c0, X.c1, Y.c0, ...), eight words
    each; a layout copy."""
    n = comps[0].shape[1]
    return torch.stack([c.T for c in comps], dim=1).reshape(
        n, len(comps) * NUM_WORDS)


def _scan_rows_plain(group_name: str, rows_t, idx):
    """The scan reading the repacked rows, as the kernel reads them."""
    def row_points(e):
        return list(rows_t[e].permute(2, 0, 1).reshape(
            -1, NUM_WORDS, *e.shape).unbind(0))
    return _full_scan_plain(group_name, idx, row_points, rows_t.device)


def scan_accumulate(group_name: str, points, idx):
    """Inclusive per-lane prefix sums of indexed projective points.

    ``points``: a projective batch of n points (``int32[8, n]``
    components).  ``idx``: int32[batch, rows, lanes] (any strides) of point
    indices.  Lane (b, l) sums the points of rows 0..r of its column with
    the complete full add; returns projective coordinates
    int32[8, batch, rows, lanes].  The batch is repacked once per call into
    point rows, which the kernel reads through the index."""
    from octopuszk_tpu_torch.curves.group_ops import rebuild_coords
    cd, comps = _scan_full_operands(group_name, points, idx)
    rows_t = _point_rows(comps)
    if not rows_t.is_cuda:
        return _scan_rows_plain(group_name, rows_t, idx)
    batch, rows, lanes = idx.shape
    outs = [torch.empty((NUM_WORDS, batch, rows, lanes), dtype=torch.int32,
                        device=comps[0].device) for _ in range(3 * cd)]
    if outs[0].numel() == 0 or _count(comps[0]) == 0:
        return rebuild_coords(outs, cd)
    sb, sr, sl = idx.stride()
    fn, curve = _group_entry(group_name, "oz_scan_full")
    rc = _launch(fn, rows_t.device, cd, rows_t.data_ptr(), idx.data_ptr(), sb,
                 sr, sl, batch, rows, lanes, _addr_array(outs))
    _check(rc, "scan_accumulate")
    CURVE_LAUNCHES[curve]["scan_accumulate"] += 1
    return rebuild_coords(outs, cd)


# ---------------------------------------------------------------------------
# (i) row_gather
# ---------------------------------------------------------------------------

def _gather_operands(table, idx):
    if (table.dtype != torch.int32 or table.dim() != 2
            or table.shape[1] == 0 or table.shape[1] % 4 != 0
            or not table.is_contiguous()):
        raise TypeError("table must be contiguous int32[R, W] with W a "
                        f"positive multiple of 4, got {table.dtype}"
                        f"{tuple(table.shape)}")
    if idx.dtype != torch.int32 or idx.dim() != 1 or not idx.is_contiguous():
        raise TypeError(f"idx must be contiguous int32[m], got {idx.dtype}"
                        f"{tuple(idx.shape)}")
    if idx.device != table.device:
        raise ValueError("operands lie on different devices")


def row_gather_plain(table, idx):
    """out[j] = table[idx[j]]; raises IndexError on an index outside
    [0, R)."""
    return torch.index_select(table, 0, idx.long())


def row_gather(table, idx):
    """Gather rows: ``table`` int32[R, W] (W a multiple of 4, 16-byte
    aligned), ``idx`` int32[m] -> int32[m, W].  On the card an index
    outside [0, R) aborts the kernel, and the next synchronisation raises."""
    _gather_operands(table, idx)
    if not table.is_cuda:
        return row_gather_plain(table, idx)
    if table.data_ptr() % 16 != 0:
        raise ValueError("table must be 16-byte aligned")
    out = torch.empty((idx.shape[0], table.shape[1]), dtype=torch.int32,
                      device=table.device)
    if out.numel() == 0:
        return out
    if table.shape[0] == 0:
        raise IndexError("gather from an empty table")
    rc = _launch(lib(GATHER_CURVE).oz_row_gather, table.device,
                 table.data_ptr(), table.shape[0], idx.data_ptr(),
                 idx.shape[0], table.shape[1], out.data_ptr())
    _check(rc, "row_gather")
    CURVE_LAUNCHES[GATHER_CURVE]["row_gather"] += 1
    return out
