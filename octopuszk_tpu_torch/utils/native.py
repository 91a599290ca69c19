"""ctypes binding of the host marshaling library (csrc/marshal.c): packed
little-endian byte records <-> word-major ``int32[8, n]``.

``build()`` compiles it with the host's C compiler into ``build/`` (keyed
by a hash of the source); ``lib()`` loads that build where it exists and
returns None otherwise, as do ``bytes_to_words`` and ``words_to_bytes``.
utils/bigint.py's numpy transpose gives the same words, and is the one
path the port's host code calls: this library saves about 4 % of
``ints_to_words`` at 2^20, whose python loop of ``int.to_bytes`` is the
rest (PERF.md).  This is host code: it runs no kernel.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess

import numpy as np

SOURCE = pathlib.Path(__file__).resolve().parent.parent / "csrc" / "marshal.c"
BUILD_ROOT = pathlib.Path(__file__).resolve().parent.parent.parent / "build"
CFLAGS = ("-O3", "-fPIC", "-shared", "-fvisibility=hidden", "-Wall")
NUM_WORDS = 8
RECORD_BYTES = 4 * NUM_WORDS

_LIB = None


@functools.cache
def _tag() -> str:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CFLAGS).encode())
    return h.hexdigest()[:16]


def path() -> pathlib.Path:
    """Where the library of this source is built."""
    return BUILD_ROOT / f"native-{_tag()}" / "libmarshal.so"


def _compiler() -> str:
    for name in ("cc", "gcc", "clang"):
        exe = shutil.which(name)
        if exe:
            return exe
    raise RuntimeError("no host C compiler: the marshaling library cannot "
                       "be built")


def build() -> pathlib.Path:
    """Compile csrc/marshal.c with the host's C compiler (once per source)
    and return the library's path."""
    out = path()
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"libmarshal.{os.getpid()}.so")
        run = subprocess.run([_compiler(), *CFLAGS, "-o", str(tmp),
                              str(SOURCE)], capture_output=True, text=True)
        if run.returncode != 0:
            raise RuntimeError("building the marshaling library failed\n"
                               + run.stdout + run.stderr)
        os.replace(tmp, out)
    return out


def lib():
    """The loaded library, or None where it is not built."""
    global _LIB
    if _LIB is None and path().exists():
        cdll = ctypes.CDLL(str(path()))
        cdll.bytes_to_words.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p]
        cdll.bytes_to_words.restype = None
        cdll.words_to_bytes.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_char_p]
        cdll.words_to_bytes.restype = None
        _LIB = cdll
    return _LIB


def available() -> bool:
    return lib() is not None


def bytes_to_words(raw: bytes, n: int, nbytes: int) -> np.ndarray | None:
    """n records of ``nbytes`` little-endian bytes (1 <= nbytes <= 32) ->
    int32[8, n] words, word-major; None where the library is not built."""
    cdll = lib()
    if cdll is None:
        return None
    if not 1 <= nbytes <= RECORD_BYTES or len(raw) != n * nbytes:
        raise ValueError(f"expected {n} records of 1..{RECORD_BYTES} bytes, "
                         f"got {len(raw)} bytes of {nbytes}-byte records")
    out = np.empty((NUM_WORDS, n), dtype=np.int32)
    cdll.bytes_to_words(raw, n, nbytes, out.ctypes.data)
    return out


def words_to_bytes(words) -> bytes | None:
    """int32[8, n] words -> n records of 32 little-endian bytes; None where
    the library is not built."""
    cdll = lib()
    if cdll is None:
        return None
    arr = np.ascontiguousarray(words)
    if (arr.ndim != 2 or arr.shape[0] != NUM_WORDS or arr.dtype.kind not in "iu"
            or arr.dtype.itemsize != 4):
        raise ValueError(f"expected int32[8, n] words, got {arr.dtype}"
                         f"{arr.shape}")
    n = arr.shape[1]
    out = ctypes.create_string_buffer(n * RECORD_BYTES)
    cdll.words_to_bytes(arr.ctypes.data, n, out)
    return out.raw
