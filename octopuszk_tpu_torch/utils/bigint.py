"""Host-side conversions between python ints and word tensors.

A field element is eight little-endian 32-bit words; a batch is laid out
word-major, ``int32[8, n]`` (the bit pattern of unsigned words), so that on
the card thread ``i`` reads word ``k`` at ``k * n + i``.  These helpers run
only at program edges (assignments in, proof points out, test oracles).
"""

from __future__ import annotations

import numpy as np

NUM_WORDS = 8
WORD_BITS = 32
NBYTES = NUM_WORDS * WORD_BITS // 8


def int_to_words(x: int) -> np.ndarray:
    """One python int in [0, 2^256) -> int32[8] little-endian words."""
    if x < 0:
        raise ValueError("negative")
    return np.frombuffer(int(x).to_bytes(NBYTES, "little"),
                         dtype="<u4").astype(np.uint32).view(np.int32).copy()


def ints_to_bytes(xs) -> bytes:
    """List of n python ints in [0, 2^256) -> n records of 32 little-endian
    bytes (the python loop of ``ints_to_words``)."""
    buf = bytearray(len(xs) * NBYTES)
    for j, x in enumerate(xs):
        buf[j * NBYTES:(j + 1) * NBYTES] = int(x).to_bytes(NBYTES, "little")
    return bytes(buf)


def bytes_to_words_numpy(raw: bytes, n: int) -> np.ndarray:
    """n records of 32 little-endian bytes -> int32[8, n], by a numpy
    transpose (the words of utils/native.py bytes_to_words, which the
    port does not call, PERF.md)."""
    arr = np.frombuffer(raw, dtype="<u4").reshape(n, NUM_WORDS)
    return np.ascontiguousarray(arr.T).view(np.int32)


def words_to_bytes_numpy(arr: np.ndarray) -> bytes:
    """uint32[8, n] -> n records of 32 little-endian bytes."""
    return np.ascontiguousarray(arr.T).astype("<u4").tobytes()


def ints_to_words(xs) -> np.ndarray:
    """List of n python ints -> int32[8, n] (word-major layout)."""
    return bytes_to_words_numpy(ints_to_bytes(xs), len(xs))


def words_to_ints(words) -> list:
    """int32[8, ...] -> list of python ints (batch flattened)."""
    arr = np.ascontiguousarray(np.asarray(words)).view(np.uint32)
    arr = arr.reshape(NUM_WORDS, -1)
    raw = words_to_bytes_numpy(arr)
    return [int.from_bytes(raw[j * NBYTES:(j + 1) * NBYTES], "little")
            for j in range(arr.shape[1])]
