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


def ints_to_words(xs) -> np.ndarray:
    """List of n python ints -> int32[8, n] (word-major layout)."""
    n = len(xs)
    buf = bytearray(n * NBYTES)
    for j, x in enumerate(xs):
        buf[j * NBYTES:(j + 1) * NBYTES] = int(x).to_bytes(NBYTES, "little")
    arr = np.frombuffer(bytes(buf), dtype="<u4").reshape(n, NUM_WORDS)
    return np.ascontiguousarray(arr.T).view(np.int32)


def words_to_ints(words) -> list:
    """int32[8, ...] -> list of python ints (batch flattened)."""
    arr = np.ascontiguousarray(np.asarray(words)).view(np.uint32)
    arr = arr.reshape(NUM_WORDS, -1)
    raw = np.ascontiguousarray(arr.T).astype("<u4").tobytes()
    return [int.from_bytes(raw[j * NBYTES:(j + 1) * NBYTES], "little")
            for j in range(arr.shape[1])]
