"""Montgomery product with its reduction on the tensor cores (SOS + matmul
REDC): the port of octopuszk_tpu/ops/mxu_mont.py, an experiment.

A batched product a_i * b_i of independent pairs has no shared operand, so
it cannot be a matrix product.  The Montgomery reduction, though, is two
products by fixed constants (N' = -p^-1 mod R and p), and a product by a
constant is a matrix product: with the constant's 8-bit limbs laid out as
a Toeplitz band T[k, j] = c_{k-j}, T @ x8 is c * x for the whole batch in
one [K, 32] x [32, n] contraction.  8-bit limbs in bfloat16 keep every
product (< 2^16) and every 32-term sum (< 2^21) exact in a float32 result.

  1. wide = a * b             school-book on 16-bit halves, int64
  2. m    = wide_lo * N' mod R   [32, 32] Toeplitz matmul
  3. t    = (wide + m * p) / R   [64, 32] Toeplitz matmul, then one
                                 conditional subtract

against the interleaved CIOS of kernel (b) (ops/kernels.py mont_mul).  The
matmuls are ``torch.mm`` of bfloat16 operands with a float32 result, on
the card the H100's tensor cores (the reference leaves them to XLA's
``dot_general`` outside any Pallas kernel); the carries are plain tensor
code.  ``scripts/mxu_experiment.py`` times it against kernel (b).  The
result is canonical, so it equals ``fields/fp.py mont_mul`` bit for bit.

A CUDA tensor is computed on its card, a CPU tensor on the CPU (where the
matmul takes the same bfloat16 values as float32 operands: the CPU has no
bfloat16 product with a float32 result); nothing moves between the two.
"""

from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch

from octopuszk_tpu_torch.fields import fp
from octopuszk_tpu_torch.fields.spec import FieldSpec, HALF_BITS, R_BITS

L = 2 * fp.W            # 16-bit limbs of an element


@functools.cache
def redc_mats(spec: FieldSpec, device):
    """(NP8 [32, 32], P8 [64, 32]): the Toeplitz band matrices of N' =
    -p^-1 mod 2^256 (low-truncated: mod-R arithmetic) and of p over 8-bit
    limbs, bfloat16 on ``device``, built once per field and device."""
    p = spec.p
    n_prime = (-pow(p, -1, 1 << R_BITS)) % (1 << R_BITS)
    npb = [(n_prime >> (8 * i)) & 0xFF for i in range(32)]
    pb = [(p >> (8 * i)) & 0xFF for i in range(32)]
    np8 = np.zeros((32, 32), np.float32)
    for k in range(32):
        for j in range(k + 1):
            np8[k, j] = npb[k - j]
    p8 = np.zeros((64, 32), np.float32)
    for k in range(64):
        for j in range(max(0, k - 31), min(32, k + 1)):
            p8[k, j] = pb[k - j]
    return tuple(torch.from_numpy(m).to(device=device, dtype=torch.bfloat16)
                 for m in (np8, p8))


def _split8(x16):
    """int64[K, n] 16-bit limbs -> bfloat16[2K, n] 8-bit limbs
    (little-endian; a value below 256 is exact in bfloat16)."""
    y = torch.stack([x16 & 0xFF, x16 >> 8], dim=1)
    return y.reshape(2 * x16.shape[0], x16.shape[1]).to(torch.bfloat16)


def _comb16(y8):
    """int64[2K, n] 8-bit-position sums (< 2^21) -> int64[K, n] 16-bit
    positions (< 2^30): w16[k] = y[2k] + 256 y[2k+1]."""
    return y8[0::2] + (y8[1::2] << 8)


@contextlib.contextmanager
def _exact_bf16_reduction():
    """cuBLAS may not reduce a bfloat16 product in reduced precision while
    this holds; the setting is restored after."""
    flags = torch.backends.cuda.matmul
    old = flags.allow_bf16_reduced_precision_reduction
    flags.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        flags.allow_bf16_reduced_precision_reduction = old


def matmul(mat_bf16, x8_bf16):
    """[K, 32] x [32, n] -> int64[K, n], an exact integer product: bfloat16
    operands, float32 result (every value below 2^21)."""
    if x8_bf16.is_cuda:
        with _exact_bf16_reduction():
            y = torch.mm(mat_bf16, x8_bf16, out_dtype=torch.float32)
    else:
        y = torch.mm(mat_bf16.float(), x8_bf16.float())
    return y.to(torch.int64)


def _wide_product(a16, b16):
    """School-book 512-bit product of int64[16, n] 16-bit limbs: int64[32,
    n] column sums of 16 products below 2^32 each (< 2^36)."""
    t = torch.zeros((2 * L,) + tuple(a16.shape[1:]), dtype=torch.int64,
                    device=a16.device)
    for i in range(L):
        t[i:i + L] += a16[i] * b16
    return t


def mont_mul_sos_mxu(spec: FieldSpec, a, b):
    """(a * b * R^-1) mod p of int32[8, n] words (canonical Montgomery), bit
    for bit the words of fields/fp.py mont_mul, with the reduction's two
    fixed-operand products as Toeplitz matmuls."""
    a, b = torch.broadcast_tensors(a, b)
    n = a.shape[1]
    np8, p8 = redc_mats(spec, a.device)
    w, _ = fp._ripple(_wide_product(fp.split16(a), fp.split16(b)),
                      HALF_BITS)                          # [32, n] canonical
    # m = (wide mod R) N' mod R: the carry out of limb 15 is dropped
    m, _ = fp._ripple(_comb16(matmul(np8, _split8(w[:L]))), HALF_BITS)
    # t = wide + m p; its low 16 limbs come out zero
    zrow = torch.zeros((1, n), dtype=torch.int64, device=a.device)
    tt = torch.cat([w, zrow]) + torch.cat(
        [_comb16(matmul(p8, _split8(m))), zrow])
    s, _ = fp._ripple(tt, HALF_BITS)                      # [33, n]
    return fp._i32(fp._cond_sub_p(spec, fp.join16(s[L:2 * L]),
                                  extra_ge=s[2 * L] != 0))
