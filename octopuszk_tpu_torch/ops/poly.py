"""Polynomial evaluation over Fr word tensors.

Port of ``octopuszk_tpu/ops/poly.py``: p(x) as a powers table times the
coefficients, summed exactly.  The reference sums 16-bit limbs as uint32 in
chunks of 2^13 so that no limb sum overflows; here the words are split into
16-bit digits (``fp.split16``), summed in int64 in one pass, and reduced
once (``fp.reduce_sum_mont``).  The canonical result is the same element.
"""

from __future__ import annotations

import torch

from octopuszk_tpu_torch.fields import fp
from octopuszk_tpu_torch.fields.spec import FieldSpec
from octopuszk_tpu_torch.ops import ntt

# Digits above the sixteen of an element that take the carries of the sum:
# with at most 2^31 terms a digit sum is below 2^47 and the whole sum below
# 2^288 = 2^(16 * (16 + CARRY_DIGITS)).
CARRY_DIGITS = 2
MAX_TERMS = 1 << 31


def wide_sum(spec: FieldSpec, terms, dim: int = -1):
    """Exact sum of Montgomery values int32[8, ...] along ``dim`` (a batch
    axis, not the word axis): canonical int32[8, ...] without that axis."""
    if dim % terms.dim() == 0:
        raise ValueError("dim 0 is the word axis")
    if terms.shape[dim] > MAX_TERMS:
        raise ValueError(f"at most 2^31 terms, got {terms.shape[dim]}")
    wide = fp.split16(terms).sum(dim=dim)            # int64[16, ...]
    pad = torch.zeros((CARRY_DIGITS,) + tuple(wide.shape[1:]),
                      dtype=wide.dtype, device=wide.device)
    return fp.reduce_sum_mont(spec, torch.cat([wide, pad]))


def evaluate_poly(spec: FieldSpec, coeffs, x):
    """p(x) for coeffs int32[8, n] and x int32[8] (both Montgomery).
    Returns int32[8]."""
    n = coeffs.shape[1]
    pw = ntt.powers(spec, x, n)
    return wide_sum(spec, fp.mont_mul(spec, coeffs, pw))
