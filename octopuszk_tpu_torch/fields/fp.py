"""Vectorized 254-bit prime-field arithmetic on word tensors.

Representation (decided once, here)
-----------------------------------
A batch of field elements is ``torch.int32[8, ...]``: eight little-endian
32-bit words (axis 0; the int32 holds the bit pattern of an unsigned word),
arbitrary batch shape after that.  The word axis leads so that on the card
thread ``i`` reads word ``k`` at ``k * n + i``: neighbouring threads read
neighbouring addresses.

Elements are kept in **Montgomery form** (a*R mod p, R = 2**256) in
canonical range [0, p).  The JAX reference holds the same value as sixteen
16-bit limbs with the same R, so the two convert by a repack with no
arithmetic (``convert.field_from_ref`` / ``field_to_ref``), and every
function here returns canonical values: results compare bit for bit.

Multiplication goes through ``ops/kernels.py``: a CUDA kernel for a tensor
on the card, the plain 16-bit CIOS for a tensor on the CPU.  The other
operations are plain tensor code on both devices.  PyTorch on the CPU has
no shifts or compares for ``uint32``, so the plain code widens each word
into ``int64`` (so every shift of a word pattern is logical), and resolves
carries and borrows there.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from octopuszk_tpu_torch.fields.spec import FieldSpec, HALF_BITS, HALF_MASK
from octopuszk_tpu_torch.utils import device as _device
from octopuszk_tpu_torch.utils.bigint import NUM_WORDS, WORD_BITS

W = NUM_WORDS
M32 = (1 << WORD_BITS) - 1


# ---------------------------------------------------------------------------
# word <-> int64 views
# ---------------------------------------------------------------------------

def _u64(a: torch.Tensor) -> torch.Tensor:
    """int32 word patterns -> int64 values in [0, 2**32)."""
    return a.to(torch.int64) & M32


def _i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> int32 word patterns."""
    return (x - ((x >> 31) << 32)).to(torch.int32)


def split16(a: torch.Tensor) -> torch.Tensor:
    """int32[8, ...] words -> int64[16, ...] little-endian 16-bit limbs."""
    u = _u64(a)
    return torch.stack([u & HALF_MASK, u >> HALF_BITS], dim=1).reshape(
        (2 * W,) + tuple(a.shape[1:]))


def join16(limbs: torch.Tensor) -> torch.Tensor:
    """int64[16, ...] normalized 16-bit limbs -> int64[8, ...] words."""
    pairs = limbs.reshape((W, 2) + tuple(limbs.shape[1:]))
    return pairs[:, 0] | (pairs[:, 1] << HALF_BITS)


def _ripple(s: torch.Tensor, bits: int):
    """Carry-normalize non-negative int64 digit sums (any size) along axis
    0 to ``bits``-bit digits, digit by digit.  Returns (digits,
    carry_out)."""
    mask = (1 << bits) - 1
    rows = []
    c = torch.zeros_like(s[0])
    for k in range(s.shape[0]):
        r = s[k] + c
        c = r >> bits
        rows.append(r & mask)
    return torch.stack(rows), c


def _lookahead(g, p):
    """Carries of a digit chain from per-digit generate / propagate flags
    (bool[8, ...], never both set): pack the flags into one integer per
    element, G and P; adding G to G|P as binary numbers ripples exactly
    this chain, so the carry into digit k is bit k of (U + G) ^ U ^ G.
    Returns (carry_in int64[8, ...], carry_out)."""
    ks = torch.arange(W, device=g.device).reshape((W,) + (1,) * (g.dim() - 1))
    G = (g.to(torch.int64) << ks).sum(0)
    U = G | (p.to(torch.int64) << ks).sum(0)
    cin = (U + G) ^ U ^ G
    return (cin[None] >> ks) & 1, (cin >> W) & 1


def _resolve_add(s):
    """Word sums in [0, 2**33 - 2] -> (normalized words, carry_out)."""
    c, cout = _lookahead(s > M32, s == M32)
    return (s + c) & M32, cout


def _resolve_sub(d):
    """Word differences in (-2**32, 2**32) -> (normalized words of the
    value mod 2**256, borrow_out)."""
    b, bout = _lookahead(d < 0, d == 0)
    return (d - b) & M32, bout


@functools.cache
def _p_words(spec: FieldSpec, device, ndim: int) -> torch.Tensor:
    p = torch.from_numpy(spec.p_words.view(np.uint32).astype(np.int64))
    return p.to(device).reshape((W,) + (1,) * (ndim - 1))


def _p_col(spec: FieldSpec, ref: torch.Tensor) -> torch.Tensor:
    """Modulus words as int64[8, 1, ...] broadcasting against ref."""
    return _p_words(spec, ref.device, ref.dim())


def _cond_sub_p(spec: FieldSpec, t: torch.Tensor, extra_ge=None):
    """int64[8, ...] normalized words: subtract p where value >= p (or
    where ``extra_ge``, a carry above the top word, says so)."""
    d, borrow = _resolve_sub(t - _p_col(spec, t))
    ge = borrow == 0
    if extra_ge is not None:
        ge = ge | extra_ge
    return torch.where(ge, d, t)


# ---------------------------------------------------------------------------
# constructors
# ---------------------------------------------------------------------------

def zeros_like_batch(batch_shape, device=None) -> torch.Tensor:
    return torch.zeros((W,) + tuple(batch_shape), dtype=torch.int32,
                       device=_device.resolve(device))


def constant(spec_words: np.ndarray, batch_shape=(), device=None):
    """Broadcast a host word vector int32[8] to a [8, *batch] tensor."""
    c = torch.from_numpy(np.ascontiguousarray(spec_words, dtype=np.int32))
    c = c.to(_device.resolve(device))
    c = c.reshape((W,) + (1,) * len(batch_shape))
    return c.expand((W,) + tuple(batch_shape)).contiguous()


def broadcast_shape(*tensors):
    """Common broadcast shape of word tensors (fast when they agree)."""
    shape = tensors[0].shape
    if all(t.shape == shape for t in tensors):
        return shape
    return torch.broadcast_shapes(*[t.shape for t in tensors])


def _const_like(spec_words: np.ndarray, ref: torch.Tensor) -> torch.Tensor:
    return constant(spec_words, ref.shape[1:], ref.device)


# ---------------------------------------------------------------------------
# add / sub / neg
# ---------------------------------------------------------------------------

def add(spec: FieldSpec, a, b):
    """(a + b) mod p, canonical in/out."""
    s, _ = _resolve_add(_u64(a) + _u64(b))   # < 2p < 2**256: no carry out
    return _i32(_cond_sub_p(spec, s))


def sub(spec: FieldSpec, a, b):
    """(a - b) mod p, canonical in/out."""
    d, borrow = _resolve_sub(_u64(a) - _u64(b))
    e, _ = _resolve_add(d + _p_col(spec, d))
    return _i32(torch.where(borrow != 0, e, d))


def neg(spec: FieldSpec, a):
    """(-a) mod p."""
    ua = _u64(a)
    d, _ = _resolve_sub(_p_col(spec, ua) - ua)
    return _i32(torch.where(is_zero(a), torch.zeros_like(d), d))


def double(spec: FieldSpec, a):
    return add(spec, a, a)


def mul_small(spec: FieldSpec, a, k: int):
    """k * a for a small host-known integer k by a double-and-add chain."""
    if k == 0:
        return torch.zeros_like(a)
    neg_k = k < 0
    k = abs(k)
    acc = None
    run = a
    while k:
        if k & 1:
            acc = run if acc is None else add(spec, acc, run)
        k >>= 1
        if k:
            run = add(spec, run, run)
    return neg(spec, acc) if neg_k else acc


# ---------------------------------------------------------------------------
# Montgomery multiplication
# ---------------------------------------------------------------------------

def mont_mul(spec: FieldSpec, a, b):
    """(a * b * R^-1) mod p, canonical in/out; operands broadcast.  On the
    card this always launches the CUDA kernel (ops/kernels.py)."""
    from octopuszk_tpu_torch.ops import kernels
    return kernels.mont_mul(spec, a, b)


def mont_sqr(spec: FieldSpec, a):
    return mont_mul(spec, a, a)


def to_mont(spec: FieldSpec, x):
    """Raw residue -> Montgomery form."""
    return mont_mul(spec, x, _const_like(spec.r2_words, x))


def from_mont(spec: FieldSpec, a):
    """Montgomery form -> raw residue (multiply by 1)."""
    one = torch.zeros_like(a)
    one[0] = 1
    return mont_mul(spec, a, one)


# ---------------------------------------------------------------------------
# predicates / selects
# ---------------------------------------------------------------------------

def is_zero(a):
    return (a == 0).all(dim=0)


def eq(a, b):
    return (a == b).all(dim=0)


def select(mask, a, b):
    """mask ? a : b with mask shaped like the batch dims."""
    return torch.where(mask, a, b)


# ---------------------------------------------------------------------------
# inversion / exponentiation
# ---------------------------------------------------------------------------

def pow_const(spec: FieldSpec, a, e: int):
    """a**e for a host-known exponent (square-and-multiply, MSB first): one
    call of ops/kernels.py mont_pow, the whole chain in one launch on the
    card."""
    from octopuszk_tpu_torch.ops import kernels
    return kernels.mont_pow(spec, a, e)


def inv(spec: FieldSpec, a):
    """Elementwise inverse, inv(0) = 0: one call of ops/kernels.py inv (on
    the card one launch of the safegcd inversion; for a CPU tensor the
    reference's Fermat chain a^(p-2)).  The inverse is unique, so the words
    are the reference's."""
    from octopuszk_tpu_torch.ops import kernels
    return kernels.inv(spec, a)


def batch_inv(spec: FieldSpec, a):
    """Elementwise inverse along the last axis via Hillis-Steele prefix and
    suffix products and one inversion (``inv``).  Inputs must be nonzero.
    The port's callers take ``batch_inv_rows`` (one launch) instead."""
    n = a.shape[-1]
    one = _const_like(spec.one_mont_words, a)

    def scan_products(x, reverse):
        acc = x
        d = 1
        while d < n:
            if reverse:
                shifted = torch.cat([acc[..., d:], one[..., :d]], dim=-1)
            else:
                shifted = torch.cat([one[..., :d], acc[..., :n - d]], dim=-1)
            acc = mont_mul(spec, acc, shifted)
            d *= 2
        return acc

    incl = scan_products(a, reverse=False)
    sufx = scan_products(a, reverse=True)
    excl_pre = torch.cat([one[..., :1], incl[..., :n - 1]], dim=-1)
    excl_suf = torch.cat([sufx[..., 1:], one[..., :1]], dim=-1)
    inv_total = inv(spec, incl[..., n - 1:])
    out = mont_mul(spec, excl_pre, excl_suf)
    return mont_mul(spec, out, inv_total)


def batch_inv_rows(spec: FieldSpec, a, lanes: int | None = None):
    """Elementwise inverse of a flat [8, n] batch in O(n) multiplies.

    Two-level Montgomery trick: lane-parallel serial prefix products down
    ``rows = n/lanes`` steps, one inversion of each lane total (safegcd
    on the card, Fermat in the plain version), then a backward sweep
    emitting inverses.  Zero inputs map to
    zero (the identity-safe convention the affine conversion relies on).
    One call of ops/kernels.py batch_inv_rows (one launch on the card),
    which groups the work into its own ``INV_LANES`` lanes.  ``lanes`` is
    the reference's argument and is not used: the inverse is unique, so
    the lane count does not change the words.
    """
    from octopuszk_tpu_torch.ops import kernels
    return kernels.batch_inv_rows(spec, a)


# ---------------------------------------------------------------------------
# wide reduction (sums of many elements -> canonical)
# ---------------------------------------------------------------------------

def from_wide(spec: FieldSpec, wide, out_mont: bool):
    """Reduce int64[Wd, ...] (Wd >= 16 little-endian base-2**16 digits, each
    < 2**31, e.g. raw segment sums of 16-bit limbs) to a canonical element.

    Returns X mod p (out_mont=False) or (X * R) mod p (out_mont=True).
    A sum of Montgomery-form values is already Montgomery-scaled: reduce
    it with out_mont=False (see reduce_sum_mont).
    """
    wd = wide.shape[0]
    zrow = torch.zeros_like(wide[:1])
    s, _ = _ripple(torch.cat([wide, zrow]), HALF_BITS)
    w1 = wd + 1
    t = torch.cat([s, zrow])
    p16 = split16(torch.from_numpy(spec.p_words).to(wide.device)).reshape(
        (2 * W,) + (1,) * (wide.dim() - 1))
    k = max(w1 - 14, 0)
    for _ in range(k):                    # k REDC passes of 16 bits
        m = (t[0] * spec.n0inv16) & HALF_MASK
        t = torch.cat([t[:2 * W] + m * p16, t[2 * W:]])
        carry = t[0] >> HALF_BITS
        t = torch.cat([t[1:], zrow])
        t = torch.cat([(t[0] + carry)[None], t[1:]])
    s, _ = _ripple(t[:w1], HALF_BITS)
    res = _cond_sub_p(spec, join16(s[:2 * W]), extra_ge=s[2 * W] != 0)
    res = _i32(res)
    # correct the 2**(-16k) scale factor introduced by the REDC passes
    return mont_mul(spec, res, _const_like(
        spec.wide_fixup_words(k, out_mont), res))


def reduce_sum_mont(spec: FieldSpec, wide):
    """Canonicalize a wide digit sum of Montgomery-form values (X mod p):
    the exact-sum path of the sparse matvec segment sums."""
    return from_wide(spec, wide, out_mont=False)
