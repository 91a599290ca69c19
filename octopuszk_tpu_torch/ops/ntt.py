"""Radix-2 NTT over the BN254 scalar field on word tensors.

Single-device evaluation-domain ops: a field vector is ``int32[8, n]``
Montgomery words (fields/fp.py).  A transform of n <= ``BLOCK_MAX`` is one
``ntt_block`` launch (ops/kernels.py: every stage in shared memory, natural
order in and out; forward DIF, inverse DIT).  A longer one is the Bailey
4-step over an [R, C] view: the column transforms with the twiddles
omega^(k1 j2) as their ``post`` table, then the row transforms, which read
the columns' output through a transposed view and write natural order, so
2^20 is two launches.  The coset powers ride the first launch as ``pre``,
the scale 1/n (or g^-i / n) the last one as ``post``.  The tables depend on
the field, the size, the direction and the device only, and are built on
first use (by ``powers``) and kept (``_TABLES``).
"""

from __future__ import annotations

import torch

from octopuszk_tpu_torch.fields import fp
from octopuszk_tpu_torch.fields.spec import FieldSpec
from octopuszk_tpu_torch.ops import kernels
from octopuszk_tpu_torch.utils.bigint import int_to_words


def _elem(spec: FieldSpec, x: int, device) -> torch.Tensor:
    """Host int -> one Montgomery element int32[8] on ``device``."""
    return torch.from_numpy(int_to_words(spec.to_mont(x % spec.p))).to(device)


def powers(spec: FieldSpec, base_mont, n: int):
    """[1, g, g^2, ..., g^(n-1)] as int32[8, n] Montgomery words.

    ``base_mont`` is a single element int32[8].  Built by log2(n) doubling
    steps: P_{2k} = [P_k, P_k * g^k].  Any n >= 1 is accepted."""
    assert n >= 1
    out = fp.constant(spec.one_mont_words, (1,), base_mont.device)
    cur = base_mont[:, None]  # invariant: cur == g^(current length of out)
    while out.shape[1] < n:
        out = torch.cat([out, fp.mont_mul(spec, out, cur)], dim=1)
        cur = fp.mont_mul(spec, cur, cur)
    return out[:, :n].contiguous()


def powers_batched(spec: FieldSpec, bases, n: int):
    """bases int32[8, B] -> int32[8, n, B] with out[:, i, b] = base_b^i."""
    assert n >= 1
    B = bases.shape[1]
    out = fp.constant(spec.one_mont_words, (1, B), bases.device)
    cur = bases
    while out.shape[1] < n:
        out = torch.cat([out, fp.mont_mul(spec, out, cur[:, None, :])], dim=1)
        cur = fp.mont_mul(spec, cur, cur)
    return out[:, :n].contiguous()


def _emul(spec: FieldSpec, a, b):
    """Elementwise Montgomery multiply; ``b`` broadcasts to ``a``."""
    return fp.mont_mul(spec, a, b)


def _omega(spec: FieldSpec, n: int, inverse: bool, device):
    w = spec.rou_of_order(n)
    if inverse:
        w = pow(w, -1, spec.p)
    return _elem(spec, w, device)


# sub-transforms of at most this length are one ntt_block launch (a longer
# transform is the 4-step over sub-transforms of at most this length)
BLOCK_MAX = kernels.NTT_BLOCK_MAX

# device tables by (kind, field, size, direction, device)
_TABLES: dict = {}


def _table(key, build):
    t = _TABLES.get(key)
    if t is None:
        t = _TABLES[key] = build()
    return t


def _stage_twiddles(spec: FieldSpec, n: int, inverse: bool, device):
    """omega^k, k < n/2, for omega (or omega^-1) of order n: int32[8, n/2]."""
    return _table(("stage", spec.name, n, inverse, device), lambda: powers(
        spec, _omega(spec, n, inverse, device), n // 2))


def _four_step_twiddles(spec: FieldSpec, R: int, C: int, inverse: bool,
                        device):
    """omega^(k1 j2) for omega of order R C: int32[8, R, C]."""
    def build():
        bases = powers(spec, _omega(spec, R * C, inverse, device), C)
        return powers_batched(spec, bases, R)
    return _table(("4-step", spec.name, R, C, inverse, device), build)


def _coset_table(spec: FieldSpec, n: int, inverse: bool, device):
    """g^i (forward) or g^-i / n (inverse, with the iNTT's scale), i < n:
    int32[8, n]."""
    def build():
        g = spec.generator if not inverse else pow(spec.generator, -1,
                                                   spec.p)
        t = powers(spec, _elem(spec, g, device), n)
        return _emul(spec, t, _scale(spec, n, device)) if inverse else t
    return _table(("coset", spec.name, n, inverse, device), build)


def _scale(spec: FieldSpec, n: int, device):
    """1/n as int32[8, 1]."""
    return _table(("scale", spec.name, n, device), lambda: _elem(
        spec, pow(n, -1, spec.p), device)[:, None])


def _as_view(table, a: int, b: int):
    """An int32[8, a b] table (or an int32[8, 1] constant) in natural order
    as int32[8, a, b, 1] (or [8, 1, 1, 1])."""
    if table is None:
        return None
    if table.shape[1] == 1:
        return table[:, :, None, None]
    return table.reshape(table.shape[0], a, b, 1)


def _transform(spec: FieldSpec, x, inverse: bool, pre=None, post=None):
    """post * T(pre * x) along axis 1 of int32[8, n, B] (any strides), T
    the unscaled transform by omega (inverse: omega^-1) of order n >= 2;
    ``pre`` / ``post``: int32[8, n] tables in natural order or int32[8, 1]
    constants, the same for every b.  Returns a contiguous int32[8, n, B]."""
    n = x.shape[1]
    if n <= BLOCK_MAX:
        return kernels.ntt_block(
            spec, x, _stage_twiddles(spec, n, inverse, x.device), not inverse,
            None if pre is None else pre[:, :, None],
            None if post is None else post[:, :, None])
    return _four_step(spec, x, inverse, pre, post)


def _four_step(spec: FieldSpec, x, inverse: bool, pre=None, post=None):
    """The Bailey 4-step of ``_transform`` over the view [R, C] of the
    n = R C positions (row-major; R = C or 2 C): x[j1 C + j2] -> column
    transforms of length R over j1, times omega^(k1 j2), row transforms of
    length C over j2; output position k1 + R k2.  A sub-transform longer
    than BLOCK_MAX is a 4-step of its own, with its tables applied apart."""
    W, n, B = x.shape
    dev = x.device
    logn = n.bit_length() - 1
    R, C = 1 << ((logn + 1) // 2), 1 << (logn // 2)
    tw4 = _four_step_twiddles(spec, R, C, inverse, dev)[..., None]
    x4 = x.reshape(W, R, C, B)
    pre4 = _as_view(pre, R, C)
    if R <= BLOCK_MAX:                                   # columns
        y = kernels.ntt_block(spec, x4, _stage_twiddles(spec, R, inverse, dev),
                              not inverse, pre4, tw4)
    else:
        if pre4 is not None:
            x4 = _emul(spec, x4, pre4)
        y = _transform(spec, x4.reshape(W, R, C * B), inverse)
        y = _emul(spec, y.reshape(W, R, C, B), tw4)
    rows = y.permute(0, 2, 1, 3)                         # [8, C, R, B] view
    post4 = _as_view(post, C, R)
    if C <= BLOCK_MAX:
        z = kernels.ntt_block(spec, rows, _stage_twiddles(spec, C, inverse,
                                                          dev),
                              not inverse, None, post4)
    else:
        z = _transform(spec, rows.reshape(W, C, R * B), inverse)
        if post4 is not None:
            z = _emul(spec, z.reshape(W, C, R, B), post4)
    return z.reshape(W, n, B)


def ntt(spec: FieldSpec, coeffs):
    """Coefficients -> evaluations on the size-n subgroup (natural order)."""
    n = coeffs.shape[1]
    if n == 1:
        return coeffs
    return _transform(spec, coeffs[:, :, None], False)[:, :, 0]


def intt(spec: FieldSpec, evals):
    """Evaluations -> coefficients (inverse NTT, natural order)."""
    n = evals.shape[1]
    if n == 1:
        return evals
    return _transform(spec, evals[:, :, None], True,
                      post=_scale(spec, n, evals.device))[:, :, 0]


def _ntt_4step(spec: FieldSpec, x, inverse: bool):
    """ntt / intt of int32[8, n], n >= 4, by the 4-step whatever its
    size."""
    post = _scale(spec, x.shape[1], x.device) if inverse else None
    return _four_step(spec, x[:, :, None], inverse, None, post)[:, :, 0]


def ntt_batched(spec: FieldSpec, x, inverse: bool = False):
    """Transform along axis 1 of int32[8, n, B] (B independent columns)."""
    n = x.shape[1]
    if n == 1:
        return x
    post = _scale(spec, n, x.device) if inverse else None
    return _transform(spec, x, inverse, post=post)


def multiply_by_coset(spec: FieldSpec, x, inverse: bool = False):
    """x[i] *= g^i (or g^-i)."""
    n = x.shape[1]
    g = spec.generator if not inverse else pow(spec.generator, -1, spec.p)
    return _emul(spec, x, powers(spec, _elem(spec, g, x.device), n))


def coset_ntt(spec: FieldSpec, coeffs):
    """Evaluate on the coset g*H: the transform of x[i] g^i."""
    n = coeffs.shape[1]
    pre = _coset_table(spec, n, False, coeffs.device)
    if n == 1:
        return _emul(spec, coeffs, pre)
    return _transform(spec, coeffs[:, :, None], False, pre=pre)[:, :, 0]


def coset_intt(spec: FieldSpec, evals):
    """Interpolate from the coset g*H: the inverse transform times
    g^-i / n."""
    n = evals.shape[1]
    post = _coset_table(spec, n, True, evals.device)
    if n == 1:
        return _emul(spec, evals, post)
    return _transform(spec, evals[:, :, None], True, post=post)[:, :, 0]


def lagrange_coeffs(spec: FieldSpec, n: int, t):
    """All n Lagrange basis polynomials of the domain evaluated at t.

    L_i(t) = (t^n - 1)/n * omega^i / (t - omega^i); if t lies in the domain
    the result is the indicator of that point.  ``t``: int32[8] Montgomery
    element.  Returns int32[8, n]."""
    dev = t.device
    w = powers(spec, _omega(spec, n, False, dev), n)            # omega^i
    t_col = t[:, None]
    diff = fp.sub(spec, t_col, w)                               # t - omega^i
    on_domain = fp.is_zero(diff)
    one = fp.constant(spec.one_mont_words, (1,), dev)
    if bool(on_domain.any()):
        return torch.where(on_domain, one, torch.zeros_like(one))
    inv_diff = fp.batch_inv_rows(spec, diff)                    # one launch
    tn = fp.pow_const(spec, t_col, n)                           # [8, 1]
    zt_over_n = fp.mont_mul(spec, fp.sub(spec, tn, one),
                            _elem(spec, pow(n, -1, spec.p), dev)[:, None])
    return fp.mont_mul(spec, fp.mont_mul(spec, w, inv_diff), zt_over_n)


def compute_z_at(spec: FieldSpec, n: int, t_int: int) -> int:
    """Z(t) = t^n - 1 as a host int."""
    return (pow(t_int, n, spec.p) - 1) % spec.p


def divide_by_z_on_coset(spec: FieldSpec, evals):
    """Divide coset evaluations by Z(g*omega^i) = g^n - 1 (constant)."""
    n = evals.shape[1]
    zinv = pow(compute_z_at(spec, n, spec.generator), -1, spec.p)
    return _emul(spec, evals, _elem(spec, zinv, evals.device)[:, None])
