"""Radix-2 NTT over the BN254 scalar field on word tensors.

Single-device evaluation-domain ops: a field vector is ``int32[8, n]``
Montgomery words (fields/fp.py).  The forward transform is DIF and the
inverse DIT, so bit-reversed order is internal only.  Each stage pairs the
two halves of every block through strided views and hands them to the
``butterfly`` kernel (ops/kernels.py); the twiddles come from one
``omega^k`` table built by log2(n) doubling steps.  From ``FOUR_STEP_MIN``
up the transform is the Bailey 4-step over a [R, C] view, which keeps every
stage's blocks at most sqrt(n) long.
"""

from __future__ import annotations

import functools

import numpy as np
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


def _butterfly_loop(spec: FieldSpec, x, tw_table, dif: bool):
    """Run all log2(n) butterfly stages along axis 1 of ``x``: int32[8, n]
    or int32[8, n, B] (B independent trailing batches, the column
    transforms of the 4-step).

    Stage with half-block m: element i pairs with i ^ m; the one with bit m
    clear receives the sum, the other the difference; the twiddle of
    position j = i mod m is omega^(j * n / 2m).  DIF runs m = n/2 ... 1
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
        o0, o1 = kernels.butterfly(spec, v[:, :, 0], v[:, :, 1], w, dif)
        x = torch.stack([o0, o1], dim=2).reshape(x.shape)
    return x


def _emul(spec: FieldSpec, a, b):
    """Elementwise Montgomery multiply; ``b`` broadcasts to ``a``."""
    return fp.mont_mul(spec, a, b)


def _omega(spec: FieldSpec, n: int, inverse: bool, device):
    w = spec.rou_of_order(n)
    if inverse:
        w = pow(w, -1, spec.p)
    return _elem(spec, w, device)


# from this size up the transform is the 4-step (see module docstring)
FOUR_STEP_MIN = 1 << 18


def ntt(spec: FieldSpec, coeffs):
    """Coefficients -> evaluations on the size-n subgroup (natural order)."""
    n = coeffs.shape[1]
    if n == 1:
        return coeffs
    if n >= FOUR_STEP_MIN:
        return _ntt_4step(spec, coeffs, inverse=False)
    tw = powers(spec, _omega(spec, n, False, coeffs.device), n // 2)
    y = _butterfly_loop(spec, coeffs, tw, dif=True)
    return y[:, _bitrev_perm(n, coeffs.device)]


def intt(spec: FieldSpec, evals):
    """Evaluations -> coefficients (inverse NTT, natural order)."""
    n = evals.shape[1]
    if n == 1:
        return evals
    if n >= FOUR_STEP_MIN:
        return _ntt_4step(spec, evals, inverse=True)
    tw = powers(spec, _omega(spec, n, True, evals.device), n // 2)
    y = _butterfly_loop(spec, evals[:, _bitrev_perm(n, evals.device)], tw,
                        dif=False)
    return _emul(spec, y, _elem(spec, pow(n, -1, spec.p),
                                evals.device)[:, None])


def _ntt_4step(spec: FieldSpec, x, inverse: bool):
    """Serial Bailey 4-step: view [R, C] row-major, transform columns,
    twiddle by omega^(k1*j2), transform rows, transpose to natural order."""
    L, n = x.shape
    logn = n.bit_length() - 1
    R, C = 1 << ((logn + 1) // 2), 1 << (logn // 2)
    omega = spec.rou_of_order(n)
    if inverse:
        omega = pow(omega, -1, spec.p)
    xl = ntt_batched(spec, x.reshape(L, R, C), inverse=inverse)  # columns
    bases = powers(spec, _elem(spec, omega, x.device), C)     # omega^{j2}
    tw = powers_batched(spec, bases, R)                       # omega^{j2*k1}
    xl = _emul(spec, xl, tw)
    xl = ntt_batched(spec, xl.transpose(1, 2).contiguous(),
                     inverse=inverse)                         # rows: [L, C, R]
    return xl.reshape(L, n)


def ntt_batched(spec: FieldSpec, x, inverse: bool = False):
    """Transform along axis 1 of int32[8, n, B] (B independent columns)."""
    n = x.shape[1]
    if n == 1:
        return x
    tw = powers(spec, _omega(spec, n, inverse, x.device), n // 2)
    perm = _bitrev_perm(n, x.device)
    if inverse:
        y = _butterfly_loop(spec, x[:, perm], tw, dif=False)
        return _emul(spec, y, _elem(spec, pow(n, -1, spec.p),
                                    x.device)[:, None, None])
    return _butterfly_loop(spec, x, tw, dif=True)[:, perm]


@functools.cache
def _bitrev_perm(n: int, device) -> torch.Tensor:
    logn = n.bit_length() - 1
    idx = np.arange(n, dtype=np.int64)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(logn):
        rev |= ((idx >> b) & 1) << (logn - 1 - b)
    return torch.from_numpy(rev).to(device)


def multiply_by_coset(spec: FieldSpec, x, inverse: bool = False):
    """x[i] *= g^i (or g^-i)."""
    n = x.shape[1]
    g = spec.generator if not inverse else pow(spec.generator, -1, spec.p)
    return _emul(spec, x, powers(spec, _elem(spec, g, x.device), n))


def coset_ntt(spec: FieldSpec, coeffs):
    """Evaluate on the coset g*H."""
    return ntt(spec, multiply_by_coset(spec, coeffs))


def coset_intt(spec: FieldSpec, evals):
    """Interpolate from the coset g*H."""
    return multiply_by_coset(spec, intt(spec, evals), inverse=True)


def lagrange_coeffs(spec: FieldSpec, n: int, t):
    """All n Lagrange basis polynomials of the domain evaluated at t.

    L_i(t) = (t^n - 1)/n * omega^i / (t - omega^i); if t lies in the domain
    the result is the indicator of that point.  ``t``: int32[8] Montgomery
    element.  Returns int32[8, n]."""
    dev = t.device
    w = powers(spec, _omega(spec, n, False, dev), n)            # omega^i
    t_col = t[:, None]
    diff = fp.sub(spec, t_col.expand(w.shape), w)               # t - omega^i
    on_domain = fp.is_zero(diff)
    one = fp.constant(spec.one_mont_words, (n,), dev)
    if bool(on_domain.any()):
        return torch.where(on_domain, one, torch.zeros_like(one))
    inv_diff = fp.batch_inv(spec, diff)
    tn = fp.pow_const(spec, t_col, n)                           # [8, 1]
    zt_over_n = fp.mont_mul(spec, fp.sub(spec, tn, one[:, :1]),
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
