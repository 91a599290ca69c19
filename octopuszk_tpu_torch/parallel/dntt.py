"""Distributed radix-2 NTT over a mesh (Bailey 4-step).

Port of ``octopuszk_tpu/parallel/dntt.py``.  The global vector [8, n] is
viewed as a row-major [R, C] matrix; shard i holds rows [i R/d, (i+1)
R/d).  A transform is three ``all_to_all``s around two batched
sub-transforms:

  rows -> column blocks (all_to_all) -> column transforms of length R ->
  twiddle omega^(j2 k1) -> rows (all_to_all) -> row transforms of length C
  -> the transpose [R, C] -> [C, R] (all_to_all), natural order out.

Every sub-transform is ``ops/ntt.py ntt_batched``, so ``ntt_block``
launches; the twiddles and the coset powers are products (``mont_mul``).
The shard's tables (its twiddle columns, its block of the coset powers)
depend on the field, the sizes, the shard, the direction and the device
only, and are kept in ``ops/ntt.py``'s table cache, as the serial
transform's are.  One shard is the serial transform.
"""

from __future__ import annotations

from octopuszk_tpu_torch.fields import fp
from octopuszk_tpu_torch.fields.spec import FieldSpec
from octopuszk_tpu_torch.ops import ntt
from octopuszk_tpu_torch.parallel import mesh as pmesh


def _split_rc(n: int, d: int) -> tuple[int, int]:
    """R x C = n with d | R, d | C, both powers of two, R ~ sqrt(n)."""
    logn = n.bit_length() - 1
    logd = d.bit_length() - 1
    if 1 << logn != n or 1 << logd != d:
        raise ValueError(f"power-of-two sizes required (n={n}, d={d})")
    if logn < 2 * logd:
        raise ValueError(f"distributed NTT needs n >= d^2 (n={n}, d={d})")
    logr = max(logd, min(logn - logd, (logn + 1) // 2))
    return 1 << logr, 1 << (logn - logr)


def _dev_scaled_powers(spec: FieldSpec, base: int, count: int, shard: int,
                       device):
    """The shard's block of a geometric sequence: base^(shard count + i),
    i < count, as int32[8, count] on ``device``."""
    local = ntt.powers(spec, ntt._elem(spec, base, device), count)
    offset = ntt._elem(spec, pow(base, shard * count, spec.p), device)
    return fp.mont_mul(spec, local, offset[:, None])


def _omega(spec: FieldSpec, n: int, inverse: bool) -> int:
    w = spec.rou_of_order(n)
    return pow(w, -1, spec.p) if inverse else w


def _twiddles(spec: FieldSpec, R: int, C: int, d: int, shard: int,
              inverse: bool, device):
    """omega^(j2 k1) for the shard's columns j2 = shard C/d + j and every
    row k1: int32[8, R, C/d]."""
    def build():
        bases = _dev_scaled_powers(spec, _omega(spec, R * C, inverse),
                                   C // d, shard, device)
        return ntt.powers_batched(spec, bases, R)
    return ntt._table(("dist-4-step", spec.name, R, C, d, shard, inverse,
                       device), build)


def _coset_powers(spec: FieldSpec, n: int, d: int, shard: int,
                  inverse: bool, device):
    """g^i (or g^-i) for the shard's positions i: int32[8, n/d]."""
    g = pow(spec.generator, -1, spec.p) if inverse else spec.generator
    return ntt._table(("dist-coset", spec.name, n, d, shard, inverse, device),
                      lambda: _dev_scaled_powers(spec, g, n // d, shard,
                                                 device))


def distributed_ntt(mesh, spec: FieldSpec, xs, inverse: bool = False,
                    coset: bool = False):
    """NTT / iNTT of a sharded vector (a list of int32[8, n/d], one per
    shard); the result is sharded the same way.  ``coset`` evaluates on
    (interpolates from) the coset g H."""
    d = mesh.size
    if d == 1:
        if coset:
            return [(ntt.coset_intt if inverse else ntt.coset_ntt)(spec,
                                                                   xs[0])]
        return [(ntt.intt if inverse else ntt.ntt)(spec, xs[0])]
    W, local = xs[0].shape
    n = local * d
    R, C = _split_rc(n, d)
    if coset and not inverse:
        xs = [fp.mont_mul(spec, x, _coset_powers(spec, n, d, i, False,
                                                 x.device))
              for i, x in enumerate(xs)]
    xs = [x.reshape(W, R // d, C) for x in xs]
    xs = pmesh.all_to_all(xs, split_axis=2, concat_axis=1)     # [8, R, C/d]
    xs = [fp.mont_mul(spec, ntt.ntt_batched(spec, x, inverse),
                      _twiddles(spec, R, C, d, i, inverse, x.device))
          for i, x in enumerate(xs)]
    xs = pmesh.all_to_all(xs, split_axis=1, concat_axis=2)     # [8, R/d, C]
    xs = [ntt.ntt_batched(spec, x.transpose(1, 2), inverse).transpose(1, 2)
          for x in xs]                                         # rows
    xs = pmesh.all_to_all(xs, split_axis=2, concat_axis=1)     # [8, R, C/d]
    xs = [x.transpose(1, 2).reshape(W, local) for x in xs]     # [8, C/d R]
    if coset and inverse:
        xs = [fp.mont_mul(spec, x, _coset_powers(spec, n, d, i, True,
                                                 x.device))
              for i, x in enumerate(xs)]
    return xs
