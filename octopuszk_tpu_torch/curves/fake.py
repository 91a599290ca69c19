"""Fake curves: field elements standing in for group elements.

Port of the reference's fake curve (algebra/curves/fake/{FakeG1, FakeG2,
FakeGT, FakeInitialize}.java in DIZK): test doubles in which the "group"
is the additive group of Fr (group add = field add, scalar mul = field
mul), so that the proof system's plumbing runs without curve arithmetic.
The device ops are Fr add / neg (plain tensor code) and ``fp.mont_mul``
(kernel b on the card); ``tree_reduce`` is ``ops/poly.py``'s exact wide
sum.
"""

from __future__ import annotations

import torch

from octopuszk_tpu_torch.fields import fp
from octopuszk_tpu_torch.fields.spec import FR
from octopuszk_tpu_torch.utils import device as _device
from octopuszk_tpu_torch.utils.bigint import int_to_words, ints_to_words, words_to_ints


class _FakeHost:
    """Host-side ops over python ints (None = identity = 0)."""

    @staticmethod
    def add(p, q):
        if p is None:
            return q
        if q is None:
            return p
        r = (p + q) % FR.p
        return r if r else None

    @staticmethod
    def mul(p, k):
        if p is None:
            return None
        r = p * k % FR.p
        return r if r else None

    @staticmethod
    def neg(p):
        return None if p is None else (-p) % FR.p

    @staticmethod
    def naive_msm(scalars, points):
        acc = 0
        for s, pt in zip(scalars, points):
            acc = (acc + s * (pt or 0)) % FR.p
        return acc if acc else None


class FakeGroup:
    """Device "group": one Fr word tensor per element.

    The API of curves/bn254._Group, so that MSM and Groth16 code can run on
    it; points are (value,) 1-tuples, of the same structure as a real
    curve's coordinates."""

    name = "Fake"
    coord_dim = 1
    host = _FakeHost
    generator_affine = 1

    def add(self, p, q):
        return (fp.add(FR, p[0], q[0]),)

    def double(self, p):
        return (fp.add(FR, p[0], p[0]),)

    def negate(self, p):
        return (fp.neg(FR, p[0]),)

    def infinity(self, batch_shape=(), device=None):
        return (fp.zeros_like_batch(batch_shape, _device.resolve(device)),)

    def is_infinity(self, p):
        return fp.is_zero(p[0])

    def select(self, mask, p, q):
        return (fp.select(mask, p[0], q[0]),)

    def scalar_mul(self, p, scalars_raw, num_bits=254):
        mont = fp.to_mont(FR, scalars_raw)
        return (fp.mont_mul(FR, p[0], mont),)

    def tree_reduce(self, p, n):
        from octopuszk_tpu_torch.ops import poly
        assert p[0].shape[-1] == n
        return (poly.wide_sum(FR, p[0]),)

    def points_to_device(self, values, device=None):
        words = ints_to_words([FR.to_mont(v or 0) for v in values])
        return (torch.from_numpy(words.copy()).to(_device.resolve(device)),)

    def points_to_host(self, p):
        vals = [FR.from_mont(v) for v in words_to_ints(p[0].cpu().numpy())]
        return [v if v else None for v in vals]

    def point_to_device(self, value, device=None):
        words = int_to_words(FR.to_mont(value or 0))
        return (torch.from_numpy(words.copy()).to(_device.resolve(device)),)


FAKE = FakeGroup()
