"""BN254 G1/G2 device groups: projective word-tensor batches + host bridges.

``G1`` / ``G2`` bundle the complete-projective ops (curves/group_ops.py)
with conversions between host affine points (python ints, None = identity:
the format of curves/host_curve.py) and device batches.
"""

from __future__ import annotations

import torch

from octopuszk_tpu_torch.curves import host_curve, group_ops as jac
from octopuszk_tpu_torch.fields.spec import FQ
from octopuszk_tpu_torch.utils import device as _device
from octopuszk_tpu_torch.utils.bigint import ints_to_words, words_to_ints


class _Group:
    """One device group: ops adapter + host conversions."""

    def __init__(self, name, ops, gen_affine, coord_dim, host, fq=FQ):
        self.name = name
        self.ops = ops
        self.fq = fq
        self.generator_affine = gen_affine
        self.coord_dim = coord_dim  # 1 for Fp (G1), 2 for Fp2 (G2)
        self.host = host            # host_curve function namespace

    # -- device-side ops --

    def add(self, p, q):
        return jac.add(self.ops, p, q)

    def double(self, p):
        return jac.double(self.ops, p)

    def negate(self, p):
        return jac.negate(self.ops, p)

    def mixed_add(self, p, q_aff, q_inf=None):
        return jac.mixed_add(self.ops, p, q_aff, q_inf)

    def infinity(self, batch_shape=(), device=None):
        return jac.infinity(self.ops, batch_shape, device)

    def select(self, mask, p, q):
        return jac.select_point(self.ops, mask, p, q)

    def is_infinity(self, p):
        return jac.is_infinity(self.ops, p)

    def to_affine(self, p):
        return jac.to_affine(self.ops, p)

    def tree_reduce(self, p, n):
        assert jac.leaf(p).shape[-1] == n
        return jac.tree_reduce(self.ops, p, n)

    def scalar_mul(self, p, scalars_raw, num_bits=254):
        return jac.scalar_mul(self.ops, p, scalars_raw, num_bits)

    # -- host <-> device --

    def _coord_to_dev(self, comps, device):
        """list over components of list of ints -> coordinate."""
        tensors = tuple(
            torch.from_numpy(ints_to_words(
                [self.fq.to_mont(v) for v in comp]).copy()).to(device)
            for comp in comps)
        return tensors[0] if self.coord_dim == 1 else tensors

    def points_to_device(self, affine_points, device=None):
        """List of host affine points (None = identity) -> projective batch."""
        device = _device.resolve(device)
        pts = affine_points
        if self.coord_dim == 1:
            xs = [[p[0] if p else 0 for p in pts]]
            ys = [[p[1] if p else 1 for p in pts]]
            zs = [[0 if p is None else 1 for p in pts]]
        else:
            xs = [[p[0][c] if p else 0 for p in pts] for c in range(2)]
            ys = [[p[1][c] if p else (1 if c == 0 else 0) for p in pts]
                  for c in range(2)]
            zs = [[0 if p is None else 1 for p in pts], [0] * len(pts)]
        return (self._coord_to_dev(xs, device), self._coord_to_dev(ys, device),
                self._coord_to_dev(zs, device))

    def _coord_to_host(self, coord):
        if self.coord_dim == 1:
            return [self.fq.from_mont(v)
                    for v in words_to_ints(coord.cpu().numpy())]
        comps = [[self.fq.from_mont(v)
                  for v in words_to_ints(c.cpu().numpy())] for c in coord]
        return list(zip(*comps))

    def points_to_host(self, p):
        """Point batch [8, n] -> list of host affine points (None = identity)."""
        x, y, inf = jac.to_affine(self.ops, p)
        xs = self._coord_to_host(x)
        ys = self._coord_to_host(y)
        infs = inf.reshape(-1).tolist()
        return [None if i else (xv, yv) for xv, yv, i in zip(xs, ys, infs)]

    def point_to_device(self, affine_point, device=None):
        """Single host point -> batch-less (shape [8]) device point."""
        batch = self.points_to_device([affine_point], device)
        return jac._map_coords(batch, lambda c: c[..., 0])


class _HostG1:
    add = staticmethod(host_curve.g1_add)
    mul = staticmethod(host_curve.g1_mul)
    neg = staticmethod(host_curve.g1_neg)
    is_on_curve = staticmethod(host_curve.g1_is_on_curve)
    naive_msm = staticmethod(host_curve.naive_msm_g1)


class _HostG2:
    add = staticmethod(host_curve.g2_add)
    mul = staticmethod(host_curve.g2_mul)
    neg = staticmethod(host_curve.g2_neg)
    is_on_curve = staticmethod(host_curve.g2_is_on_curve)
    naive_msm = staticmethod(host_curve.naive_msm_g2)


G1 = _Group("G1", jac.make_fp_ops(FQ), host_curve.G1_GEN, 1, _HostG1)
G2 = _Group("G2", jac.make_fp2_ops(FQ), host_curve.G2_GEN, 2, _HostG2)
