"""A mesh of shards, one process: the devices, sharding and collectives.

Port of ``octopuszk_tpu/parallel/mesh.py``.  The reference runs one
program over a 1-D ``jax.sharding.Mesh`` and shards every field vector
and point batch on its batch (last) axis.  Here one process drives every
shard: a ``Mesh`` holds one ``torch.device`` per shard (a device may
repeat, so four shards may share one card), and a sharded vector, point
batch or packed base is the list of its per-shard tensors, shard i holding
the i-th contiguous block of the batch axis.  The three collectives the
reference's ``shard_map`` bodies use are plain functions over such lists:
``all_to_all``, ``all_gather`` and ``psum``.  A copy between devices is an
asynchronous ``.to(device, non_blocking=True)``; between shards of one
device it is no copy at all.

``make_mesh(ndev)`` puts shard i on card ``i % torch.cuda.device_count()``
and raises without a card; ``device="cpu"`` puts every shard on the CPU.
There is no fallback from the card to the CPU.
"""

from __future__ import annotations

import dataclasses

import torch

from octopuszk_tpu_torch.curves import group_ops as jac
from octopuszk_tpu_torch.utils import device as _device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One device per shard, in shard order."""

    devices: tuple

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(ndev: int, device=None) -> Mesh:
    """A mesh of ``ndev`` shards: shard i on card i % (the cards present)
    for ``device=None`` (raises if there is none), else every shard on
    ``device``."""
    if ndev < 1:
        raise ValueError(f"a mesh needs at least one shard, got {ndev}")
    if device is None:
        _device.resolve(None)
        cards = torch.cuda.device_count()
        return Mesh(tuple(torch.device("cuda", i % cards)
                          for i in range(ndev)))
    dev = _device.resolve(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return Mesh((dev,) * ndev)


def place(x, device):
    """``x`` on ``device``: asynchronous towards a card, a plain copy
    towards the host (whose reader does not wait for the card)."""
    device = torch.device(device)
    return x.to(device, non_blocking=device.type == "cuda")


def shard_vector(mesh: Mesh, x, axis: int = -1):
    """Split a tensor (``int32[8, n]`` words, or any tensor along ``axis``)
    into the mesh's equal contiguous blocks, one per shard's device."""
    d = mesh.size
    n = x.shape[axis]
    if n % d:
        raise ValueError(f"{n} entries do not split over {d} shards")
    return [place(c, dev).contiguous()
            for c, dev in zip(x.split(n // d, dim=axis), mesh.devices)]


def shard_point_batch(mesh: Mesh, p):
    """Split a projective point batch on its last axis, coordinate by
    coordinate: a list of per-shard point batches."""
    flat = jac.flatten_coords(p)
    cd = 1 if isinstance(p[0], torch.Tensor) else len(p[0])
    parts = [shard_vector(mesh, c) for c in flat]
    return [jac.rebuild_coords([cs[i] for cs in parts], cd)
            for i in range(mesh.size)]


def replicate_point(mesh: Mesh, p):
    """One copy of a point (batch) per shard, on the shard's device."""
    return [jac._map_coords(p, lambda c, dev=dev: place(c, dev))
            for dev in mesh.devices]


def unshard(xs, axis: int = -1, device=None):
    """The sharded tensor whole again, on ``device`` (default the first
    shard's)."""
    device = xs[0].device if device is None else device
    return torch.cat([place(x, device) for x in xs], dim=axis)


def all_to_all(xs, split_axis: int, concat_axis: int):
    """The reference's tiled ``all_to_all``: shard i cuts its tensor into
    d blocks along ``split_axis`` and sends block j to shard j, which
    concatenates the blocks it receives, in shard order, along
    ``concat_axis``."""
    d = len(xs)
    blocks = [x.chunk(d, dim=split_axis) for x in xs]
    return [torch.cat([place(blocks[i][j], xs[j].device) for i in range(d)],
                      dim=concat_axis) for j in range(d)]


def all_gather(xs, axis: int):
    """The reference's tiled ``all_gather``: every shard gets the shards'
    tensors concatenated along ``axis``, on its own device (shards on one
    device share one copy)."""
    whole = {}
    for x in xs:
        if x.device not in whole:
            whole[x.device] = unshard(xs, axis, x.device)
    return [whole[x.device] for x in xs]


def psum(xs):
    """The exact sum of the shards' integer tensors (``int64`` digit sums,
    as ``fp.split16`` gives them), on the first shard's device: the value
    every shard of the reference holds after its ``psum``."""
    dev = xs[0].device
    total = xs[0]
    for x in xs[1:]:
        total = total + place(x, dev)
    return total
