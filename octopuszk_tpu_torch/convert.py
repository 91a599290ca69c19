"""Carrying state between this package and the JAX reference.

The reference holds a field element as ``uint32[16, ...]`` 16-bit limbs and
this package as ``int32[8, ...]`` 32-bit words, both Montgomery with
R = 2**256, so a value converts by a repack with no arithmetic.  The
reference's packed CRS rows hold 4 G1 or 2 G2 points per 128-limb row; here
a row is one point (``int32[n, 16 | 32]``).  Each ``*_from_ref`` has a
``*_to_ref`` beside it that gives the reference's layout back as numpy
arrays (models/groth16/serialize.py writes the reference's file format
through them).

Everything here takes the reference's objects as numpy arrays and host
ints, or as objects whose array attributes ``np.asarray`` accepts; this
module imports neither JAX nor the JAX package.  With it a CRS made by the
reference's ``setup`` is proved here, and a CRS made here is compared with
the reference's.
"""

from __future__ import annotations

import dataclasses
import types

import numpy as np
import torch

from octopuszk_tpu_torch.models.groth16.objects import ProvingKey, VerificationKey
from octopuszk_tpu_torch.relations.r1cs import R1CS, SparseMatrix
from octopuszk_tpu_torch.utils import device as _device

REF_LIMBS = 16
REF_ROW = 128


def _limbs_to_words(limbs: np.ndarray, axis: int) -> np.ndarray:
    """Pair adjacent 16-bit limbs along ``axis`` into int32 word patterns."""
    limbs = np.moveaxis(np.asarray(limbs).astype(np.uint32), axis, -1)
    words = limbs[..., 0::2] | (limbs[..., 1::2] << np.uint32(16))
    return np.ascontiguousarray(np.moveaxis(words, -1, axis)).view(np.int32)


def _words_to_limbs(words: np.ndarray, axis: int) -> np.ndarray:
    words = np.moveaxis(
        np.ascontiguousarray(np.asarray(words)).view(np.uint32), axis, -1)
    limbs = np.stack([words & np.uint32(0xFFFF), words >> np.uint32(16)],
                     axis=-1).reshape(words.shape[:-1] + (-1,))
    return np.ascontiguousarray(np.moveaxis(limbs, -1, axis))


def field_from_ref(limbs, device=None) -> torch.Tensor:
    """uint32[16, ...] reference limbs -> int32[8, ...] words."""
    return torch.from_numpy(_limbs_to_words(limbs, 0)).to(
        _device.resolve(device))


def field_to_ref(words) -> np.ndarray:
    """int32[8, ...] words -> uint32[16, ...] reference limbs."""
    return _words_to_limbs(words.cpu().numpy(), 0)


def points_from_ref(point, device=None):
    """A reference point (tuple of coordinates, each a limb array or an
    Fp2 pair of them) -> the same structure of word tensors."""
    if isinstance(point, (tuple, list)):
        return tuple(points_from_ref(c, device) for c in point)
    return field_from_ref(point, device)


def points_to_ref(point):
    if isinstance(point, (tuple, list)):
        return tuple(points_to_ref(c) for c in point)
    return field_to_ref(point)


def packed_from_ref(packed, group, device=None) -> torch.Tensor:
    """Reference packed rows uint32[n / ppr, 128] -> int32[n, 16 | 32]."""
    c = 2 * group.coord_dim * REF_LIMBS        # limbs per point
    rows = np.asarray(packed).reshape(-1, c)
    return torch.from_numpy(_limbs_to_words(rows, 1)).to(
        _device.resolve(device))


def packed_to_ref(packed) -> np.ndarray:
    """int32[n, 16 | 32] -> reference packed rows uint32[n / ppr, 128]."""
    return _words_to_limbs(packed.cpu().numpy(), 1).reshape(-1, REF_ROW)


def sparse_from_ref(m, device=None) -> SparseMatrix:
    device = _device.resolve(device)
    idx = lambda a: torch.from_numpy(np.asarray(a).astype(np.int64)).to(device)
    return SparseMatrix(
        row=idx(m.row), col=idx(m.col), val=field_from_ref(m.val, device),
        row_chunk=idx(m.row_chunk), row_chunk_seg=idx(m.row_chunk_seg),
        col_chunk=idx(m.col_chunk), col_chunk_seg=idx(m.col_chunk_seg),
        num_rows=int(m.num_rows), num_cols=int(m.num_cols))


def sparse_to_ref(m: SparseMatrix) -> types.SimpleNamespace:
    """The reference's SparseMatrix fields as numpy arrays: int32 indices,
    uint32[16, nnz] limbs."""
    idx = lambda a: a.cpu().numpy().astype(np.int32)
    return types.SimpleNamespace(
        row=idx(m.row), col=idx(m.col), val=field_to_ref(m.val),
        row_chunk=idx(m.row_chunk), row_chunk_seg=idx(m.row_chunk_seg),
        col_chunk=idx(m.col_chunk), col_chunk_seg=idx(m.col_chunk_seg),
        num_rows=m.num_rows, num_cols=m.num_cols)


def r1cs_to_ref(r: R1CS) -> types.SimpleNamespace:
    return types.SimpleNamespace(
        a=sparse_to_ref(r.a), b=sparse_to_ref(r.b), c=sparse_to_ref(r.c),
        num_constraints=r.num_constraints, num_inputs=r.num_inputs,
        num_variables=r.num_variables)


def r1cs_from_ref(r, device=None) -> R1CS:
    return R1CS(
        a=sparse_from_ref(r.a, device), b=sparse_from_ref(r.b, device),
        c=sparse_from_ref(r.c, device),
        num_constraints=int(r.num_constraints), num_inputs=int(r.num_inputs),
        num_variables=int(r.num_variables))


QUERIES = ("delta_abc_g1", "query_a", "query_b_g1", "query_b_g2", "query_h")


def _query_group(name: str, curve):
    return curve.g2 if name == "query_b_g2" else curve.g1


def pinned(t: torch.Tensor) -> torch.Tensor:
    """A copy of ``t`` in page-locked host memory, the source of an
    asynchronous copy to the card.  Raises where the memory is not pinned
    (no quiet fall back to pageable memory)."""
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)
    if not host.is_pinned():
        raise RuntimeError(f"{t.nbytes} bytes of host memory not pinned")
    return host


def queries_to_host(pk: ProvingKey) -> ProvingKey:
    """``pk`` with its packed queries in host memory, as
    ``proving_key_from_ref(..., stream=True)`` leaves them: a query on the
    card is copied to pinned memory, one in host memory stays as it is.
    The prover then stages them to the R1CS's device chunk by chunk.  The
    card's copies are freed once the caller drops ``pk``."""
    if not pk.packed:
        raise ValueError("only packed queries are kept in host memory")

    def host(q):
        return pinned(q) if q.is_cuda else q

    return dataclasses.replace(
        pk, **{name: host(getattr(pk, name)) for name in QUERIES})


def proving_key_from_ref(pk, curve=None, device=None,
                         stream: bool = False) -> ProvingKey:
    """A reference proving key -> this package's: packed queries (128-limb
    rows) repack to one point per row, unpacked queries (point batches of
    limb arrays) to word tensors; ``delta_abc_full`` carries over.  The
    R1CS goes to ``device``; with ``stream`` the packed queries stay in host
    memory (pinned when ``device`` is the card), from where the prover
    stages them chunk by chunk."""
    if curve is None:
        from octopuszk_tpu_torch.curves.family import bn254a
        curve = bn254a()
    device = _device.resolve(device)
    packed = bool(pk.packed)
    streamed = bool(stream) and packed
    qdev = torch.device("cpu") if streamed else device

    def query(name):
        q = getattr(pk, name)
        if not packed:
            return points_from_ref(q, qdev)
        t = packed_from_ref(q, _query_group(name, curve), qdev)
        return pinned(t) if streamed and device.type == "cuda" else t

    return ProvingKey(
        alpha_g1=pk.alpha_g1, beta_g1=pk.beta_g1, beta_g2=pk.beta_g2,
        delta_g1=pk.delta_g1, delta_g2=pk.delta_g2,
        r1cs=r1cs_from_ref(pk.r1cs, device), packed=packed,
        delta_abc_full=bool(getattr(pk, "delta_abc_full", False)),
        **{name: query(name) for name in QUERIES})


def proving_key_to_ref(pk: ProvingKey) -> types.SimpleNamespace:
    """This package's proving key -> the reference's ProvingKey fields as
    numpy arrays (packed 128-limb rows or point batches of uint32[16, n]
    limbs, the R1CS as ``r1cs_to_ref``) and host values."""
    conv = packed_to_ref if pk.packed else points_to_ref
    return types.SimpleNamespace(
        alpha_g1=pk.alpha_g1, beta_g1=pk.beta_g1, beta_g2=pk.beta_g2,
        delta_g1=pk.delta_g1, delta_g2=pk.delta_g2,
        r1cs=r1cs_to_ref(pk.r1cs), packed=pk.packed,
        delta_abc_full=pk.delta_abc_full,
        **{name: conv(getattr(pk, name)) for name in QUERIES})


def verification_key_from_ref(vk) -> VerificationKey:
    """Host ints throughout: the fields carry over as they are."""
    return VerificationKey(
        alpha_beta_gt=vk.alpha_beta_gt, gamma_g2=vk.gamma_g2,
        delta_g2=vk.delta_g2, gamma_abc_g1=list(vk.gamma_abc_g1))
