"""CRS / proof serialization (save & load), in the JAX package's file format.

A CRS is one ``.npz``: the query tensors and the sparse R1CS arrays in the
reference's layout (packed queries as ``uint32[n / ppr, 128]`` rows of
16-bit limbs, 4 G1 or 2 G2 points per row; unpacked queries as
``uint32[16, n]`` limb arrays per coordinate component; R1CS indices int32,
values ``uint32[16, nnz]``), and the O(1) host values (affine points, the GT
element, sizes, layout flags) as JSON bytes under ``__meta__``.  The arrays
are converted through ``convert.py``, so a file written by either package
loads in the other.  Files are written uncompressed (``np.savez``); both
packages' loaders read compressed and uncompressed archives alike.

A proof is a JSON file of host affine points.
"""

from __future__ import annotations

import json
import types

import numpy as np

from octopuszk_tpu_torch import convert
from octopuszk_tpu_torch.models.groth16.objects import (
    CRS, Proof, VerificationKey)
from octopuszk_tpu_torch.utils import device as _device

_MATRIX_FIELDS = ("row", "col", "val", "row_chunk", "row_chunk_seg",
                  "col_chunk", "col_chunk_seg")
# file prefix of each unpacked query's arrays
_POINT_PREFIX = {"delta_abc_g1": "delta_abc", "query_a": "query_a",
                 "query_b_g1": "query_b_g1", "query_b_g2": "query_b_g2",
                 "query_h": "query_h"}


def _point_batch_to_np(p, prefix, out):
    for ci, coord in enumerate(p):
        if isinstance(coord, tuple):
            for cj, c in enumerate(coord):
                out[f"{prefix}_{ci}_{cj}"] = c
        else:
            out[f"{prefix}_{ci}"] = coord


def _point_batch_from_np(d, prefix, coord_dim):
    if coord_dim == 2:
        return tuple(tuple(d[f"{prefix}_{ci}_{cj}"] for cj in range(2))
                     for ci in range(3))
    return tuple(d[f"{prefix}_{ci}"] for ci in range(3))


def _matrix_to_np(m, prefix, out, meta):
    for name in _MATRIX_FIELDS:
        out[f"{prefix}_{name}"] = getattr(m, name)
    meta[prefix] = {"num_rows": m.num_rows, "num_cols": m.num_cols}


def _matrix_from_np(d, prefix, meta):
    return types.SimpleNamespace(
        **{name: d[f"{prefix}_{name}"] for name in _MATRIX_FIELDS},
        **meta[prefix])


def _host_to_json(x):
    """Host points / field values -> JSON-safe nested string structure."""
    if x is None:
        return None
    if isinstance(x, int):
        return str(x)
    if isinstance(x, (tuple, list)):
        return [_host_to_json(v) for v in x]
    raise TypeError(type(x))


def _host_from_json(x):
    if x is None:
        return None
    if isinstance(x, str):
        return int(x)
    if isinstance(x, list):
        return tuple(_host_from_json(v) for v in x)
    raise TypeError(type(x))


def save_crs(path: str, crs: CRS) -> None:
    """Write ``crs`` to ``path`` (``.npz`` is appended when missing).
    Host-resident queries are written like any other."""
    pk, vk = crs.proving_key, crs.verification_key
    ref = convert.proving_key_to_ref(pk)
    arrays = {}
    meta = {"host": {}, "packed": bool(pk.packed),
            "delta_abc_full": bool(pk.delta_abc_full)}
    for name in convert.QUERIES:
        if pk.packed:
            arrays[name] = getattr(ref, name)
        else:
            _point_batch_to_np(getattr(ref, name), _POINT_PREFIX[name], arrays)
    r = ref.r1cs
    for m in "abc":
        _matrix_to_np(getattr(r, m), "r" + m, arrays, meta)
    meta["r1cs"] = {"num_constraints": r.num_constraints,
                    "num_inputs": r.num_inputs,
                    "num_variables": r.num_variables}
    meta["host"] = {
        "alpha_g1": _host_to_json(pk.alpha_g1),
        "beta_g1": _host_to_json(pk.beta_g1),
        "beta_g2": _host_to_json(pk.beta_g2),
        "delta_g1": _host_to_json(pk.delta_g1),
        "delta_g2": _host_to_json(pk.delta_g2),
        "alpha_beta_gt": _host_to_json(vk.alpha_beta_gt),
        "gamma_g2": _host_to_json(vk.gamma_g2),
        "vk_delta_g2": _host_to_json(vk.delta_g2),
        "gamma_abc_g1": _host_to_json(vk.gamma_abc_g1),
    }
    arrays["__meta__"] = np.frombuffer(
        json.dumps(meta).encode(), dtype=np.uint8)
    np.savez(path, **arrays)


def load_crs(path: str, device=None, stream: bool = False) -> CRS:
    """Read a CRS written by either package.

    The R1CS and the queries go to ``device`` (None = the card).  With
    ``stream=True`` packed queries stay in host memory instead (pinned when
    ``device`` is the card): the prover then stages them to ``device``
    chunk by chunk.  This is the reference's
    ``load_crs(path, device=False)``; its ``device=True`` is
    ``stream=False`` here.  Unpacked queries always go to ``device``."""
    device = _device.resolve(device)
    with np.load(path if path.endswith(".npz") else path + ".npz") as d:
        meta = json.loads(bytes(d["__meta__"]).decode())
        h = {k: _host_from_json(v) for k, v in meta["host"].items()}
        r1cs = types.SimpleNamespace(
            **{m: _matrix_from_np(d, "r" + m, meta) for m in "abc"},
            **meta["r1cs"])
        packed = bool(meta.get("packed", False))
        if packed:
            queries = {name: d[name] for name in convert.QUERIES}
        else:
            queries = {name: _point_batch_from_np(
                d, _POINT_PREFIX[name], 2 if name == "query_b_g2" else 1)
                for name in convert.QUERIES}
    ref = types.SimpleNamespace(
        alpha_g1=h["alpha_g1"], beta_g1=h["beta_g1"], beta_g2=h["beta_g2"],
        delta_g1=h["delta_g1"], delta_g2=h["delta_g2"], r1cs=r1cs,
        packed=packed, delta_abc_full=bool(meta.get("delta_abc_full", False)),
        **queries)
    pk = convert.proving_key_from_ref(ref, device=device, stream=stream)
    vk = VerificationKey(
        alpha_beta_gt=h["alpha_beta_gt"], gamma_g2=h["gamma_g2"],
        delta_g2=h["vk_delta_g2"], gamma_abc_g1=list(h["gamma_abc_g1"]))
    return CRS(proving_key=pk, verification_key=vk)


def save_proof(path: str, proof: Proof) -> None:
    with open(path, "w") as f:
        json.dump({"a": _host_to_json(proof.a), "b": _host_to_json(proof.b),
                   "c": _host_to_json(proof.c)}, f)


def load_proof(path: str) -> Proof:
    with open(path) as f:
        d = json.load(f)
    return Proof(a=_host_from_json(d["a"]), b=_host_from_json(d["b"]),
                 c=_host_from_json(d["c"]))
