"""Groth16 object model: CRS / proving key / verification key / proof.

Big query vectors are tensors: packed affine rows (ops/msm.py: one point
per row) or unpacked projective point batches; O(1) elements (alpha, beta,
delta, the GT pairing value, proof points) are host affine points.
"""

from __future__ import annotations

import dataclasses
from typing import Any


@dataclasses.dataclass(frozen=True)
class ProvingKey:
    """The queries and their layout.

    ``packed=True`` (what ``setup`` makes): every query is a packed affine
    tensor ``int32[n, 16 | 32]``, packed once at setup and reused across
    proofs.  They may lie in host memory (``serialize.load_crs(stream=True)``)
    and are then staged to the prover's device chunk by chunk.
    ``packed=False``: every query is
    a projective point batch (a tuple of three coordinates of ``int32[8, n]``
    components, Fp2 pairs for G2), proved by the sort-based
    ``msm.pippenger_msm``.

    ``delta_abc_full``: False = delta_abc_g1 holds the aux entries only
    (scalars z[ni:]); True = it holds all m variables with the primary
    prefix scaled differently (the reference's distributed setup), and the
    prover zeroes the primary scalars instead."""

    alpha_g1: Any            # host affine G1
    beta_g1: Any
    beta_g2: Any             # host affine G2
    delta_g1: Any
    delta_g2: Any
    delta_abc_g1: Any        # query over aux variables (scalars z[ni:])
    query_a: Any             # query over all variables
    query_b_g1: Any          # query over all variables (G1 copy)
    query_b_g2: Any          # query over all variables (G2)
    query_h: Any             # query over H coefficients [degree + 1]
    r1cs: Any
    packed: bool = True
    delta_abc_full: bool = False


@dataclasses.dataclass(frozen=True)
class VerificationKey:
    """All host-side (the verifier is O(1) pairings + a num_inputs-sized
    MSM)."""

    alpha_beta_gt: Any       # Fp12 element
    gamma_g2: Any            # host affine G2
    delta_g2: Any
    gamma_abc_g1: list       # host affine G1 list [num_inputs]


@dataclasses.dataclass(frozen=True)
class Proof:
    """(A in G1, B in G2, C in G1), host affine points."""

    a: Any
    b: Any
    c: Any


@dataclasses.dataclass(frozen=True)
class CRS:
    proving_key: ProvingKey
    verification_key: VerificationKey
