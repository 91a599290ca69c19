"""BACE verifier and result extraction.

Port of ``octopuszk_tpu/models/bace/verifier.py``: evaluate the proof
polynomial and every input column's LDE at a random point rho (drawn from
``random.Random(seed)`` as the reference draws it), run the circuit on
those values and compare; and read the per-instance outputs from the
proof's evaluations.
"""

from __future__ import annotations

import random

import torch

from octopuszk_tpu_torch.fields import fp
from octopuszk_tpu_torch.fields.spec import FieldSpec
from octopuszk_tpu_torch.models.bace.circuit import Circuit
from octopuszk_tpu_torch.models.bace.prover import input_polynomials
from octopuszk_tpu_torch.ops import ntt, poly
from octopuszk_tpu_torch.utils.bigint import int_to_words


def verify_proof(spec: FieldSpec, circuit: Circuit, proof, inputs,
                 num_inputs: int, seed: int = 0) -> bool:
    rng = random.Random(seed)
    rho = rng.randrange(spec.p)
    rho_w = torch.from_numpy(int_to_words(spec.to_mont(rho))).to(proof.device)
    claimed = poly.evaluate_poly(spec, proof, rho_w)
    coeffs = input_polynomials(spec, circuit, inputs, num_inputs)  # [8, K, S]
    pw = ntt.powers(spec, rho_w, num_inputs)                        # [8, K]
    terms = fp.mont_mul(spec, coeffs, pw[:, :, None])
    col_eval = poly.wide_sum(spec, terms, dim=1)                    # [8, S]
    got = circuit.compute(spec, col_eval[:, :, None])[:, 0]
    return bool(fp.eq(claimed, got).all())


def get_result(spec: FieldSpec, circuit: Circuit, proof, num_inputs: int):
    """Per-instance circuit outputs int32[8, K] from the proof."""
    step = proof.shape[1] // num_inputs
    return ntt.ntt(spec, proof)[:, ::step]
