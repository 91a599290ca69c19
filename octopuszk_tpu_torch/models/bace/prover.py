"""BACE prover: Merlin-Arthur proof for batch circuit evaluation.

Port of ``octopuszk_tpu/models/bace/prover.py``: interpolate each input
column over the K instances (a size-K inverse NTT per column), extend it to
the proof domain D = nextpow2(total degree * K), evaluate the circuit at all
D points at once, and interpolate the result into the proof polynomial R(z).
The transforms run through the ``ntt_block`` kernel, the circuit's products
through ``mont_mul``.
"""

from __future__ import annotations

import torch

from octopuszk_tpu_torch.fields.spec import FieldSpec
from octopuszk_tpu_torch.models.bace.circuit import Circuit
from octopuszk_tpu_torch.ops import ntt


def proof_size(circuit: Circuit, num_inputs: int) -> int:
    d = circuit.total_degree() * num_inputs
    return 1 << max(0, (d - 1).bit_length())


def input_polynomials(spec: FieldSpec, circuit: Circuit, inputs,
                      num_inputs: int):
    """Column LDE coefficients int32[8, K, S] from interleaved inputs.

    ``inputs``: int32[8, K*S] Montgomery, element k*S + j = instance k's
    j-th input."""
    cols = inputs.reshape(inputs.shape[0], num_inputs, circuit.input_size)
    return ntt.ntt_batched(spec, cols, inverse=True)   # iNTT along K


def compute_proof(spec: FieldSpec, circuit: Circuit, inputs,
                  num_inputs: int):
    """Returns R(z)'s coefficients int32[8, D] (Montgomery)."""
    K = num_inputs
    D = proof_size(circuit, K)
    coeffs = input_polynomials(spec, circuit, inputs, K)    # [8, K, S]
    L, _, S = coeffs.shape
    padded = torch.zeros((L, D, S), dtype=coeffs.dtype, device=coeffs.device)
    padded[:, :K] = coeffs
    evals = ntt.ntt_batched(spec, padded)                   # [8, D, S]
    r = circuit.compute(spec, evals.transpose(1, 2))        # [8, D]
    return ntt.intt(spec, r.contiguous())
