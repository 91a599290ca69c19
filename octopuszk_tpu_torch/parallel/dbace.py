"""Distributed BACE prover and verifier over a mesh.

Port of ``octopuszk_tpu/parallel/dbace.py``:

* each input column's size-K iNTT and its size-D NTT are
  ``parallel/dntt.py``'s (a K too small for the mesh, below d^2 or not a
  multiple of d, takes the serial iNTT);
* the evaluations stay sharded over the proof domain D, so every column is
  co-sharded and the circuit runs on each shard's D/d points with no
  communication;
* the proof is one more distributed iNTT, sharded over D;
* the verifier evaluates the proof and each column at a random point,
  each shard its block of powers, the canonical partial sums added exactly
  across the shards (``psum``) and reduced once.
"""

from __future__ import annotations

import random

import torch

from octopuszk_tpu_torch.fields import fp
from octopuszk_tpu_torch.fields.spec import FieldSpec
from octopuszk_tpu_torch.models.bace.circuit import Circuit
from octopuszk_tpu_torch.models.bace.prover import proof_size
from octopuszk_tpu_torch.ops import ntt, poly
from octopuszk_tpu_torch.parallel import dntt, mesh as pmesh


def _column_coeffs(mesh, spec: FieldSpec, cj):
    """A column's iNTT over its K entries: sharded over K where the mesh
    allows it (K >= d^2 and d | K; a list), else the serial transform (one
    tensor)."""
    K, d = cj.shape[1], mesh.size
    if K >= d * d and K % d == 0:
        return dntt.distributed_ntt(mesh, spec, pmesh.shard_vector(mesh, cj),
                                    inverse=True)
    return ntt.intt(spec, cj)


def distributed_compute_proof(mesh, spec: FieldSpec, circuit: Circuit,
                              inputs, num_inputs: int):
    """R(z)'s coefficients, sharded over D: a list of int32[8, D/d]
    (Montgomery).  ``inputs``: int32[8, K*S] Montgomery, element k*S + j =
    instance k's j-th input (the serial prover's layout)."""
    d = mesh.size
    K = num_inputs
    S = circuit.input_size
    D = proof_size(circuit, K)
    if D % d or D < d * d:
        raise ValueError(f"distributed BACE needs d^2 <= D and d | D "
                         f"(D={D}, d={d})")
    L = inputs.shape[0]
    cols = inputs.reshape(L, K, S)
    col_evals = []
    for j in range(S):
        coeff = _column_coeffs(mesh, spec, cols[:, :, j])
        if isinstance(coeff, list):
            coeff = pmesh.unshard(coeff)
        padded = torch.zeros((L, D), dtype=coeff.dtype, device=coeff.device)
        padded[:, :K] = coeff
        col_evals.append(dntt.distributed_ntt(
            mesh, spec, pmesh.shard_vector(mesh, padded)))
    # each shard evaluates the circuit on its own D/d points
    r = [circuit.compute(spec, torch.stack([ev[i] for ev in col_evals],
                                           dim=1))
         for i in range(d)]
    return dntt.distributed_ntt(mesh, spec, r, inverse=True)


def _eval_sharded(mesh, spec: FieldSpec, coeffs, rho: int):
    """p(rho) for sharded coefficients (a list of int32[8, n/d]): each
    shard sums its block against rho^(i n/d) rho^k, the shards' canonical
    sums are added exactly and reduced.  Returns int32[8] on the first
    shard's device."""
    parts = []
    for i, x in enumerate(coeffs):
        local = x.shape[1]
        rho_w = ntt._elem(spec, rho, x.device)
        offset = ntt._elem(spec, pow(rho, i * local, spec.p), x.device)
        pw = fp.mont_mul(spec, ntt.powers(spec, rho_w, local),
                         offset[:, None])
        parts.append(poly.wide_sum(spec, fp.mont_mul(spec, x, pw)))
    return fp.reduce_sum_mont(spec, pmesh.psum(
        [fp.split16(p) for p in parts]))


def distributed_verify_proof(mesh, spec: FieldSpec, circuit: Circuit,
                             proof, inputs, num_inputs: int,
                             seed: int = 0) -> bool:
    """Evaluate the sharded proof and every input column's LDE at a random
    point rho (drawn from ``random.Random(seed)`` as the serial verifier
    draws it), rerun the circuit on the S values and compare."""
    K = num_inputs
    S = circuit.input_size
    rho = random.Random(seed).randrange(spec.p)
    claimed = _eval_sharded(mesh, spec, proof, rho)
    dev = claimed.device
    cols = inputs.reshape(inputs.shape[0], K, S)
    col_vals = []
    for j in range(S):
        coeff = _column_coeffs(mesh, spec, cols[:, :, j])
        if isinstance(coeff, list):
            col_vals.append(_eval_sharded(mesh, spec, coeff, rho))
        else:
            col_vals.append(pmesh.place(poly.evaluate_poly(
                spec, coeff, ntt._elem(spec, rho, coeff.device)), dev))
    got = circuit.compute(spec, torch.stack(col_vals, dim=1)[:, :, None])
    return bool(fp.eq(claimed, got[:, 0]).all())


def distributed_get_result(mesh, spec: FieldSpec, circuit: Circuit, proof,
                           num_inputs: int):
    """Per-instance circuit outputs int32[8, K] from a sharded proof: one
    distributed NTT of the proof, then every (D/K)-th evaluation, on the
    first shard's device."""
    evals = pmesh.unshard(dntt.distributed_ntt(mesh, spec, proof))
    return evals[:, ::evals.shape[1] // num_inputs]
