"""R1CS -> QAP reduction: instance map (at t) and witness map.

The instance map accumulates At/Bt/Ct against the Lagrange coefficients
(transpose matvecs), adds the input-consistency rows and the powers of t.
The witness map is the prover's 7-NTT pipeline: evaluate A, B, C on the
domain -> iNTT -> coset NTT -> H = (A*B - C)/Z on the coset -> coset iNTT.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from octopuszk_tpu_torch.fields import fp
from octopuszk_tpu_torch.fields.spec import FieldSpec
from octopuszk_tpu_torch.ops import kernels, ntt
from octopuszk_tpu_torch.relations.r1cs import R1CS, matvec, rmatvec


def domain_size(r1cs: R1CS) -> int:
    n = r1cs.num_constraints + r1cs.num_inputs
    return 1 << (n - 1).bit_length()


@dataclasses.dataclass(frozen=True)
class QAPInstance:
    """QAP evaluated at t: At/Bt/Ct int32[8, m], Ht int32[8, n+1], all
    Montgomery form.  zt/t are host ints (O(1) secrets live on host)."""

    at: torch.Tensor
    bt: torch.Tensor
    ct: torch.Tensor
    ht: torch.Tensor
    zt: int
    t: int
    num_inputs: int
    num_variables: int
    degree: int


def qap_instance(spec: FieldSpec, r1cs: R1CS, t: int) -> QAPInstance:
    """Instance map at host secret t."""
    n = domain_size(r1cs)
    nc, ni, m = r1cs.num_constraints, r1cs.num_inputs, r1cs.num_variables
    t_mont = ntt._elem(spec, t, r1cs.a.val.device)
    lag = ntt.lagrange_coeffs(spec, n, t_mont)          # [8, n]
    w = lag[:, :nc]
    at = rmatvec(spec, r1cs.a, w)
    bt = rmatvec(spec, r1cs.b, w)
    ct = rmatvec(spec, r1cs.c, w)
    # input consistency: At_i += L_{nc+i}(t) for i < numInputs (the
    # reference adds a vector that is zero past ni: the same words)
    at[:, :ni] = fp.add(spec, at[:, :ni], lag[:, nc:nc + ni])
    ht = ntt.powers(spec, t_mont, n + 1)
    zt = ntt.compute_z_at(spec, n, t)
    return QAPInstance(at=at, bt=bt, ct=ct, ht=ht, zt=zt, t=t,
                       num_inputs=ni, num_variables=m, degree=n)


def qap_witness(spec: FieldSpec, r1cs: R1CS, n: int, z, stage_seconds=None):
    """Witness map: full assignment z (int32[8, m] Montgomery) -> H
    coefficients int32[8, n+1] Montgomery (degree <= n-2, top two zero).
    ``stage_seconds``, where given, receives the wall time of the three
    matvecs (``matvecs``), of their six transforms (``transforms``) and of
    H = (A*B - C) / Z on the coset with its coset iNTT (``h``)."""
    nc, ni = r1cs.num_constraints, r1cs.num_inputs
    t0 = time.perf_counter()

    def mark(label):
        nonlocal t0
        if stage_seconds is not None:
            if z.is_cuda:
                torch.cuda.synchronize(z.device)
            stage_seconds[label] = time.perf_counter() - t0
            t0 = time.perf_counter()

    def evals(mat, with_inputs):
        # evaluations on the domain: constraints, then (for A) the
        # input-consistency rows, then zero padding
        e = torch.zeros((z.shape[0], n), dtype=z.dtype, device=z.device)
        e[:, :nc] = matvec(spec, mat, z)
        if with_inputs:
            e[:, nc:nc + ni] = z[:, :ni]
        return e

    abc = [evals(r1cs.a, True), evals(r1cs.b, False), evals(r1cs.c, False)]
    mark("matvecs")
    # each evaluation vector is freed as soon as its iNTT has read it
    cosets = [ntt.coset_ntt(spec, ntt.intt(spec, abc.pop(0)))
              for _ in range(3)]
    mark("transforms")
    h_coset = kernels.mul_sub(spec, *cosets)
    del cosets
    h_coset = ntt.divide_by_z_on_coset(spec, h_coset)
    h = ntt.coset_intt(spec, h_coset)             # [8, n]
    mark("h")
    return torch.cat([h, torch.zeros_like(h[:, :1])], dim=1)
