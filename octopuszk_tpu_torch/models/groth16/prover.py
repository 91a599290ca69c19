"""Groth16 prover, single-device path.

QAP witness map (the 7-NTT pipeline), then variable-base MSMs over queryA /
queryB / queryH / deltaABC, then O(1) host group algebra assembling
(A, B, C).  The MSMs follow the key's layout: packed queries (queryB's G1
and G2 as one double MSM sharing digits and sort), on the device or
streamed there from host memory one chunk at a time, or unpacked point
batches (the sort-based Pippenger, one MSM per query).
Randomness is ``random.Random(seed)`` in the JAX package's order, so the
same seed and key give the same proof.
"""

from __future__ import annotations

import random
import time

import torch

from octopuszk_tpu_torch.curves import group_ops as jac
from octopuszk_tpu_torch.fields import fp
from octopuszk_tpu_torch.models.groth16.objects import Proof, ProvingKey
from octopuszk_tpu_torch.ops import msm
from octopuszk_tpu_torch.reductions.r1cs_to_qap import domain_size, qap_witness
from octopuszk_tpu_torch.relations.r1cs import assignment_to_device, is_satisfied
from octopuszk_tpu_torch.utils import device as _device


def _single_to_host(grp, p):
    return grp.points_to_host(jac._map_coords(p, lambda c: c[..., None]))[0]


def _queries(pk: ProvingKey):
    return (pk.query_a, pk.query_b_g1, pk.query_b_g2, pk.query_h,
            pk.delta_abc_g1)


def prove(pk: ProvingKey, primary, auxiliary, seed: int = 2,
          config=None, curve=None, stage_seconds=None,
          stage_bytes=None) -> Proof:
    """primary/auxiliary: host int assignments (primary[0] == 1).  Runs on
    the device the key's R1CS lies on.  Packed queries lie there or in host
    memory (``serialize.load_crs(stream=True)``), from where the MSMs stage
    them chunk by chunk; unpacked queries must lie there.
    ``config.debug`` turns on the satisfiability and degree checks;
    ``stage_seconds`` is an optional dict that receives each stage's wall
    time, and the witness map's split (``witness-map:matvecs``,
    ``:transforms``, ``:h``, parts of ``witness-map``); ``stage_bytes``,
    an optional dict, receives at the same marks on a CUDA device the bytes
    allocated and the running peak (``device.memory_mark``)."""
    if curve is None:
        from octopuszk_tpu_torch.curves.family import bn254a
        curve = bn254a()
    r1cs = pk.r1cs
    dev = r1cs.a.val.device
    if not pk.packed:
        where = {jac.leaf(q).device for q in _queries(pk)}
        if where != {dev}:
            raise ValueError(f"the queries lie on {sorted(map(str, where))}, "
                             f"the R1CS on {dev}")
    fr = curve.fr
    g1_grp, g2_grp = curve.g1, curve.g2
    rng = random.Random(seed)
    r = rng.randrange(fr.p)
    s = rng.randrange(fr.p)

    t0 = time.perf_counter()

    def mark(label):
        nonlocal t0
        if stage_seconds is not None:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            stage_seconds[label] = time.perf_counter() - t0
            t0 = time.perf_counter()
        if stage_bytes is not None and dev.type == "cuda":
            stage_bytes[label] = _device.memory_mark(dev)

    n = domain_size(r1cs)
    z = assignment_to_device(fr, list(primary) + list(auxiliary), dev)
    mark("assignment")
    if config is not None and config.debug:
        assert is_satisfied(fr, r1cs, z), "R1CS not satisfied"
    witness_split = {} if stage_seconds is not None else None
    h = qap_witness(fr, r1cs, n, z, stage_seconds=witness_split)
    if config is not None and config.debug:
        # deg H <= n - 2, so the top coefficients must be zero
        assert not bool(h[:, n - 1:].any()), "QAP H degree too high"

    z_raw = fp.from_mont(fr, z)
    h_raw = fp.from_mont(fr, h)
    del z, h                      # the MSMs read the raw words only
    ni = r1cs.num_inputs
    mark("witness-map")
    if stage_seconds is not None:
        # inside witness-map: matvecs, transforms, h
        stage_seconds.update({f"witness-map:{k}": v
                              for k, v in witness_split.items()})

    if pk.delta_abc_full:
        # all m variables: zero the primary scalars instead of slicing
        abc_scal = z_raw.clone()
        abc_scal[:, :ni] = 0
    else:
        abc_scal = z_raw[:, ni:].contiguous()

    if pk.packed:
        run_single = msm.pippenger_msm_packed

        def run_double(q1, q2, x):
            return msm.pippenger_double_msm_packed(g1_grp, g2_grp, q1, q2, x)
    else:
        run_single = msm.pippenger_msm

        def run_double(q1, q2, x):
            return run_single(g1_grp, q1, x), run_single(g2_grp, q2, x)

    eval_a = _single_to_host(g1_grp, run_single(g1_grp, pk.query_a, z_raw))
    mark("msm-A(g1)")
    b1, b2 = run_double(pk.query_b_g1, pk.query_b_g2, z_raw)
    eval_b1 = _single_to_host(g1_grp, b1)
    eval_b2 = _single_to_host(g2_grp, b2)
    mark("msm-B(g1+g2)")
    eval_h = _single_to_host(g1_grp, run_single(g1_grp, pk.query_h, h_raw))
    mark("msm-H(g1)")
    eval_abc = _single_to_host(
        g1_grp, run_single(g1_grp, pk.delta_abc_g1, abc_scal))
    mark("msm-deltaABC(g1)")

    g1, g2 = g1_grp.host, g2_grp.host

    # A = alpha + sum a_i A_i(t) + r*delta
    a_pt = g1.add(g1.add(pk.alpha_g1, eval_a), g1.mul(pk.delta_g1, r))
    # B = beta + sum a_i B_i(t) + s*delta  (G1 and G2 copies)
    b1_pt = g1.add(g1.add(pk.beta_g1, eval_b1), g1.mul(pk.delta_g1, s))
    b2_pt = g2.add(g2.add(pk.beta_g2, eval_b2), g2.mul(pk.delta_g2, s))
    # C = evalABC + evalH + s*A + r*B1 - rs*delta
    c_pt = g1.add(eval_abc, eval_h)
    c_pt = g1.add(c_pt, g1.mul(a_pt, s))
    c_pt = g1.add(c_pt, g1.mul(b1_pt, r))
    c_pt = g1.add(c_pt, g1.neg(g1.mul(pk.delta_g1, r * s % fr.p)))
    mark("host-assembly")
    return Proof(a=a_pt, b=b2_pt, c=c_pt)
