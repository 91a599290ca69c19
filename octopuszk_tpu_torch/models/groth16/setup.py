"""Groth16 trusted setup (CRS generation), single-device path.

Sample secrets; QAP instance at t; gammaABC / deltaABC scalar vectors;
encode every query with a fixed-base batch MSM on the device and pack it,
in chunks of 2^``msm.FIXED_CHUNK_LOG`` scalars; one alpha*beta pairing for
the verification key.  Randomness is ``random.Random(seed)`` on the host,
drawn in the JAX package's order, so the same seed gives the same CRS.
"""

from __future__ import annotations

import random
import time

import torch

from octopuszk_tpu_torch.fields import fp
from octopuszk_tpu_torch.models.groth16.objects import (
    CRS, ProvingKey, VerificationKey)
from octopuszk_tpu_torch.ops import msm, ntt
from octopuszk_tpu_torch.reductions.r1cs_to_qap import qap_instance
from octopuszk_tpu_torch.utils import device as _device


def _setup_scalars(spec, qap, bucket: int, beta, alpha, inv_gamma, inv_delta):
    """Query scalar vectors, padded to ``bucket`` (gammaABC's: its ni
    public entries only), as raw (non-Montgomery) words ready for digit
    extraction."""
    ni, m = qap.num_inputs, qap.num_variables
    dev = qap.at.device

    def pad2(x):
        pad = torch.zeros((x.shape[0], bucket - x.shape[1]), dtype=x.dtype,
                          device=dev)
        return torch.cat([x, pad], dim=1)

    cst = lambda x: ntt._elem(spec, x, dev)[:, None]
    at, bt, ct, ht = pad2(qap.at), pad2(qap.bt), pad2(qap.ct), pad2(qap.ht)
    # abc_i = beta*At_i + alpha*Bt_i + Ct_i
    abc = fp.add(spec, fp.add(spec, fp.mont_mul(spec, at, cst(beta)),
                              fp.mont_mul(spec, bt, cst(alpha))), ct)
    gamma_abc = fp.mont_mul(spec, abc[:, :ni], cst(inv_gamma))
    delta_abc = pad2(fp.mont_mul(spec, abc[:, ni:m], cst(inv_delta)))
    ht_scaled = fp.mont_mul(spec, ht, cst(qap.zt * inv_delta))
    raw = lambda x: fp.from_mont(spec, x)
    return raw(at), raw(bt), raw(gamma_abc), raw(delta_abc), raw(ht_scaled)


def setup(r1cs, seed: int = 1, curve=None, stage_seconds=None,
          stage_bytes=None) -> CRS:
    """Generate the CRS for an R1CS relation, on the device its tensors lie
    on.  ``stage_seconds``: an optional dict that receives the wall time of
    each stage (the device is synchronised at each mark).
    ``stage_bytes``: an optional dict that receives, at the same marks on a
    CUDA device, the bytes allocated and the running peak
    (``device.memory_mark``; the peak is not reset); it stays empty on the
    CPU."""
    if curve is None:
        from octopuszk_tpu_torch.curves.family import bn254a
        curve = bn254a()
    fr = curve.fr
    g1_grp, g2_grp = curve.g1, curve.g2
    dev = r1cs.a.val.device
    rng = random.Random(seed)
    t, alpha, beta, gamma, delta = (rng.randrange(1, fr.p) for _ in range(5))
    inv_gamma = pow(gamma, -1, fr.p)
    inv_delta = pow(delta, -1, fr.p)

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

    qap = qap_instance(fr, r1cs, t)
    mark("qap-instance")

    # pad every query-scalar vector to ONE common power-of-two bucket:
    # padded scalars are zero ([0]G = identity points), so MSM results are
    # unchanged while all queries share one shape
    bucket = 1 << max(1, (max(qap.num_variables, qap.ht.shape[1]) - 1)
                      .bit_length())

    # random group generators
    g1_gen = g1_grp.host.mul(g1_grp.generator_affine, rng.randrange(1, fr.p))
    g2_gen = g2_grp.host.mul(g2_grp.generator_affine, rng.randrange(1, fr.p))
    g1_dev = g1_grp.point_to_device(g1_gen, dev)
    g2_dev = g2_grp.point_to_device(g2_gen, dev)

    at_raw, bt_raw, gamma_raw, delta_raw, ht_raw = _setup_scalars(
        fr, qap, bucket, beta, alpha, inv_gamma, inv_delta)
    mark("scalars")

    # fixed-base batch MSMs for all queries, each packed chunk by chunk into
    # the at-rest affine row layout the prover's MSMs gather from
    pad_to = msm._msm_pad_to(g1_grp, bucket, None, 22)

    # one window table per base serves all its queries
    tables = {g.name: msm.fixed_base_table(g, gen, bucket)
              for g, gen in ((g1_grp, g1_dev), (g2_grp, g2_dev))}
    mark("window-tables")

    def enc(group, scalars, label):
        packed = msm.fixed_base_msm_packed(group, tables[group.name],
                                           scalars, pad_to)
        mark(label)
        return packed

    query_a = enc(g1_grp, at_raw, "enc-A(g1)")
    query_b_g1 = enc(g1_grp, bt_raw, "enc-B(g1)")
    query_b_g2 = enc(g2_grp, bt_raw, "enc-B(g2)")
    delta_abc_g1 = enc(g1_grp, delta_raw, "enc-deltaABC(g1)")
    query_h = enc(g1_grp, ht_raw, "enc-H(g1)")
    # only the ni primary entries are evaluated (the reference evaluates
    # the zero padding to the bucket too and keeps these)
    gamma_abc_host = g1_grp.points_to_host(msm.fixed_base_msm(
        g1_grp, g1_dev, gamma_raw, table=tables[g1_grp.name]))
    mark("enc-gammaABC(g1)")

    alpha_g1 = g1_grp.host.mul(g1_gen, alpha)
    beta_g1 = g1_grp.host.mul(g1_gen, beta)
    beta_g2 = g2_grp.host.mul(g2_gen, beta)
    delta_g1 = g1_grp.host.mul(g1_gen, delta)
    delta_g2 = g2_grp.host.mul(g2_gen, delta)
    gamma_g2 = g2_grp.host.mul(g2_gen, gamma)
    alpha_beta_gt = curve.pairing.reduced_pairing(alpha_g1, beta_g2)
    mark("host-points+pairing")

    pk = ProvingKey(
        alpha_g1=alpha_g1, beta_g1=beta_g1, beta_g2=beta_g2,
        delta_g1=delta_g1, delta_g2=delta_g2,
        delta_abc_g1=delta_abc_g1, query_a=query_a,
        query_b_g1=query_b_g1, query_b_g2=query_b_g2,
        query_h=query_h, r1cs=r1cs, packed=True)
    vk = VerificationKey(
        alpha_beta_gt=alpha_beta_gt, gamma_g2=gamma_g2, delta_g2=delta_g2,
        gamma_abc_g1=gamma_abc_host)
    return CRS(proving_key=pk, verification_key=vk)
