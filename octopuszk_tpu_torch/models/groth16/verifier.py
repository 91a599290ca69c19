"""Groth16 verifier (host-side: 3 pairings + one tiny MSM): check
e(A, B) == e(alpha, beta) * e(evalABC, gamma) * e(C, delta) with
evalABC = sum primary_i * gammaABC_i."""

from __future__ import annotations

from octopuszk_tpu_torch.models.groth16.objects import Proof, VerificationKey
from octopuszk_tpu_torch.ops import msm


def verify(vk: VerificationKey, primary, proof: Proof, curve=None) -> bool:
    if curve is None:
        from octopuszk_tpu_torch.curves.family import bn254a
        curve = bn254a()
    if primary[0] != 1:
        raise ValueError("primary input must start with the constant one")
    pairing = curve.pairing
    ab = pairing.reduced_pairing(proof.a, proof.b)
    eval_abc = msm.pippenger_host(curve.g1, list(primary), vk.gamma_abc_g1,
                                  order=curve.fr.p)
    rhs = pairing.gt_mul(
        vk.alpha_beta_gt,
        pairing.gt_mul(pairing.reduced_pairing(eval_abc, vk.gamma_g2),
                       pairing.reduced_pairing(proof.c, vk.delta_g2)))
    return ab == rhs
