"""BN254b, the second curve family (the reference's ``zksnark-large``), in
the PyTorch port against the JAX reference: the counterpart of
tests/test_bn254b.py, with its seeds.

The tower and the pairing (host python ints), the generators, the device
group law through the kernels' plain versions (add, double, mixed add, the
products by b3 = 39 and by the non-residue -5 inside them) word for word
against the reference's ``bn254b()`` groups, Fp2 with u^2 = -5, a small
MSM against host arithmetic, and one Groth16 run at
``serial_construct(13, 3, seed=41)`` (setup seed 42, prove seed 43) whose
CRS and proof equal the reference's.  Tolerance: exact."""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from octopuszk_tpu.curves.family import bn254b as rbn254b
from octopuszk_tpu.fields import fp2 as rfp2
from octopuszk_tpu.models.groth16 import (
    prover as rprover, setup as rsetup, verifier as rverifier)
from octopuszk_tpu.relations import construct as rconstruct
from octopuszk_tpu.utils.bigint import ints_to_limbs

from octopuszk_tpu_torch import convert
from octopuszk_tpu_torch.curves import family, group_ops as jac
from octopuszk_tpu_torch.fields import fp2
from octopuszk_tpu_torch.models.groth16 import prover, setup, verifier
from octopuszk_tpu_torch.models.groth16.objects import Proof
from octopuszk_tpu_torch.ops import kernels, msm
from octopuszk_tpu_torch.relations import construct
from octopuszk_tpu_torch.utils.bigint import ints_to_words, words_to_ints

# The port's CPU path is many small tensor ops.  Several test processes
# share the cores, and torch's intra-op thread pools would oversubscribe
# them (each op many times slower), so each process keeps one thread.
torch.set_num_threads(1)

QUERIES = ("query_a", "query_b_g1", "query_b_g2", "query_h", "delta_abc_g1")


@pytest.fixture(scope="module")
def cv():
    return family.bn254b()


@pytest.fixture(scope="module")
def rcv():
    return rbn254b()


def test_params_equal_reference(cv, rcv):
    assert (cv.fr.p, cv.fq.p, cv.fr.root_of_unity, cv.fq.root_of_unity) == (
        rcv.fr.p, rcv.fq.p, rcv.fr.root_of_unity, rcv.fq.root_of_unity)
    assert cv.params.b == 13 and cv.params.fq2_nr == -5
    assert cv.params.xi == rcv.params.xi == (3, 1)
    assert (cv.params.g1_gen, cv.params.g2_gen, cv.params.ate_loop_count) == (
        rcv.params.g1_gen, rcv.params.g2_gen, rcv.params.ate_loop_count)
    assert cv.g1.name == "bn254b-G1" and cv.g2.name == "bn254b-G2"
    assert (cv.nr, cv.b3) == (-5, 39)
    # the kernels' header carries these constants
    text = kernels.constants_header()
    assert "#define FQB_NR (-5)" in text and "#define FQB_G1_B3 39u" in text


def test_tower_axioms(cv, rcv):
    """tests/test_bn254b.py's axioms, and the same products, inverses,
    Frobenius maps and hard exponentiation as the reference's tower."""
    tw, rtw = cv.tower, rcv.tower
    r = random.Random(7)
    p = cv.fq.p

    def rand_fp6():
        return tuple((r.randrange(p), r.randrange(p)) for _ in range(3))

    for _ in range(5):
        a12 = (rand_fp6(), rand_fp6())
        b12 = (rand_fp6(), rand_fp6())
        assert tw.fp12_mul(a12, b12) == tw.fp12_mul(b12, a12)
        assert tw.fp12_mul(a12, b12) == rtw.fp12_mul(a12, b12)
        ainv = tw.fp12_inv(a12)
        assert ainv == rtw.fp12_inv(a12)
        assert tw.fp12_mul(a12, ainv) == tw.FP12_ONE
        assert tw.frobenius(a12, 1) == rtw.frobenius(a12, 1)
        x = (r.randrange(p), r.randrange(p))
        assert tw.fp2_mul(x, tw.fp2_inv(x)) == tw.FP2_ONE
    assert tw.final_exp_hard(a12, cv.fr.p) == rtw.final_exp_hard(a12, cv.fr.p)


def test_generators_on_curve(cv):
    assert cv.g1.host.is_on_curve(cv.params.g1_gen)
    assert cv.g2.host.is_on_curve(cv.params.g2_gen)
    # the subgroup order r kills both generators
    assert cv.g1.host.mul(cv.params.g1_gen, cv.fr.p) is None
    assert cv.g2.host.mul(cv.params.g2_gen, cv.fr.p) is None


def _same_point(ref, got):
    for r, g in zip(jac.flatten_coords(ref), jac.flatten_coords(got)):
        np.testing.assert_array_equal(np.asarray(r), convert.field_to_ref(g))


@pytest.mark.parametrize("which", ["g1", "g2"])
def test_device_group_law_matches_reference(cv, rcv, which):
    """Add (with the identity, equal and inverse pairs), double and mixed
    add through the kernels' plain versions: the reference's projective
    words, and the host's affine points.  The reference's group ops run
    with jit off: compiling them on XLA:CPU takes longer than running them
    op by op."""
    grp, rgrp = getattr(cv, which), getattr(rcv, which)
    r = random.Random(11)
    pts = [grp.host.mul(grp.generator_affine, r.randrange(1, cv.fr.p))
           for _ in range(4)] + [None]
    rot = pts[1:] + pts[:1]
    rot[2] = pts[2]                                   # P + P
    rot[3] = grp.host.neg(pts[3])                     # P - P
    dev, rdev = grp.points_to_device(pts, "cpu"), rgrp.points_to_device(pts)
    qdev, rqdev = grp.points_to_device(rot, "cpu"), rgrp.points_to_device(rot)
    with jax.disable_jit():
        want = (rgrp.add(rdev, rqdev), rgrp.double(rdev),
                rgrp.mixed_add(rdev, (rqdev[0], rqdev[1])))
    got = kernels.add_points_plain(grp.name, dev, qdev)
    _same_point(want[0], got)
    assert grp.points_to_host(got) == [grp.host.add(a, b)
                                       for a, b in zip(pts, rot)]
    _same_point(want[0], grp.add(dev, qdev))   # the group's entry point
    got = kernels.double_points_plain(grp.name, dev)
    _same_point(want[1], got)
    assert grp.points_to_host(got) == [grp.host.add(a, a) for a in pts]
    ops = kernels.plain_ops(grp.name)
    _same_point(want[2], jac.mixed_add(ops, dev, (qdev[0], qdev[1])))


def test_fp2_nonresidue_minus_5(cv):
    """fields/fp2.py with nr = -5 against the reference's Fp2."""
    rs = rbn254b().fq
    ts = cv.fq
    rng = random.Random(19)
    vals = [[0, 1, ts.p - 1] + [rng.randrange(ts.p) for _ in range(29)]
            for _ in range(4)]

    def both(v):
        return (jnp.asarray(ints_to_limbs(v, 16)),
                torch.from_numpy(ints_to_words(v).copy()))

    (ra0, ta0), (ra1, ta1), (rb0, tb0), (rb1, tb1) = map(both, vals)
    ra, ta, rb, tb = (ra0, ra1), (ta0, ta1), (rb0, rb1), (tb0, tb1)

    def same2(ref, got):
        for x, y in zip(ref, got):
            np.testing.assert_array_equal(np.asarray(x),
                                          convert.field_to_ref(y))

    same2(rfp2.mul(rs, ra, rb, -5), fp2.mul(ts, ta, tb, -5))
    same2(rfp2.sqr(rs, ra, -5), fp2.sqr(ts, ta, -5))
    same2(rfp2.inv(rs, ra, -5), fp2.inv(ts, ta, -5))
    same2(rfp2.batch_inv_rows(rs, ra, 8, nr=-5),
          fp2.batch_inv_rows(ts, ta, 8, nr=-5))
    # against the tower's python ints (the words are Montgomery forms)
    raw = [[ts.from_mont(v) for v in x] for x in vals]
    got = list(zip(*[[ts.from_mont(v) for v in words_to_ints(c.numpy())]
                     for c in fp2.mul(ts, ta, tb, -5)]))
    assert got == [cv.tower.fp2_mul((a0, a1), (b0, b1))
                   for a0, a1, b0, b1 in zip(*raw)]


def test_pairing_bilinearity(cv, rcv):
    r = random.Random(13)
    a = r.randrange(2, 1 << 64)
    b = r.randrange(2, 1 << 64)
    P = cv.params.g1_gen
    Q = cv.params.g2_gen
    e = cv.pairing.reduced_pairing
    lhs = e(cv.g1.host.mul(P, a), cv.g2.host.mul(Q, b))
    ePQ = e(P, Q)
    assert ePQ == rcv.pairing.reduced_pairing(P, Q)
    assert lhs == cv.pairing.gt_exp(ePQ, a * b % cv.fr.p)
    assert lhs != cv.pairing.GT_ONE               # non-degenerate
    assert e(None, Q) == cv.pairing.GT_ONE


def test_msm_against_host(cv, monkeypatch):
    """A small G1 MSM through the Pippenger pipelines (packed and unpacked,
    the naive dispatch turned off) and through the naive one, against the
    host's naive sum."""
    r = random.Random(17)
    n = 8
    scalars = [r.randrange(cv.fr.p) for _ in range(n)]
    pts = [cv.g1.host.mul(cv.g1.generator_affine, r.randrange(1, cv.fr.p))
           for _ in range(n)]
    want = cv.g1.host.naive_msm(scalars, pts)
    sc = torch.from_numpy(ints_to_words(scalars).copy())
    dev = cv.g1.points_to_device(pts, "cpu")

    def host(p):
        return cv.g1.points_to_host(jac._map_coords(p, lambda c: c[..., None]))[0]

    assert host(msm.msm_naive(cv.g1, dev, sc)) == want
    monkeypatch.setattr(msm, "NAIVE_THRESHOLD", 0)
    assert host(msm.pippenger_msm(cv.g1, dev, sc)) == want
    assert host(msm.pippenger_msm_packed(
        cv.g1, msm.points_to_packed(cv.g1, dev), sc)) == want


# ---- Groth16 ----

@pytest.fixture(scope="module")
def reference(rcv):
    r1cs, primary, aux = rconstruct.serial_construct(13, 3, seed=41,
                                                     spec=rcv.fr)
    crs = rsetup.setup(r1cs, seed=42, curve=rcv)
    proof = rprover.prove(crs.proving_key, primary, aux, seed=43, curve=rcv)
    return crs, primary, aux, proof


@pytest.fixture(scope="module")
def ported(cv):
    r1cs, primary, aux = construct.serial_construct(13, 3, seed=41,
                                                    spec=cv.fr, device="cpu")
    crs = setup.setup(r1cs, seed=42, curve=cv)
    proof = prover.prove(crs.proving_key, primary, aux, seed=43, curve=cv)
    return crs, primary, aux, proof


def test_groth16_crs_equals_reference(cv, reference, ported):
    rcrs, rprimary, raux, _ = reference
    crs, primary, aux, _ = ported
    assert (primary, aux) == (rprimary, raux)
    want = convert.proving_key_from_ref(rcrs.proving_key, curve=cv,
                                        device="cpu")
    pk = crs.proving_key
    for q in QUERIES:
        assert torch.equal(getattr(pk, q), getattr(want, q)), q
    for f in ("alpha_g1", "beta_g1", "beta_g2", "delta_g1", "delta_g2"):
        assert getattr(pk, f) == getattr(want, f), f
    vk, rvk = crs.verification_key, convert.verification_key_from_ref(
        rcrs.verification_key)
    assert vk.alpha_beta_gt == rvk.alpha_beta_gt
    assert (vk.gamma_g2, vk.delta_g2) == (rvk.gamma_g2, rvk.delta_g2)
    assert vk.gamma_abc_g1 == rvk.gamma_abc_g1


def test_groth16_proof_equals_reference_and_verifies(cv, rcv, reference,
                                                    ported):
    rcrs, _, _, rproof = reference
    crs, primary, _, proof = ported
    assert (proof.a, proof.b, proof.c) == (rproof.a, rproof.b, rproof.c)
    assert verifier.verify(crs.verification_key, primary, proof, curve=cv)
    assert rverifier.verify(rcrs.verification_key, primary, rproof, curve=rcv)
    # a wrong primary input is rejected
    bad = [primary[0]] + [(x + 1) % cv.fr.p for x in primary[1:]]
    assert not verifier.verify(crs.verification_key, bad, proof, curve=cv)
    tampered = Proof(a=cv.g1.host.add(proof.a, cv.params.g1_gen), b=proof.b,
                     c=proof.c)
    assert not verifier.verify(crs.verification_key, primary, tampered,
                               curve=cv)
