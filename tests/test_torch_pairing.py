"""The BN254a pairing of the PyTorch port (curves/pairing.py over
fields/host_tower.py and fields/tower.py, python ints) against the JAX
reference's, the cases of tests/test_pairing.py: bilinearity, additivity,
non-degeneracy, the identity pairs, the generators' curve and subgroup
checks, the Frobenius tables and the final exponentiation's hard part;
every pairing value equal to the reference's.  Tolerance: exact."""

import random

import pytest

from octopuszk_tpu.curves import host_curve as rhc, pairing as rpairing

from octopuszk_tpu_torch.curves import host_curve as hc, pairing
from octopuszk_tpu_torch.fields import host_tower as tw
from octopuszk_tpu_torch.fields.spec import FQ, FR
from octopuszk_tpu_torch.fields.tower import HostTower


@pytest.fixture(scope="module")
def e_base():
    """e(G1, G2), the port's, equal to the reference's."""
    e = pairing.reduced_pairing(hc.G1_GEN, hc.G2_GEN)
    assert e == rpairing.reduced_pairing(rhc.G1_GEN, rhc.G2_GEN)
    return e


def test_bilinearity(rng, e_base):
    a = rng.randrange(1, FR.p)
    b = rng.randrange(1, FR.p)
    P, Q = hc.G1_GEN, hc.G2_GEN
    e_ab = pairing.reduced_pairing(hc.g1_mul(P, a), hc.g2_mul(Q, b))
    assert e_ab == pairing.gt_exp(e_base, a * b % FR.p)
    assert e_ab == pairing.reduced_pairing(hc.g1_mul(P, b), hc.g2_mul(Q, a))
    assert e_ab == rpairing.reduced_pairing(rhc.g1_mul(rhc.G1_GEN, a),
                                            rhc.g2_mul(rhc.G2_GEN, b))


def test_non_degenerate(e_base):
    assert e_base != tw.FP12_ONE
    assert pairing.gt_exp(e_base, 0) == tw.FP12_ONE
    assert pairing.gt_exp(e_base, FR.p) == tw.FP12_ONE


def test_identity_pairs():
    assert pairing.reduced_pairing(None, hc.G2_GEN) == tw.FP12_ONE
    assert pairing.reduced_pairing(hc.G1_GEN, None) == tw.FP12_ONE


def test_additivity(rng, e_base):
    a = rng.randrange(1, FR.p)
    b = rng.randrange(1, FR.p)
    P, Q = hc.G1_GEN, hc.G2_GEN
    lhs = pairing.reduced_pairing(hc.g1_mul(P, (a + b) % FR.p), Q)
    e_a = pairing.reduced_pairing(hc.g1_mul(P, a), Q)
    rhs = tw.fp12_mul(e_a, pairing.gt_exp(e_base, b))
    assert lhs == rhs
    assert e_a == pairing.gt_exp(e_base, a)


def test_generators_on_curve():
    assert (hc.G1_GEN, hc.G2_GEN) == (rhc.G1_GEN, rhc.G2_GEN)
    assert hc.g1_is_on_curve(hc.G1_GEN)
    assert hc.g2_is_on_curve(hc.G2_GEN)
    assert hc.g2_mul(hc.G2_GEN, FR.p) is None
    assert hc.g1_mul(hc.G1_GEN, FR.p) is None


def test_frobenius_tables_and_fast_final_exp():
    """The tower's Frobenius maps equal plain powers p^k, and the final
    exponentiation's hard part equals the plain power (p^4 - p^2 + 1) / r
    (the role of the reference's BNPairing.java:153-235)."""
    P = FQ.p
    T = HostTower(P, -1, tw.XI)
    r = random.Random(9)
    a = (tuple((r.randrange(P), r.randrange(P)) for _ in range(3)),
         tuple((r.randrange(P), r.randrange(P)) for _ in range(3)))
    for k in (1, 2, 3):
        assert T.frobenius(a, k) == tw.fp12_pow(a, P ** k)
    hard = (P ** 4 - P ** 2 + 1) // FR.p
    assert T.final_exp_hard(a, FR.p) == tw.fp12_pow(a, hard)
