"""fields/host_ext.py and curves/fake.py of the PyTorch port against the JAX
reference: the cases of tests/test_extra_fields.py (Fp3 and Fp6 2-over-3
axioms, the complex DFT, the fake group's MSM), each run on both packages
with the same seeded inputs.  Tolerance: exact, but the complex DFT's
float round trip, held within 1e-9 as the reference holds it."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from octopuszk_tpu.curves import fake as rfake
from octopuszk_tpu.fields import host_ext as rhost_ext
from octopuszk_tpu.utils.bigint import ints_to_limbs

from octopuszk_tpu_torch import convert
from octopuszk_tpu_torch.curves import fake
from octopuszk_tpu_torch.fields import host_ext
from octopuszk_tpu_torch.fields.spec import FR
from octopuszk_tpu_torch.utils.bigint import ints_to_words

# The port's CPU path is many small tensor ops.  Several test processes
# share the cores, and torch's intra-op thread pools would oversubscribe
# them (each op many times slower), so each process keeps one thread.
torch.set_num_threads(1)


def test_fp3_axioms(rng):
    par = host_ext.Fp3Params(p=FR.p, non_residue=2)
    rpar = rhost_ext.Fp3Params(p=FR.p, non_residue=2)
    a = tuple(rng.randrange(FR.p) for _ in range(3))
    b = tuple(rng.randrange(FR.p) for _ in range(3))
    ab = host_ext.fp3_mul(par, a, b)
    assert ab == host_ext.fp3_mul(par, b, a) == rhost_ext.fp3_mul(rpar, a, b)
    ainv = host_ext.fp3_inv(par, a)
    assert ainv == rhost_ext.fp3_inv(rpar, a)
    assert host_ext.fp3_mul(par, a, ainv) == host_ext.fp3_one()


def test_fp6_2over3_axioms(rng):
    par = host_ext.Fp3Params(p=FR.p, non_residue=2)
    rpar = rhost_ext.Fp3Params(p=FR.p, non_residue=2)
    a = (tuple(rng.randrange(FR.p) for _ in range(3)),
         tuple(rng.randrange(FR.p) for _ in range(3)))
    ainv = host_ext.fp6_2over3_inv(par, a)
    assert ainv == rhost_ext.fp6_2over3_inv(rpar, a)
    assert host_ext.fp6_2over3_mul(par, a, ainv) == ((1, 0, 0), (0, 0, 0))


def test_complex_dft_roundtrip():
    xs = [(float(i), float(-i)) for i in range(8)]
    f = host_ext.naive_complex_dft(xs)
    assert f == rhost_ext.naive_complex_dft(xs)
    # inverse = conj -> dft -> conj / n
    back = host_ext.naive_complex_dft([(re, -im) for re, im in f])
    for (re, im), (xr, xi) in zip(
            [(r / 8, -i / 8) for r, i in back], xs):
        assert abs(re - xr) < 1e-9 and abs(im - xi) < 1e-9


def test_fake_group_msm(rng):
    """The fake group's MSM (Fr products and the wide sum) against the
    host's and, word for word, the reference's."""
    g, rg = fake.FAKE, rfake.FAKE
    n = 8
    ks = [rng.randrange(FR.p) for _ in range(n)]
    vals = [rng.randrange(FR.p) for _ in range(n)]
    pdev = g.points_to_device(vals, "cpu")
    sdev = torch.from_numpy(ints_to_words(ks).copy())
    prods = g.scalar_mul(pdev, sdev)
    total = g.tree_reduce(prods, n)
    got = g.points_to_host(tuple(c[..., None] for c in total))[0]
    assert got == g.host.naive_msm(ks, vals)
    rprods = rg.scalar_mul(rg.points_to_device(vals),
                           jnp.asarray(ints_to_limbs(ks, 16)))
    np.testing.assert_array_equal(np.asarray(rprods[0]),
                                  convert.field_to_ref(prods[0]))
    np.testing.assert_array_equal(np.asarray(rg.tree_reduce(rprods, n)[0]),
                                  convert.field_to_ref(total[0]))
    # the group ops on the identity
    zero = g.infinity((2,), "cpu")
    assert g.is_infinity(zero).all()
    assert g.points_to_host(g.add(pdev, g.negate(pdev))) == [None] * n
    assert g.points_to_host(g.double(pdev)) == [
        g.host.add(v, v) for v in vals]
