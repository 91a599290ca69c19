"""The reference's test fields SMALL (a 62-bit NTT prime) and LARGE (the
255-bit BLS12-381 scalar field) in the PyTorch port, against the JAX
reference: the constants of fields/spec.py; the cases of
tests/test_extra_fields.py (``test_generic_field_kernels`` for both fields,
``test_ntt_small_field``), each run through the port's plain versions on
the CPU and through the reference's functions (one jitted call per group)
on the same seeded inputs; the chains and transforms the card runs on
them against python ints; and ``kernels.constants_header``'s bound,
p < 2^255.  Tolerance: exact."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from octopuszk_tpu.fields import fp as rfp, spec as rspec
from octopuszk_tpu.ops import ntt as rntt

from octopuszk_tpu_torch import convert
from octopuszk_tpu_torch.fields import fp
from octopuszk_tpu_torch.fields.spec import LARGE, SMALL, FieldSpec
from octopuszk_tpu_torch.ops import kernels, ntt
from octopuszk_tpu_torch.utils.bigint import ints_to_words, words_to_ints

torch.set_num_threads(1)

SPECS = {"small": (SMALL, rspec.SMALL), "large": (LARGE, rspec.LARGE)}


def _mont(spec, xs):
    """Host ints -> Montgomery words int32[8, n] on the CPU."""
    return torch.from_numpy(ints_to_words([spec.to_mont(x) for x in xs]).copy())


def _plain(spec, words):
    """Montgomery words -> host ints."""
    return [spec.from_mont(v) for v in words_to_ints(words)]


def _values(spec, rng, n):
    """n random elements with 0, 1, p - 1 and p - 2 among them."""
    return [0, 1, spec.p - 1, spec.p - 2] + [rng.randrange(spec.p)
                                             for _ in range(n - 4)]


@pytest.mark.parametrize("field", sorted(SPECS))
def test_spec_equals_reference(field):
    mine, ref = SPECS[field]
    for k in ("name", "p", "generator", "two_adicity", "root_of_unity",
              "r_mod_p", "r2_mod_p"):
        assert getattr(mine, k) == getattr(ref, k), k
    assert mine.n0inv16 == ref.n0inv
    assert pow(mine.root_of_unity, 1 << mine.two_adicity, mine.p) == 1
    assert pow(mine.root_of_unity, 1 << (mine.two_adicity - 1), mine.p) != 1


@pytest.mark.parametrize("field", sorted(SPECS))
def test_generic_field_kernels(rng, field):
    """The reference's case (16 products of random elements) and the
    field's chains, on the port's plain versions and the reference's."""
    spec, ref = SPECS[field]
    xs = _values(spec, rng, 16)
    ys = [rng.randrange(spec.p) for _ in range(16)]
    a, b = _mont(spec, xs), _mont(spec, ys)
    got = fp.mont_mul(spec, a, b)
    assert _plain(spec, got) == [x * y % spec.p for x, y in zip(xs, ys)]

    def reference(ra, rb):
        return (rfp.mont_mul(ref, ra, rb), rfp.inv(ref, ra),
                rfp.batch_inv_rows(ref, ra, lanes=4))

    rprod, rinv, rbinv = jax.jit(reference)(
        jnp.asarray(convert.field_to_ref(a)),
        jnp.asarray(convert.field_to_ref(b)))
    inv = fp.inv(spec, a)
    binv = fp.batch_inv_rows(spec, a)
    for mine, theirs in ((got, rprod), (inv, rinv), (binv, rbinv)):
        np.testing.assert_array_equal(convert.field_to_ref(mine),
                                      np.asarray(theirs))
    assert _plain(spec, inv) == [pow(x, spec.p - 2, spec.p) for x in xs]
    assert _plain(spec, binv) == _plain(spec, inv)
    e = 0b1011001110001
    assert _plain(spec, fp.pow_const(spec, a, e)) == [
        pow(x, e, spec.p) for x in xs]
    cs = [rng.randrange(spec.p) for _ in range(16)]
    h = kernels.mul_sub(spec, a, b, _mont(spec, cs))
    assert _plain(spec, h) == [(x * y - c) % spec.p
                               for x, y, c in zip(xs, ys, cs)]
    assert _plain(spec, fp.add(spec, a, b)) == [
        (x + y) % spec.p for x, y in zip(xs, ys)]
    assert _plain(spec, fp.sub(spec, a, b)) == [
        (x - y) % spec.p for x, y in zip(xs, ys)]


def test_ntt_small_field(rng):
    """The reference's case: ntt -> intt at 16 over SMALL gives the input
    back; the forward transform's words equal the reference's."""
    n = 16
    xs = [rng.randrange(SMALL.p) for _ in range(n)]
    a = _mont(SMALL, xs)
    fwd = ntt.ntt(SMALL, a)
    back = ntt.intt(SMALL, fwd)
    assert _plain(SMALL, back) == xs

    def reference(ra):
        y = rntt.ntt(rspec.SMALL, ra)
        return y, rntt.intt(rspec.SMALL, y)

    ry, rback = jax.jit(reference)(jnp.asarray(convert.field_to_ref(a)))
    np.testing.assert_array_equal(convert.field_to_ref(fwd), np.asarray(ry))
    np.testing.assert_array_equal(convert.field_to_ref(back),
                                  np.asarray(rback))


@pytest.mark.parametrize("field", sorted(SPECS))
def test_transforms_against_python_ints(rng, field, monkeypatch):
    """ntt, intt, coset_ntt and coset_intt as the card routes them (the
    4-step over sub-transforms, the cap lowered to 8 so that n = 64 takes
    it), each evaluation equal to the polynomial's value at omega^k (on
    the coset: g omega^k)."""
    spec, _ = SPECS[field]
    monkeypatch.setattr(ntt, "BLOCK_MAX", 8)
    n = 64
    xs = _values(spec, rng, n)
    a = _mont(spec, xs)
    w = spec.rou_of_order(n)

    def evals(shift):
        return [sum(x * pow(shift * pow(w, k, spec.p), i, spec.p)
                    for i, x in enumerate(xs)) % spec.p for k in range(n)]

    y = ntt.ntt(spec, a)
    assert _plain(spec, y) == evals(1)
    assert _plain(spec, ntt.intt(spec, y)) == xs
    yc = ntt.coset_ntt(spec, a)
    assert _plain(spec, yc) == evals(spec.generator)
    assert _plain(spec, ntt.coset_intt(spec, yc)) == xs


def test_constants_header_bound(monkeypatch):
    """LARGE (p < 2^255) is written; a modulus of 2^255 or more raises."""
    header = kernels.constants_header()
    assert "#define LARGE_P_WORDS" in header and "#define SMALL_N0INV" in header
    assert LARGE.p < 1 << 255 < 2 * LARGE.p
    fields = kernels.LIBRARIES[kernels.TEST_FIELDS]
    for p in ((1 << 255) + 95, (1 << 256) - 189):
        wide = dataclasses.replace(LARGE, name="wide", p=p)
        monkeypatch.setitem(kernels.LIBRARIES, kernels.TEST_FIELDS,
                            fields._replace(specs=lambda: (SMALL, wide)))
        with pytest.raises(ValueError, match="2\\^255"):
            kernels.constants_header()
    below = FieldSpec(name="below", p=(1 << 255) - 19, generator=2,
                      two_adicity=2, root_of_unity=1)
    monkeypatch.setitem(kernels.LIBRARIES, kernels.TEST_FIELDS,
                        fields._replace(specs=lambda: (SMALL, below)))
    assert "#define LARGE_P_WORDS" in kernels.constants_header()
