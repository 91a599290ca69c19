"""ops/mxu_mont.py of the PyTorch port (the Montgomery product with its
reduction as Toeplitz matmuls) against the JAX reference's
octopuszk_tpu/ops/mxu_mont.py and the plain CIOS of kernel (b): the case
of tests/test_fields.py test_mont_mul_sos_mxu_matches_cios, BN254a Fr and
Fq, random operands with 0, 1 and p - 1 among them, on the CPU.
Tolerance: exact (the products are canonical words)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from octopuszk_tpu.fields.spec import FQ as RFQ, FR as RFR
from octopuszk_tpu.ops import mxu_mont as rmxu

from octopuszk_tpu_torch import convert
from octopuszk_tpu_torch.fields.spec import FQ, FR
from octopuszk_tpu_torch.ops import kernels, mxu_mont
from octopuszk_tpu_torch.utils.bigint import ints_to_words

torch.set_num_threads(1)

SPECS = {"fr": (FR, RFR), "fq": (FQ, RFQ)}


@pytest.mark.parametrize("field", sorted(SPECS))
def test_mont_mul_sos_mxu_matches_cios(rng, field):
    spec, rspec = SPECS[field]
    vals_a = [rng.randrange(spec.p) for _ in range(61)] + [0, 1, spec.p - 1]
    vals_b = [rng.randrange(spec.p) for _ in range(61)] + [spec.p - 1, 0, 1]
    a = torch.from_numpy(ints_to_words(vals_a).copy())
    b = torch.from_numpy(ints_to_words(vals_b).copy())
    got = mxu_mont.mont_mul_sos_mxu(spec, a, b)
    assert torch.equal(got, kernels.mont_mul_plain(spec, a, b))
    ref = jax.jit(lambda x, y: rmxu.mont_mul_sos_mxu(rspec, x, y))(
        jnp.asarray(convert.field_to_ref(a)),
        jnp.asarray(convert.field_to_ref(b)))
    np.testing.assert_array_equal(convert.field_to_ref(got), np.asarray(ref))


@pytest.mark.parametrize("field", sorted(SPECS))
def test_redc_mats_equal_reference(field):
    spec, rspec = SPECS[field]
    # the reference's cache may hold what a jitted call traced: build anew
    for mine, ref in zip(mxu_mont.redc_mats(spec, torch.device("cpu")),
                         rmxu._redc_mats.__wrapped__(rspec)):
        assert mine.dtype == torch.bfloat16
        np.testing.assert_array_equal(
            mine.float().numpy(), np.asarray(ref, dtype=np.float32))


def test_matmul_is_exact_at_the_limb_bounds():
    """The largest operands the product meets (every byte 255) give sums
    of 32 products of 255 x 255, exact in the float32 result."""
    mat = torch.full((64, 32), 255.0).to(torch.bfloat16)
    x8 = torch.full((32, 3), 255.0).to(torch.bfloat16)
    got = mxu_mont.matmul(mat, x8)
    assert got.dtype == torch.int64
    assert torch.equal(got, torch.full((64, 3), 32 * 255 * 255,
                                       dtype=torch.int64))
