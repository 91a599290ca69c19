"""relations/apps.py of the PyTorch port against the JAX reference: the
same R1CS (carried across by ``convert``) and the same assignment for the
reference test's constructions and seeds, exact."""

import pytest
import torch

from octopuszk_tpu.relations import apps as rapps

from octopuszk_tpu_torch import convert
from octopuszk_tpu_torch.fields.spec import FR
from octopuszk_tpu_torch.models.groth16 import prover, setup, verifier
from octopuszk_tpu_torch.relations import apps
from octopuszk_tpu_torch.relations.r1cs import assignment_to_device, is_satisfied

# The port's CPU path is many small tensor ops.  Several test processes
# share the cores, and torch's intra-op thread pools would oversubscribe
# them (each op many times slower), so each process keeps one thread.
torch.set_num_threads(1)

CASES = {
    "matmul": ("matmul_construct", (2, 2, 2), 41),
    "regression": ("lr_construct", (4, 3), 42),
    "gaussian": ("gaussian_construct", (4, 2), 43),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_construct_equals_reference(case):
    fn, dims, seed = CASES[case]
    ref, rprimary, raux = getattr(rapps, fn)(*dims, seed=seed)
    mine, primary, aux = getattr(apps, fn)(*dims, seed=seed, device="cpu")
    assert (primary, aux) == (rprimary, raux)
    conv = convert.r1cs_from_ref(ref, "cpu")
    assert mine.is_valid()
    assert (conv.num_constraints, conv.num_inputs, conv.num_variables) == (
        mine.num_constraints, mine.num_inputs, mine.num_variables)
    for name in "abc":
        a, b = getattr(conv, name), getattr(mine, name)
        for f in ("row", "col", "val", "row_chunk", "row_chunk_seg",
                  "col_chunk", "col_chunk_seg"):
            assert torch.equal(getattr(a, f), getattr(b, f)), (name, f)
        assert (a.num_rows, a.num_cols) == (b.num_rows, b.num_cols)


@pytest.mark.parametrize("case", sorted(CASES))
def test_satisfied_and_tampered(case):
    fn, dims, seed = CASES[case]
    r1cs, primary, aux = getattr(apps, fn)(*dims, seed=seed, device="cpu")
    z = assignment_to_device(FR, primary + aux, "cpu")
    assert is_satisfied(FR, r1cs, z)
    bad = list(primary)
    bad[-1] = (bad[-1] + 1) % FR.p          # the last public input
    assert not is_satisfied(FR, r1cs, assignment_to_device(
        FR, bad + aux, "cpu"))


def test_matmul_groth16_end_to_end():
    r1cs, primary, aux = apps.matmul_construct(1, 1, 1, seed=41,
                                               device="cpu")
    crs = setup.setup(r1cs, seed=3)
    proof = prover.prove(crs.proving_key, primary, aux, seed=4)
    assert verifier.verify(crs.verification_key, primary, proof)
    bad = list(primary)
    bad[1] = (bad[1] + 1) % FR.p
    assert not verifier.verify(crs.verification_key, bad, proof)
