"""parallel/dgroth16.py of the PyTorch port against the JAX reference on
the CPU: the sharded R1CS, the witness map, the QAP instance, and the
slice as a whole, a distributed setup and prove at d = 2 beside the
reference's on ``serial_construct(13, 3, seed=21)`` (domain 16, the
smallest that four shards also take).  The same seeds give the same CRS,
query rows bit for bit, and the same proof."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from octopuszk_tpu.parallel import dgroth16 as rdgroth16, mesh as rpmesh
from octopuszk_tpu.relations import construct as rconstruct

from octopuszk_tpu_torch import convert
from octopuszk_tpu_torch.curves import bn254
from octopuszk_tpu_torch.fields.spec import FR
from octopuszk_tpu_torch.models.groth16 import verifier
from octopuszk_tpu_torch.ops import ntt
from octopuszk_tpu_torch.parallel import dgroth16, mesh as pmesh
from octopuszk_tpu_torch.reductions.r1cs_to_qap import (
    domain_size, qap_instance, qap_witness)
from octopuszk_tpu_torch.relations import construct
from octopuszk_tpu_torch.relations.r1cs import (
    assignment_to_device, is_satisfied)

# The port's CPU path is many small tensor ops.  Several test processes
# share the cores, and torch's intra-op thread pools would oversubscribe
# them (each op many times slower), so each process keeps one thread.
torch.set_num_threads(1)

CIRCUIT = dict(num_constraints=13, num_inputs=3, seed=21)
SETUP_SEED, PROVE_SEED = 22, 23
QUERIES = dgroth16.QUERIES


def _mesh(d):
    return pmesh.make_mesh(d, device="cpu")


@pytest.fixture(scope="module")
def reference():
    """The reference's distributed setup and prove at d = 2, its CRS
    gathered to numpy."""
    assert len(jax.devices()) == 8
    rmesh = rpmesh.make_mesh(jax.devices()[:2])
    r1cs, primary, aux = rconstruct.serial_construct(
        CIRCUIT["num_constraints"], CIRCUIT["num_inputs"],
        seed=CIRCUIT["seed"])
    crs = rdgroth16.distributed_setup(
        rmesh, rdgroth16.shard_r1cs(rmesh, r1cs), seed=SETUP_SEED)
    proof = rdgroth16.distributed_prove(rmesh, crs.proving_key, primary, aux,
                                        seed=PROVE_SEED)
    gathered = rdgroth16.gather_crs(rmesh, crs)
    pk = {q: np.asarray(getattr(gathered.proving_key, q)) for q in QUERIES}
    host = {f: getattr(crs.proving_key, f) for f in
            ("alpha_g1", "beta_g1", "beta_g2", "delta_g1", "delta_g2")}
    # the gathered key in the port's serial form
    ported = convert.proving_key_from_ref(gathered.proving_key, device="cpu")
    jax.clear_caches()
    return (pk, host, crs.verification_key, (proof.a, proof.b, proof.c),
            ported)


@pytest.fixture(scope="module")
def relation():
    return construct.serial_construct(
        CIRCUIT["num_constraints"], CIRCUIT["num_inputs"],
        seed=CIRCUIT["seed"], device="cpu")


@pytest.fixture(scope="module")
def dist2(relation):
    """The port's distributed setup and prove at d = 2."""
    r1cs, primary, aux = relation
    mesh = _mesh(2)
    setup_stages, prove_stages = {}, {}
    crs = dgroth16.distributed_setup(mesh, dgroth16.shard_r1cs(mesh, r1cs),
                                     seed=SETUP_SEED,
                                     stage_seconds=setup_stages)
    proof = dgroth16.distributed_prove(mesh, crs.proving_key, primary, aux,
                                       seed=PROVE_SEED,
                                       stage_seconds=prove_stages)
    assert "enc-B(g2)" in setup_stages and "msm-B(g1+g2)" in prove_stages
    return mesh, crs, proof


def test_distributed_proof_equals_reference(reference, dist2):
    want = reference[3]
    _, _, proof = dist2
    assert (proof.a, proof.b, proof.c) == want


def test_distributed_crs_equals_reference(reference, dist2):
    """Every query row bit for bit (the port's shards concatenated, the
    reference's gathered and repacked), the key's host points, the
    verification key."""
    rpk, rhost, rvk, _, _ = reference
    mesh, crs, _ = dist2
    pk = crs.proving_key
    for q in QUERIES:
        grp = bn254.G2 if q == "query_b_g2" else bn254.G1
        shards = getattr(pk, q)
        want = convert.packed_from_ref(rpk[q], grp, "cpu")
        assert torch.equal(torch.cat(shards), want), q
        assert [tuple(t.shape) for t in shards] == [
            (want.shape[0] // 2, want.shape[1])] * 2, q
    assert {f: getattr(pk, f) for f in rhost} == rhost
    assert pk.packed and pk.delta_abc_full
    vk = crs.verification_key
    want = convert.verification_key_from_ref(rvk)
    assert (vk.alpha_beta_gt, vk.gamma_g2, vk.delta_g2, vk.gamma_abc_g1) == (
        want.alpha_beta_gt, want.gamma_g2, want.delta_g2, want.gamma_abc_g1)


def test_distributed_proof_verifies(relation, dist2):
    _, primary, _ = relation
    _, crs, proof = dist2
    assert verifier.verify(crs.verification_key, primary, proof)
    bad = list(primary)
    bad[1] = (bad[1] + 1) % FR.p
    assert not verifier.verify(crs.verification_key, bad, proof)


def test_reference_crs_carries_over(reference, dist2):
    """The reference's distributed CRS, gathered and converted, is the
    port's gathered CRS: the same rows, the same R1CS terms (with the
    reference's zero-valued padding), the same layout flag; ``shard_crs``
    of it gives the port's own sharded rows back."""
    ported = reference[4]
    mesh, crs, _ = dist2
    mine = dgroth16.gather_crs(mesh, crs).proving_key
    assert ported.delta_abc_full and mine.delta_abc_full
    for q in QUERIES:
        assert torch.equal(getattr(ported, q), getattr(mine, q)), q
    for name in "abc":
        a, b = getattr(ported.r1cs, name), getattr(mine.r1cs, name)
        for f in ("row", "col", "val", "row_chunk", "row_chunk_seg",
                  "col_chunk", "col_chunk_seg"):
            assert torch.equal(getattr(a, f), getattr(b, f)), (name, f)
    resharded = dgroth16.shard_crs(mesh, dataclasses.replace(
        crs, proving_key=ported)).proving_key
    for q in QUERIES:
        for a, b in zip(getattr(resharded, q), getattr(crs.proving_key, q)):
            assert torch.equal(a, b), q


# ---------------------------------------------------------------------------
# the sharded relation and the witness map against the serial port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", [2, 4])
def test_shard_r1cs_splits_the_terms(relation, d):
    r1cs, _, _ = relation
    sr = dgroth16.shard_r1cs(_mesh(d), r1cs)
    for name in "abc":
        m, sm = getattr(r1cs, name), getattr(sr, name)
        nnz = m.nnz + (-m.nnz) % d
        assert [v.shape[1] for v in sm.val] == [nnz // d] * d
        assert torch.equal(torch.cat(sm.row)[:m.nnz], m.row)
        assert not torch.cat(sm.val, dim=1)[:, m.nnz:].any()   # zero pads
        assert sm.num_chunks == m.row_chunk_seg.shape[0]
    assert (sr.num_constraints, sr.num_inputs, sr.num_variables) == (
        r1cs.num_constraints, r1cs.num_inputs, r1cs.num_variables)


def _z(relation, d, corrupt=False):
    r1cs, primary, aux = relation
    full = list(primary) + list(aux)
    if corrupt:
        full[2] = (full[2] + 1) % FR.p
    m_pad = dgroth16.sharded_pad(len(full), d)
    return full, pmesh.shard_vector(_mesh(d), assignment_to_device(
        FR, full + [0] * (m_pad - len(full)), "cpu"))


@pytest.mark.parametrize("d", [1, 2, 4])
@pytest.mark.parametrize("corrupt", [False, True])
def test_distributed_is_satisfied(relation, d, corrupt):
    r1cs = relation[0]
    full, z = _z(relation, d, corrupt)
    got = dgroth16.distributed_is_satisfied(_mesh(d), FR,
                                            dgroth16.shard_r1cs(_mesh(d),
                                                                r1cs), z)
    assert got is (not corrupt)
    assert got == is_satisfied(FR, r1cs, assignment_to_device(FR, full,
                                                              "cpu"))


@pytest.mark.parametrize("d", [1, 2, 4])
def test_distributed_witness_equals_serial(relation, d):
    r1cs = relation[0]
    full, z = _z(relation, d)
    n = domain_size(r1cs)
    h = dgroth16.distributed_witness(_mesh(d), FR,
                                     dgroth16.shard_r1cs(_mesh(d), r1cs), n,
                                     z)
    assert [tuple(x.shape) for x in h] == [(8, n // d)] * d
    want = qap_witness(FR, r1cs, n, assignment_to_device(FR, full, "cpu"))
    assert torch.equal(pmesh.unshard(h), want[:, :n])


@pytest.mark.parametrize("d", [1, 2, 4])
def test_distributed_lagrange_equals_serial(d):
    n, t = 16, 12345678
    got = dgroth16.distributed_lagrange(_mesh(d), FR, n, t)
    assert torch.equal(pmesh.unshard(got), ntt.lagrange_coeffs(
        FR, n, ntt._elem(FR, t, "cpu")))
    with pytest.raises(ValueError, match="domain"):
        dgroth16.distributed_lagrange(_mesh(d), FR, n, FR.rou_of_order(n))


@pytest.mark.parametrize("d", [2, 4])
def test_distributed_qap_instance_equals_serial(relation, d):
    r1cs = relation[0]
    n, t = domain_size(r1cs), 987654321
    m = r1cs.num_variables
    at, bt, ct, ht, zt = dgroth16.distributed_qap_instance(
        _mesh(d), FR, dgroth16.shard_r1cs(_mesh(d), r1cs), t, n)
    want = qap_instance(FR, r1cs, t)
    for got, w in ((at, want.at), (bt, want.bt), (ct, want.ct)):
        whole = pmesh.unshard(got)
        assert whole.shape[1] == dgroth16.sharded_pad(m, d)
        assert torch.equal(whole[:, :m], w) and not whole[:, m:].any()
    h = pmesh.unshard(ht)
    assert h.shape[1] == dgroth16.sharded_pad(n + 1, d)
    assert torch.equal(h[:, :n + 1], want.ht)
    assert zt == want.zt


@pytest.mark.parametrize("x,d", [(1, 1), (5, 2), (13, 4), (17, 4),
                                 (100, 8)])
def test_sharded_pad_equals_reference(x, d):
    assert dgroth16.sharded_pad(x, d) == rdgroth16.sharded_pad(x, d)
