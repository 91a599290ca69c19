"""parallel/dgroth16.py of the PyTorch port against the port's serial
Groth16 on the CPU: a distributed setup and prove at d = 1, 2 and 4 from
the serial path's seeds gives the serial proof, and a CRS crosses between
the two forms: ``gather_crs`` -> ``save_crs`` -> ``load_crs`` -> the
serial prover, and ``shard_crs`` of the serial CRS -> the distributed
prover, give the same proof.  (The distributed proof at d = 2 equals the
JAX reference's in tests/test_torch_dgroth16.py.)"""

import dataclasses

import pytest
import torch

from octopuszk_tpu_torch.fields.spec import FR
from octopuszk_tpu_torch.models.groth16 import (
    prover, serialize, setup, verifier)
from octopuszk_tpu_torch.parallel import dgroth16, mesh as pmesh
from octopuszk_tpu_torch.relations import construct
from octopuszk_tpu_torch.utils.config import Config

# The port's CPU path is many small tensor ops.  Several test processes
# share the cores, and torch's intra-op thread pools would oversubscribe
# them (each op many times slower), so each process keeps one thread.
torch.set_num_threads(1)

SETUP_SEED, PROVE_SEED = 22, 23
QUERIES = dgroth16.QUERIES


def _mesh(d):
    return pmesh.make_mesh(d, device="cpu")


def _points(proof):
    return proof.a, proof.b, proof.c


@pytest.fixture(scope="module")
def relation():
    """Domain 16: the smallest that four shards take (n >= d^2)."""
    return construct.serial_construct(13, 3, seed=21, device="cpu")


@pytest.fixture(scope="module")
def serial(relation):
    r1cs, primary, aux = relation
    crs = setup.setup(r1cs, seed=SETUP_SEED)
    return crs, prover.prove(crs.proving_key, primary, aux, seed=PROVE_SEED)


@pytest.fixture(scope="module")
def distributed(relation):
    """d -> (mesh, CRS, proof) of a distributed setup and prove, made on
    first use."""
    runs = {}

    def run(d):
        if d not in runs:
            r1cs, primary, aux = relation
            mesh = _mesh(d)
            crs = dgroth16.distributed_setup(
                mesh, dgroth16.shard_r1cs(mesh, r1cs), seed=SETUP_SEED)
            runs[d] = (mesh, crs, dgroth16.distributed_prove(
                mesh, crs.proving_key, primary, aux, seed=PROVE_SEED))
        return runs[d]
    return run


def test_shard_crs_needs_rows_that_split(serial):
    crs, _ = serial
    with pytest.raises(ValueError, match="do not split"):
        dgroth16.shard_crs(_mesh(3), crs)


def test_gather_and_shard_need_a_packed_key(serial):
    crs, _ = serial
    unpacked = dataclasses.replace(crs, proving_key=dataclasses.replace(
        crs.proving_key, packed=False))
    with pytest.raises(ValueError, match="packed"):
        dgroth16.shard_crs(_mesh(2), unpacked)
    with pytest.raises(ValueError, match="packed"):
        dgroth16.gather_crs(_mesh(2), unpacked)
    with pytest.raises(ValueError, match="packed"):
        dgroth16.distributed_prove(_mesh(2), unpacked.proving_key, [1], [])


def test_debug_checks_satisfiability(relation, serial):
    """With ``config.debug`` a corrupted assignment fails the sharded
    satisfiability check before any proving work."""
    _, primary, aux = relation
    crs, _ = serial
    bad = list(aux)
    bad[0] = (bad[0] + 1) % FR.p
    mesh = _mesh(2)
    with pytest.raises(AssertionError, match="not satisfied"):
        dgroth16.distributed_prove(
            mesh, dgroth16.shard_crs(mesh, crs).proving_key, primary, bad,
            config=Config(debug=True))


@pytest.mark.parametrize("d", [1, 2, 4])
def test_distributed_proof_equals_serial(relation, serial, distributed, d):
    _, primary, _ = relation
    crs, proof = serial
    mesh, dcrs, dproof = distributed(d)
    assert _points(dproof) == _points(proof)
    assert dcrs.verification_key == crs.verification_key
    assert [q.shape[0] for q in dcrs.proving_key.query_a] == [
        crs.proving_key.query_a.shape[0] // d] * d
    assert verifier.verify(dcrs.verification_key, primary, dproof)


def test_gathered_crs_saves_loads_and_proves_serially(
        relation, serial, distributed, tmp_path):
    _, primary, aux = relation
    _, proof = serial
    mesh, dcrs, _ = distributed(2)
    gathered = dgroth16.gather_crs(mesh, dcrs)
    path = str(tmp_path / "dcrs.npz")
    serialize.save_crs(path, gathered)
    loaded = serialize.load_crs(path, device="cpu")
    pk = loaded.proving_key
    assert pk.packed and pk.delta_abc_full
    for q in QUERIES:
        assert torch.equal(getattr(pk, q), torch.cat(getattr(
            dcrs.proving_key, q))), q
    got = prover.prove(pk, primary, aux, seed=PROVE_SEED)
    assert _points(got) == _points(proof)


def test_shard_crs_of_the_serial_crs_proves(relation, serial):
    """The serial setup's key (deltaABC over the auxiliary variables only)
    sharded over four shards: the prover drops the primary scalars across
    the shard boundaries."""
    _, primary, aux = relation
    crs, proof = serial
    mesh = _mesh(4)
    sharded = dgroth16.shard_crs(mesh, crs)
    assert not sharded.proving_key.delta_abc_full
    for q in QUERIES:
        assert torch.equal(torch.cat(getattr(sharded.proving_key, q)),
                           getattr(crs.proving_key, q)), q
    got = dgroth16.distributed_prove(mesh, sharded.proving_key, primary, aux,
                                     seed=PROVE_SEED)
    assert _points(got) == _points(proof)
