"""The slice as a whole: serial Groth16 on ``serial_construct(14, 3, seed=7)``
in the PyTorch port against the JAX reference.  The same seeds give the same
CRS (packed queries bit for bit after ``convert``) and the same proof, and
each verifier accepts the other's proof.  A CRS file written by either
package loads in the other, and the unpacked and streamed keys loaded from
such a file prove to the reference's proof."""

import dataclasses

import numpy as np
import pytest
import torch

from octopuszk_tpu.curves import bn254 as rbn
from octopuszk_tpu.models.groth16 import (
    objects as robjects, prover as rprover, serialize as rserialize,
    setup as rsetup, verifier as rverifier)
from octopuszk_tpu.ops import msm as rmsm
from octopuszk_tpu.relations import construct as rconstruct

from octopuszk_tpu_torch import convert
from octopuszk_tpu_torch.curves import (
    bn254, group_ops as jac, host_curve as hc)
from octopuszk_tpu_torch.fields.spec import FR
from octopuszk_tpu_torch.models.groth16 import (
    prover, serialize, setup, verifier)
from octopuszk_tpu_torch.models.groth16.objects import Proof
from octopuszk_tpu_torch.ops import msm
from octopuszk_tpu_torch.relations import construct

# The port's CPU path is many small tensor ops.  Several test processes
# share the cores, and torch's intra-op thread pools would oversubscribe
# them (each op many times slower), so each process keeps one thread.
torch.set_num_threads(1)

QUERIES = ("query_a", "query_b_g1", "query_b_g2", "query_h", "delta_abc_g1")


@pytest.fixture(scope="module")
def reference():
    r1cs, primary, aux = rconstruct.serial_construct(14, 3, seed=7)
    crs = rsetup.setup(r1cs, seed=8)
    proof = rprover.prove(crs.proving_key, primary, aux, seed=9)
    return crs, primary, aux, proof


@pytest.fixture(scope="module")
def ported():
    r1cs, primary, aux = construct.serial_construct(14, 3, seed=7, device="cpu")
    stages = {}
    crs = setup.setup(r1cs, seed=8, stage_seconds=stages)
    assert "enc-H(g1)" in stages and all(v >= 0 for v in stages.values())
    return crs, primary, aux


def test_setup_equals_reference(reference, ported):
    rcrs, *_ = reference
    crs, *_ = ported
    want = convert.proving_key_from_ref(rcrs.proving_key, device="cpu")
    pk = crs.proving_key
    for q in QUERIES:
        assert torch.equal(getattr(pk, q), getattr(want, q)), q
        np.testing.assert_array_equal(
            convert.packed_to_ref(getattr(pk, q)),
            np.asarray(getattr(rcrs.proving_key, q)))
    for f in ("alpha_g1", "beta_g1", "beta_g2", "delta_g1", "delta_g2"):
        assert getattr(pk, f) == getattr(want, f), f
    assert pk.packed and want.packed
    vk = crs.verification_key
    rvk = convert.verification_key_from_ref(rcrs.verification_key)
    assert vk.alpha_beta_gt == rvk.alpha_beta_gt
    assert (vk.gamma_g2, vk.delta_g2) == (rvk.gamma_g2, rvk.delta_g2)
    assert vk.gamma_abc_g1 == rvk.gamma_abc_g1 and len(vk.gamma_abc_g1) == 3


SETUP_STAGES = ["qap-instance", "scalars", "window-tables", "enc-A(g1)",
                "enc-B(g1)", "enc-B(g2)", "enc-deltaABC(g1)", "enc-H(g1)",
                "enc-gammaABC(g1)", "host-points+pairing"]


def test_setup_in_chunks_equals_reference(reference, monkeypatch):
    """setup with its fixed-base evaluation on the packed path (from one
    scalar) in chunks of 2^5 scalars: the 64-scalar queries in two chunks
    each (window width 4 keeps the tables small).  The packed queries and
    gammaABC equal the reference's; ``stage_bytes`` stays empty on the CPU
    and ``stage_seconds`` keeps its stages."""
    rcrs, *_ = reference
    monkeypatch.setattr(msm, "FIXED_PACKED_MIN", 1)
    monkeypatch.setattr(msm, "FIXED_CHUNK_LOG", 5)
    monkeypatch.setattr(msm, "_choose_w_packed", lambda n: 4)
    chunks = []
    whole = msm.fixed_base_msm
    monkeypatch.setattr(msm, "fixed_base_msm", lambda g, b, s, **kw: (
        chunks.append(s.shape[1]), whole(g, b, s, **kw))[1])
    r1cs, *_ = construct.serial_construct(14, 3, seed=7, device="cpu")
    stages, stage_bytes = {}, {}
    crs = setup.setup(r1cs, seed=8, stage_seconds=stages,
                      stage_bytes=stage_bytes)
    assert chunks == [32] * 2 * len(QUERIES) + [3]   # + gammaABC's inputs
    pk = crs.proving_key
    for q in QUERIES:
        np.testing.assert_array_equal(
            convert.packed_to_ref(getattr(pk, q)),
            np.asarray(getattr(rcrs.proving_key, q)))
    rvk = convert.verification_key_from_ref(rcrs.verification_key)
    assert crs.verification_key.gamma_abc_g1 == rvk.gamma_abc_g1
    assert list(stages) == SETUP_STAGES and stage_bytes == {}


def test_prove_on_reference_key_equals_reference(reference):
    rcrs, primary, aux, rproof = reference
    pk = convert.proving_key_from_ref(rcrs.proving_key, device="cpu")
    proof = prover.prove(pk, primary, aux, seed=9)
    assert (proof.a, proof.b, proof.c) == (rproof.a, rproof.b, rproof.c)


@pytest.fixture(scope="module")
def port_proof(ported):
    """A proof made wholly by the port, every MSM through the Pippenger
    pipeline (the default dispatch is double-and-add at this size)."""
    crs, primary, aux = ported
    saved = msm.NAIVE_THRESHOLD
    msm.NAIVE_THRESHOLD = 0
    try:
        stages, stage_bytes = {}, {}
        proof = prover.prove(crs.proving_key, primary, aux, seed=9,
                             stage_seconds=stages, stage_bytes=stage_bytes)
    finally:
        msm.NAIVE_THRESHOLD = saved
    assert "msm-B(g1+g2)" in stages
    assert stage_bytes == {}          # device memory is marked on a card only
    return proof


def test_pippenger_proof_equals_reference(reference, port_proof):
    *_, rproof = reference
    assert (port_proof.a, port_proof.b, port_proof.c) == (
        rproof.a, rproof.b, rproof.c)


def test_each_verifier_accepts_the_other(reference, ported, port_proof):
    rcrs, primary, _, rproof = reference
    crs, *_ = ported
    assert rverifier.verify(
        rcrs.verification_key, primary,
        robjects.Proof(a=port_proof.a, b=port_proof.b, c=port_proof.c))
    assert verifier.verify(crs.verification_key, primary,
                           Proof(a=rproof.a, b=rproof.b, c=rproof.c))
    assert verifier.verify(crs.verification_key, primary, port_proof)


def test_reject_wrong_input(ported, port_proof):
    crs, primary, _ = ported
    bad = list(primary)
    bad[1] = (bad[1] + 1) % FR.p
    assert not verifier.verify(crs.verification_key, bad, port_proof)
    with pytest.raises(ValueError):
        verifier.verify(crs.verification_key, [2] + bad[1:], port_proof)


def test_reject_tampered_proof(ported, port_proof):
    crs, primary, _ = ported
    tampered = Proof(a=hc.g1_add(port_proof.a, hc.G1_GEN), b=port_proof.b,
                     c=port_proof.c)
    assert not verifier.verify(crs.verification_key, primary, tampered)


def test_debug_checks(ported):
    """config.debug turns on the satisfiability assertion."""
    import types
    crs, primary, aux = ported
    bad_aux = list(aux)
    bad_aux[0] = (bad_aux[0] + 1) % FR.p
    with pytest.raises(AssertionError, match="not satisfied"):
        prover.prove(crs.proving_key, primary, bad_aux, seed=9,
                     config=types.SimpleNamespace(debug=True))


# ---------------------------------------------------------------------------
# a CRS on disk (serialize.py): the reference's file format both ways, the
# unpacked and the streamed prover
# ---------------------------------------------------------------------------

MATRIX_FIELDS = ("row", "col", "val", "row_chunk", "row_chunk_seg",
                 "col_chunk", "col_chunk_seg")


@pytest.fixture(scope="module")
def reference_file(reference, tmp_path_factory):
    rcrs, *_ = reference
    path = str(tmp_path_factory.mktemp("crs") / "reference.npz")
    rserialize.save_crs(path, rcrs)
    return path


def _same_r1cs(r1cs, rr1cs):
    for m in ("a", "b", "c"):
        got = convert.sparse_to_ref(getattr(r1cs, m))
        want = getattr(rr1cs, m)
        for f in MATRIX_FIELDS:
            np.testing.assert_array_equal(getattr(got, f),
                                          np.asarray(getattr(want, f)))
            assert getattr(got, f).dtype == np.asarray(getattr(want, f)).dtype
        assert (got.num_rows, got.num_cols) == (want.num_rows, want.num_cols)
    for f in ("num_constraints", "num_inputs", "num_variables"):
        assert getattr(r1cs, f) == getattr(rr1cs, f)


def test_reference_file_loads_in_port(reference_file, ported):
    crs, *_ = ported
    loaded = serialize.load_crs(reference_file, device="cpu")
    pk, want = loaded.proving_key, crs.proving_key
    assert pk.packed and not pk.delta_abc_full
    for q in QUERIES:
        assert torch.equal(getattr(pk, q), getattr(want, q)), q
    for f in ("alpha_g1", "beta_g1", "beta_g2", "delta_g1", "delta_g2"):
        assert getattr(pk, f) == getattr(want, f), f
    for m in ("a", "b", "c"):
        for f in MATRIX_FIELDS:
            assert torch.equal(getattr(getattr(pk.r1cs, m), f),
                               getattr(getattr(want.r1cs, m), f)), (m, f)
    assert loaded.verification_key == crs.verification_key


def test_port_file_loads_in_reference(reference, ported, tmp_path):
    rcrs, *_ = reference
    crs, *_ = ported
    path = str(tmp_path / "port")
    serialize.save_crs(path, crs)                 # ".npz" appended
    loaded = rserialize.load_crs(path)
    rpk, want = loaded.proving_key, rcrs.proving_key
    assert rpk.packed and not rpk.delta_abc_full
    for q in QUERIES:
        np.testing.assert_array_equal(np.asarray(getattr(rpk, q)),
                                      np.asarray(getattr(want, q)))
    _same_r1cs(crs.proving_key.r1cs, rpk.r1cs)
    _same_r1cs(crs.proving_key.r1cs, want.r1cs)
    for f in ("alpha_g1", "beta_g1", "beta_g2", "delta_g1", "delta_g2"):
        assert getattr(rpk, f) == getattr(want, f), f
    rvk, wvk = loaded.verification_key, rcrs.verification_key
    assert (rvk.alpha_beta_gt, rvk.gamma_g2, rvk.delta_g2,
            rvk.gamma_abc_g1) == (wvk.alpha_beta_gt, wvk.gamma_g2,
                                  wvk.delta_g2, wvk.gamma_abc_g1)


def test_unpacked_key_from_reference_file(reference, tmp_path):
    """A key of projective point batches (the reference's own unpacking,
    written by the reference) proves through the sort-based Pippenger to
    the reference's proof."""
    rcrs, primary, aux, rproof = reference
    rpk = rcrs.proving_key
    unpacked = dataclasses.replace(rpk, packed=False, **{
        q: rmsm.packed_to_points(rbn.G2 if q == "query_b_g2" else rbn.G1,
                                 getattr(rpk, q)) for q in QUERIES})
    path = str(tmp_path / "unpacked.npz")
    rserialize.save_crs(path, robjects.CRS(
        proving_key=unpacked, verification_key=rcrs.verification_key))
    loaded = serialize.load_crs(path, device="cpu")
    pk = loaded.proving_key
    assert not pk.packed and isinstance(pk.query_b_g2[0], tuple)
    for q in QUERIES:
        got = convert.points_to_ref(getattr(pk, q))
        for a, b in zip(jac.flatten_coords(got),
                        jac.flatten_coords(getattr(unpacked, q))):
            np.testing.assert_array_equal(a, np.asarray(b))
    proof = prover.prove(pk, primary, aux, seed=9)
    assert (proof.a, proof.b, proof.c) == (rproof.a, rproof.b, rproof.c)
    # and back to the reference's layout, unchanged
    back = convert.proving_key_to_ref(pk)
    for a, b in zip(jac.flatten_coords(back.query_h),
                    jac.flatten_coords(unpacked.query_h)):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_streamed_key_proves_the_same(reference, reference_file):
    *_, primary, aux, rproof = reference
    loaded = serialize.load_crs(reference_file, device="cpu", stream=True)
    pk = loaded.proving_key
    assert pk.packed and pk.query_a.device.type == "cpu"
    proof = prover.prove(pk, primary, aux, seed=9)
    assert (proof.a, proof.b, proof.c) == (rproof.a, rproof.b, rproof.c)


def test_queries_moved_to_host_prove_the_same(ported, port_proof):
    """A key whose packed queries were moved to host memory in the process
    (``convert.queries_to_host``: on the card, pinned copies, the card's
    freed with the old key) proves to the resident key's proof.  On the
    CPU the queries are in host memory already and stay as they are; an
    unpacked key is refused."""
    crs, primary, aux = ported
    pk = convert.queries_to_host(crs.proving_key)
    assert pk.packed and pk.r1cs is crs.proving_key.r1cs
    for q in QUERIES:
        assert getattr(pk, q) is getattr(crs.proving_key, q), q
    proof = prover.prove(pk, primary, aux, seed=9)
    assert (proof.a, proof.b, proof.c) == (port_proof.a, port_proof.b,
                                           port_proof.c)
    with pytest.raises(ValueError, match="packed"):
        convert.queries_to_host(dataclasses.replace(pk, packed=False))


def test_proof_round_trip(reference, port_proof, tmp_path):
    *_, rproof = reference
    path = str(tmp_path / "proof.json")
    serialize.save_proof(path, port_proof)
    assert serialize.load_proof(path) == port_proof
    got = rserialize.load_proof(path)
    assert (got.a, got.b, got.c) == (rproof.a, rproof.b, rproof.c)
    rserialize.save_proof(path, rproof)
    assert serialize.load_proof(path) == port_proof


def test_prover_runs_on_the_r1cs_device(ported, monkeypatch):
    """The prover's device is the R1CS's, never the queries': with packed
    queries on another device (here "meta") it builds the assignment and
    the witness map on the R1CS's device, and the MSMs refuse the queries
    instead of moving the work to them; an unpacked key with queries
    elsewhere is refused before any work."""
    crs, primary, aux = ported
    pk = crs.proving_key
    elsewhere = {q: getattr(pk, q).to("meta") for q in QUERIES}
    seen = []

    def witness_map(fr, r1cs, n, z, stage_seconds=None):
        seen.append(z.device)
        return torch.zeros((8, n), dtype=torch.int32, device=z.device)

    monkeypatch.setattr(prover, "qap_witness", witness_map)
    with pytest.raises(ValueError, match="base lies on meta"):
        prover.prove(dataclasses.replace(pk, **elsewhere), primary, aux,
                     seed=9)
    assert seen == [torch.device("cpu")]
    unpacked = dataclasses.replace(pk, packed=False, **{
        q: jac._map_coords(msm.packed_to_points(
            bn254.G2 if q == "query_b_g2" else bn254.G1, getattr(pk, q)[:4]),
            lambda c: c.to("meta")) for q in QUERIES})
    with pytest.raises(ValueError, match="meta"):
        prover.prove(unpacked, primary, aux, seed=9)
    assert len(seen) == 1


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "unpacked"])
def test_delta_abc_full_key(reference, ported, packed):
    """A deltaABC query over all m variables (primary entries present)
    gives the reference's proof of the aux-only key: the prover zeroes the
    primary scalars, on the packed and on the unpacked branch (where the
    reference slices them)."""
    *_, primary, aux, rproof = reference
    crs, *_ = ported
    pk = crs.proving_key
    ni = pk.r1cs.num_inputs
    # the aux-only query shifted up by ni rows; the ni primary rows hold
    # points that must not count (here: the first query_a points)
    full = torch.cat([pk.query_a[:ni], pk.delta_abc_g1[:-ni]])
    assert not pk.delta_abc_g1[-ni:].any()      # only padding is dropped
    key = dataclasses.replace(pk, delta_abc_full=True, delta_abc_g1=full)
    if not packed:
        key = dataclasses.replace(key, packed=False, **{
            q: msm.packed_to_points(
                bn254.G2 if q == "query_b_g2" else bn254.G1, getattr(key, q))
            for q in QUERIES})
    proof = prover.prove(key, primary, aux, seed=9)
    assert (proof.a, proof.b, proof.c) == (rproof.a, rproof.b, rproof.c)
