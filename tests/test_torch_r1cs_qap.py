"""relations/ and reductions/ of the PyTorch port against the JAX reference
on ``serial_construct(14, 3)``, carried across by ``convert`` (exact)."""

import numpy as np
import pytest
import torch

from octopuszk_tpu.fields.spec import FR as RFR
from octopuszk_tpu.reductions import r1cs_to_qap as rqap
from octopuszk_tpu.relations import construct as rconstruct, r1cs as rr1cs

from octopuszk_tpu_torch import convert
from octopuszk_tpu_torch.fields.spec import FR
from octopuszk_tpu_torch.reductions import r1cs_to_qap as qap
from octopuszk_tpu_torch.relations import construct, r1cs

# The port's CPU path is many small tensor ops.  Several test processes
# share the cores, and torch's intra-op thread pools would oversubscribe
# them (each op many times slower), so each process keeps one thread.
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def circuit():
    ref, primary, aux = rconstruct.serial_construct(14, 3, seed=7)
    mine, primary2, aux2 = construct.serial_construct(14, 3, seed=7,
                                                      device="cpu")
    assert (primary, aux) == (primary2, aux2)
    rz = rr1cs.assignment_to_device(RFR, primary + aux)
    tz = r1cs.assignment_to_device(FR, primary + aux, "cpu")
    return ref, mine, rz, tz


def _same(ref, got):
    np.testing.assert_array_equal(np.asarray(ref), convert.field_to_ref(got))


def test_construct_equals_converted_reference(circuit):
    ref, mine, rz, tz = circuit
    conv = convert.r1cs_from_ref(ref, "cpu")
    assert mine.is_valid() and conv.is_valid()
    assert (conv.num_constraints, conv.num_inputs, conv.num_variables) == (
        mine.num_constraints, mine.num_inputs, mine.num_variables)
    for name in "abc":
        a, b = getattr(conv, name), getattr(mine, name)
        for f in ("row", "col", "val", "row_chunk", "row_chunk_seg",
                  "col_chunk", "col_chunk_seg"):
            assert torch.equal(getattr(a, f), getattr(b, f)), (name, f)
        assert (a.num_rows, a.num_cols, a.nnz) == (b.num_rows, b.num_cols, b.nnz)
    _same(rz, tz)


@pytest.mark.parametrize("name", ["a", "b", "c"])
def test_matvec_rmatvec(circuit, name):
    ref, mine, rz, tz = circuit
    conv = convert.r1cs_from_ref(ref, "cpu")
    rm, tm = getattr(ref, name), getattr(conv, name)
    _same(rr1cs.matvec(RFR, rm, rz), r1cs.matvec(FR, tm, tz))
    rw, tw = rz[:, :ref.num_constraints], tz[:, :ref.num_constraints]
    _same(rr1cs.rmatvec(RFR, rm, rw), r1cs.rmatvec(FR, tm, tw))


def test_segment_sum_splits_long_runs(monkeypatch):
    """A run longer than CHUNK is split in two levels and still sums
    exactly (the dense last constraint at 2^20 does this)."""
    monkeypatch.setattr(r1cs, "CHUNK", 4)
    n = 11
    m = r1cs.make_sparse(FR, [0] * n + [1], list(range(n)) + [0],
                         [FR.p - 1] * n + [5], 2, n, device="cpu")
    assert int(m.row_chunk.max()) == 3
    vals = list(range(1, n + 1))
    z = r1cs.assignment_to_device(FR, vals, "cpu")
    from octopuszk_tpu_torch.fields import fp
    from octopuszk_tpu_torch.utils.bigint import words_to_ints
    got = words_to_ints(fp.from_mont(FR, r1cs.matvec(FR, m, z)).numpy())
    assert got == [(-sum(vals)) % FR.p, 5]


def test_is_satisfied(circuit):
    ref, mine, rz, tz = circuit
    assert r1cs.is_satisfied(FR, mine, tz)
    bad = tz.clone()
    bad[0, 4] ^= 1
    assert not r1cs.is_satisfied(FR, mine, bad)
    assert bool(rr1cs.is_satisfied(RFR, ref, rz))


def test_qap_witness(circuit):
    ref, mine, rz, tz = circuit
    n = qap.domain_size(mine)
    assert n == rqap.domain_size(ref) == 32
    _same(rqap.qap_witness(RFR, ref, n, rz), qap.qap_witness(FR, mine, n, tz))


def test_qap_instance(circuit):
    ref, mine, rz, tz = circuit
    t = 0x1234567890ABCDEF1234567890ABCDEF
    want, got = rqap.qap_instance(RFR, ref, t), qap.qap_instance(FR, mine, t)
    for f in ("at", "bt", "ct", "ht"):
        _same(getattr(want, f), getattr(got, f))
    assert (want.zt, want.t, want.num_inputs, want.num_variables,
            want.degree) == (got.zt, got.t, got.num_inputs,
                             got.num_variables, got.degree)


# ---------------------------------------------------------------------------
# the segment sums in slices of 2^MATVEC_CHUNK_LOG entries
# ---------------------------------------------------------------------------

T = 0x1234567890ABCDEF1234567890ABCDEF


def _slices(nnz, log):
    return -(-nnz // (1 << log))


@pytest.mark.parametrize("name", ["a", "b", "c"])
def test_matvec_rmatvec_in_slices(circuit, name, monkeypatch):
    """With MATVEC_CHUNK_LOG lowered so that the matrix's entries take three
    slices or more, the last a partial one, matvec and rmatvec equal the
    reference's and the port's one-slice results bit for bit."""
    ref, mine, rz, tz = circuit
    m, rm = getattr(mine, name), getattr(ref, name)
    w, rw = tz[:, :mine.num_constraints], rz[:, :ref.num_constraints]
    assert m.nnz <= 1 << r1cs.MATVEC_CHUNK_LOG
    whole = r1cs.matvec(FR, m, tz), r1cs.rmatvec(FR, m, w)
    log = max(k for k in range(m.nnz.bit_length())
              if m.nnz > 2 << k and m.nnz % (1 << k))
    assert _slices(m.nnz, log) >= 3
    monkeypatch.setattr(r1cs, "MATVEC_CHUNK_LOG", log)
    got = r1cs.matvec(FR, m, tz), r1cs.rmatvec(FR, m, w)
    assert all(torch.equal(a, b) for a, b in zip(got, whole))
    _same(rr1cs.matvec(RFR, rm, rz), got[0])
    _same(rr1cs.rmatvec(RFR, rm, rw), got[1])


@pytest.fixture(scope="module")
def reference_qap(circuit):
    ref, _, rz, _ = circuit
    n = rqap.domain_size(ref)
    return rqap.qap_witness(RFR, ref, n, rz), rqap.qap_instance(RFR, ref, T)


@pytest.mark.parametrize("log, cut", [(2, "ac"), (3, "b")])
def test_qap_in_slices(circuit, reference_qap, monkeypatch, log, cut):
    """qap_witness and qap_instance with the segment sums in slices of
    2^log entries equal the reference's.  Between the two sizes each of
    A, B and C takes three slices or more, the last a partial one (``cut``
    names the matrices that do at this size; the others take two or
    more)."""
    ref, mine, _, tz = circuit
    for name in "abc":
        nnz = getattr(mine, name).nnz
        assert _slices(nnz, log) >= (3 if name in cut else 2)
        assert name not in cut or nnz % (1 << log)
    monkeypatch.setattr(r1cs, "MATVEC_CHUNK_LOG", log)
    want_h, want = reference_qap
    _same(want_h, qap.qap_witness(FR, mine, qap.domain_size(mine), tz))
    got = qap.qap_instance(FR, mine, T)
    for f in ("at", "bt", "ct", "ht"):
        _same(getattr(want, f), getattr(got, f))


def test_segment_cut_by_a_slice(monkeypatch):
    """A first-level segment whose entries fall in two slices still sums
    exactly: with CHUNK = 3, row 0's thirteen entries are segments of
    three, slices of 2^2 entries cut two of them (entries 3-5 and 6-8), the
    last slice is a partial one, and column 0's two entries lie in the
    first and the last slice (rmatvec)."""
    from octopuszk_tpu_torch.fields import fp
    from octopuszk_tpu_torch.utils.bigint import words_to_ints
    monkeypatch.setattr(r1cs, "CHUNK", 3)
    monkeypatch.setattr(r1cs, "MATVEC_CHUNK_LOG", 2)
    n = 13
    rows, cols = [0] * n + [1], list(range(n)) + [0]
    vals = [FR.p - 1 - 7 * i for i in range(n)] + [5]
    m = r1cs.make_sparse(FR, rows, cols, vals, 2, n, device="cpu")
    assert int(m.row_chunk.max()) == 5 and _slices(m.nnz, 2) == 4
    z, w = list(range(1, n + 1)), [11, 13]

    def ints(x):
        return words_to_ints(fp.from_mont(FR, x).numpy())

    got = ints(r1cs.matvec(FR, m, r1cs.assignment_to_device(FR, z, "cpu")))
    assert got == [sum(v * z[c] for r, c, v in zip(rows, cols, vals)
                       if r == i) % FR.p for i in range(2)]
    got = ints(r1cs.rmatvec(FR, m, r1cs.assignment_to_device(FR, w, "cpu")))
    assert got == [sum(v * w[r] for r, c, v in zip(rows, cols, vals)
                       if c == j) % FR.p for j in range(n)]
