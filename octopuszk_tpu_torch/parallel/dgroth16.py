"""Distributed Groth16: sharded R1CS, witness map, setup and prover.

Port of ``octopuszk_tpu/parallel/dgroth16.py`` over the mesh of
``parallel/mesh.py``:

* the nonzero terms of A, B and C are split evenly over the shards
  (``shard_r1cs``); the chunk tables of the two-level segment sum are
  replicated;
* A z (and A^T w) is the hierarchical exact segment sum of
  ``relations/r1cs.py``, with the first level per shard and a ``psum``
  between the levels: each shard's chunk partials are canonical (< 2^16 a
  digit), their sum across d shards is exact, and it is reduced again
  before the second level;
* the transforms are ``parallel/dntt.py``'s, the MSMs ``parallel/
  dmsm.py``'s; the setup's queries are sharded packed rows.

The setup and the prover draw their randomness from ``random.Random(seed)``
in the serial setup's and prover's order, so the same seeds give the same
CRS secrets and the same proof as the serial path.  Where the reference
overlaps the G2 work on a thread, the port runs it in order, as its serial
setup and prover do.  ``gather_crs`` and ``shard_crs`` carry a CRS between
the distributed and the serial form (which ``save_crs`` writes).
"""

from __future__ import annotations

import dataclasses
import random
import time

import torch

from octopuszk_tpu_torch.curves import group_ops as jac
from octopuszk_tpu_torch.fields import fp
from octopuszk_tpu_torch.fields.spec import FieldSpec
from octopuszk_tpu_torch.models.groth16.objects import (
    CRS, Proof, ProvingKey, VerificationKey)
from octopuszk_tpu_torch.ops import kernels, ntt
from octopuszk_tpu_torch.parallel import dmsm, dntt, mesh as pmesh
from octopuszk_tpu_torch.relations import r1cs as rel
from octopuszk_tpu_torch.relations.r1cs import R1CS, SparseMatrix

QUERIES = ("query_a", "query_b_g1", "query_b_g2", "query_h", "delta_abc_g1")


@dataclasses.dataclass(frozen=True)
class ShardedMatrix:
    """A COO matrix with its terms split over the shards (lists, one
    tensor per shard) and its chunk-to-row / chunk-to-column tables
    replicated (one copy per shard, on the shard's device)."""

    row: list                 # per shard int64[nnz/d]
    col: list
    val: list                 # per shard int32[8, nnz/d]
    row_chunk: list
    row_chunk_seg: list       # replicated int64[num_chunks]
    num_rows: int
    num_chunks: int
    col_chunk: list
    col_chunk_seg: list       # replicated int64[num_col_chunks]
    num_cols: int
    num_col_chunks: int


@dataclasses.dataclass(frozen=True)
class ShardedR1CS:
    a: ShardedMatrix
    b: ShardedMatrix
    c: ShardedMatrix
    num_constraints: int
    num_inputs: int
    num_variables: int


def _pad_last(t, pad: int):
    if pad == 0:
        return t
    z = torch.zeros(t.shape[:-1] + (pad,), dtype=t.dtype, device=t.device)
    return torch.cat([t, z], dim=-1)


def _replicate(mesh, t):
    return [pmesh.place(t, dev) for dev in mesh.devices]


def shard_matrix(mesh, m: SparseMatrix) -> ShardedMatrix:
    """Split the terms evenly; the nnz padding is zero-valued terms at
    (row 0, column 0) in chunk 0, which add zero."""
    pad = (-m.nnz) % mesh.size
    sh = lambda t: pmesh.shard_vector(mesh, _pad_last(t, pad))
    return ShardedMatrix(
        row=sh(m.row), col=sh(m.col), val=sh(m.val),
        row_chunk=sh(m.row_chunk),
        row_chunk_seg=_replicate(mesh, m.row_chunk_seg),
        num_rows=m.num_rows, num_chunks=int(m.row_chunk_seg.shape[0]),
        col_chunk=sh(m.col_chunk),
        col_chunk_seg=_replicate(mesh, m.col_chunk_seg),
        num_cols=m.num_cols, num_col_chunks=int(m.col_chunk_seg.shape[0]))


def shard_r1cs(mesh, r1cs: R1CS) -> ShardedR1CS:
    return ShardedR1CS(
        a=shard_matrix(mesh, r1cs.a), b=shard_matrix(mesh, r1cs.b),
        c=shard_matrix(mesh, r1cs.c), num_constraints=r1cs.num_constraints,
        num_inputs=r1cs.num_inputs, num_variables=r1cs.num_variables)


def _two_level_sum(spec, terms, chunk, chunk_seg, num_chunks: int,
                   num_out: int):
    """The shards' terms (Montgomery, one list entry per shard) summed by
    chunk on each shard, the canonical partials summed exactly across the
    shards (``psum``), reduced, then summed by chunk into ``num_out``
    outputs on the first shard's device."""
    parts = [fp.reduce_sum_mont(spec, rel._segment_sum(fp.split16(t), c,
                                                       num_chunks))
             for t, c in zip(terms, chunk)]
    part = fp.reduce_sum_mont(spec, pmesh.psum(
        [fp.split16(p) for p in parts]))
    return fp.reduce_sum_mont(spec, rel._segment_sum(
        fp.split16(part), chunk_seg[0], num_out))


def _matvec(spec, sm: ShardedMatrix, z_full):
    """A z from the replicated full z: int32[8, num_rows] on the first
    shard's device."""
    terms = [fp.mont_mul(spec, v, z[:, c])
             for v, c, z in zip(sm.val, sm.col, z_full)]
    return _two_level_sum(spec, terms, sm.row_chunk, sm.row_chunk_seg,
                          sm.num_chunks, sm.num_rows)


def _rmatvec(spec, sm: ShardedMatrix, w_full):
    """A^T w from the replicated full w: int32[8, num_cols] on the first
    shard's device."""
    terms = [fp.mont_mul(spec, v, w[:, r])
             for v, r, w in zip(sm.val, sm.row, w_full)]
    return _two_level_sum(spec, terms, sm.col_chunk, sm.col_chunk_seg,
                          sm.num_col_chunks, sm.num_cols)


def distributed_is_satisfied(mesh, spec: FieldSpec, sr: ShardedR1CS,
                             z) -> bool:
    """A z * B z == C z for a sharded assignment z (zero-padded past the
    variables): all_gather of z, the local terms, the sums with a psum."""
    z_full = pmesh.all_gather(z, axis=1)
    az, bz, cz = (_matvec(spec, m, z_full) for m in (sr.a, sr.b, sr.c))
    return bool(fp.eq(fp.mont_mul(spec, az, bz), cz).all())


def distributed_witness(mesh, spec: FieldSpec, sr: ShardedR1CS, n: int, z):
    """The QAP witness map of a sharded assignment z: H's coefficients
    sharded [8, n/d] each (the serial path's extra top zero is the
    caller's; deg H <= n - 2, so H[n-1] is zero too)."""
    nc, ni = sr.num_constraints, sr.num_inputs
    z_full = pmesh.all_gather(z, axis=1)
    dev = z_full[0].device
    evals = []
    for mat, with_inputs in ((sr.a, True), (sr.b, False), (sr.c, False)):
        # the constraints, then (for A) the input-consistency rows, then
        # zero padding to the domain
        e = torch.zeros((z_full[0].shape[0], n), dtype=torch.int32,
                        device=dev)
        e[:, :nc] = _matvec(spec, mat, z_full)
        if with_inputs:
            e[:, nc:nc + ni] = z_full[0][:, :ni]
        evals.append(pmesh.shard_vector(mesh, e))

    def to_coset(xs):
        return dntt.distributed_ntt(
            mesh, spec, dntt.distributed_ntt(mesh, spec, xs, inverse=True),
            coset=True)

    a_c, b_c, c_c = (to_coset(e) for e in evals)
    zinv = pow(ntt.compute_z_at(spec, n, spec.generator), -1, spec.p)
    h_coset = [fp.mont_mul(spec, kernels.mul_sub(spec, a, b, c),
                           ntt._elem(spec, zinv, a.device)[:, None])
               for a, b, c in zip(a_c, b_c, c_c)]
    return dntt.distributed_ntt(mesh, spec, h_coset, inverse=True,
                                coset=True)


def distributed_lagrange(mesh, spec: FieldSpec, n: int, t: int):
    """L_i(t), i < n, sharded: each shard its block of omega^i, one batch
    inversion of t - omega^i.  t must lie outside the domain (the random
    secret's case)."""
    if pow(t, n, spec.p) == 1:
        raise ValueError("t lies in the evaluation domain")
    d = mesh.size
    omega = spec.rou_of_order(n)
    zt_over_n = (pow(t, n, spec.p) - 1) * pow(n, -1, spec.p) % spec.p
    out = []
    for i, dev in enumerate(mesh.devices):
        w = dntt._dev_scaled_powers(spec, omega, n // d, i, dev)
        diff = fp.sub(spec, ntt._elem(spec, t, dev)[:, None].expand(w.shape),
                      w)
        zc = ntt._elem(spec, zt_over_n, dev)[:, None]
        out.append(fp.mont_mul(spec, fp.mont_mul(
            spec, w, fp.batch_inv_rows(spec, diff)), zc))
    return out


def sharded_pad(x: int, d: int, min_local: int = 4) -> int:
    """A batch length padded so that each shard's block is a power of two,
    at least ``min_local``: the packed-MSM lane plan tiles it exactly."""
    local = max(min_local, -(-x // d))
    return d * (1 << (local - 1).bit_length())


def _pad_and_shard(mesh, x, length: int):
    return pmesh.shard_vector(mesh, _pad_last(x, length - x.shape[1]))


def distributed_qap_instance(mesh, spec: FieldSpec, sr: ShardedR1CS,
                             t: int, n: int, m_pad: int | None = None,
                             h_pad: int | None = None):
    """The QAP at t: At, Bt, Ct sharded over m_pad, Ht (powers of t)
    sharded over h_pad, and Z(t) as a host int."""
    d = mesh.size
    nc, ni, m = sr.num_constraints, sr.num_inputs, sr.num_variables
    if m_pad is None:
        m_pad = sharded_pad(m, d)
    if h_pad is None:
        h_pad = sharded_pad(n + 1, d)
    lag_full = pmesh.all_gather(distributed_lagrange(mesh, spec, n, t),
                                axis=1)
    w = [lag[:, :nc] for lag in lag_full]
    at, bt, ct = (_rmatvec(spec, mm, w) for mm in (sr.a, sr.b, sr.c))
    # input consistency: At_i += L_{nc+i}(t), i < ni
    consist = torch.zeros_like(at)
    consist[:, :ni] = lag_full[0][:, nc:nc + ni]
    at = fp.add(spec, at, consist)
    ht = [dntt._dev_scaled_powers(spec, t, h_pad // d, i, dev)
          for i, dev in enumerate(mesh.devices)]
    return (_pad_and_shard(mesh, at, m_pad), _pad_and_shard(mesh, bt, m_pad),
            _pad_and_shard(mesh, ct, m_pad), ht,
            ntt.compute_z_at(spec, n, t))


def _marker(mesh, stage_seconds):
    """mark(label): the wall time since the last mark into
    ``stage_seconds``, every card of the mesh synchronised first."""
    t0 = [time.perf_counter()]

    def mark(label):
        if stage_seconds is not None:
            for dev in set(mesh.devices):
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
            stage_seconds[label] = time.perf_counter() - t0[0]
            t0[0] = time.perf_counter()
    return mark


def _global_index(x, shard: int):
    """The global batch positions of a shard's block."""
    local = x.shape[-1]
    return torch.arange(shard * local, (shard + 1) * local, device=x.device)


def _first_points(group, shards, k: int):
    """The first k points of a sharded point batch, to the host."""
    out = []
    for p in shards:
        if len(out) >= k:
            break
        out += group.points_to_host(jac._map_coords(
            p, lambda c: c[..., :k - len(out)]))
    return out


def distributed_setup(mesh, sr: ShardedR1CS, seed: int = 1, curve=None,
                      stage_seconds=None) -> CRS:
    """The CRS over the mesh: every proving-key query is sharded packed
    rows.  delta_abc_g1 covers all m variables, the primary entries scaled
    by gamma^-1 and the rest by delta^-1 (the prover zeroes the primary
    scalars: ``delta_abc_full``); the verification key's gammaABC is its
    primary prefix.  ``curve``: a curves/family.py bundle, default BN254a;
    ``stage_seconds``: an optional dict of each stage's wall time."""
    if curve is None:
        from octopuszk_tpu_torch.curves.family import bn254a
        curve = bn254a()
    fr = curve.fr
    g1_grp, g2_grp = curve.g1, curve.g2
    mark = _marker(mesh, stage_seconds)

    rng = random.Random(seed)
    t, alpha, beta, gamma, delta = (rng.randrange(1, fr.p) for _ in range(5))
    inv_gamma = pow(gamma, -1, fr.p)
    inv_delta = pow(delta, -1, fr.p)
    nc, ni, m = sr.num_constraints, sr.num_inputs, sr.num_variables
    d = mesh.size
    n = 1 << (nc + ni - 1).bit_length()
    # one padded length for the variable and the H vectors: every query
    # has the same rows (zero scalars encode the identity)
    pad = max(sharded_pad(m, d), sharded_pad(n + 1, d))

    at, bt, ct, ht, zt = distributed_qap_instance(
        mesh, fr, sr, t, n, m_pad=pad, h_pad=pad)
    mark("qap-instance")

    def cmul(xs, k: int):
        return [fp.mont_mul(fr, x, ntt._elem(fr, k, x.device)[:, None])
                for x in xs]

    def add(xs, ys):
        return [fp.add(fr, x, y) for x, y in zip(xs, ys)]

    abc = add(add(cmul(at, beta), cmul(bt, alpha)), ct)
    # gamma^-1 on the primary prefix, delta^-1 on the rest
    filtered_abc = [
        fp.select(_global_index(x, i) < ni, g, dl)
        for i, (x, g, dl) in enumerate(zip(abc, cmul(abc, inv_gamma),
                                           cmul(abc, inv_delta)))]
    ht_scaled = cmul(ht, zt * inv_delta % fr.p)
    raw = lambda xs: [fp.from_mont(fr, x) for x in xs]
    mark("scalars")

    g1_gen = g1_grp.host.mul(g1_grp.generator_affine, rng.randrange(1, fr.p))
    g2_gen = g2_grp.host.mul(g2_grp.generator_affine, rng.randrange(1, fr.p))
    dev0 = mesh.devices[0]
    g1_dev = pmesh.replicate_point(mesh, g1_grp.point_to_device(g1_gen, dev0))
    g2_dev = pmesh.replicate_point(mesh, g2_grp.point_to_device(g2_gen, dev0))
    tables = {g1_grp.name: {}, g2_grp.name: {}}   # one per base and device

    def enc(group, gen, scalars, label):
        pts = dmsm.distributed_fixed_base_msm(
            mesh, group, gen, raw(scalars), tables=tables[group.name])
        packed = dmsm.distributed_pack(mesh, group, pts)
        mark(label)
        return pts, packed

    _, query_a = enc(g1_grp, g1_dev, at, "enc-A(g1)")
    _, query_b_g1 = enc(g1_grp, g1_dev, bt, "enc-B(g1)")
    _, query_b_g2 = enc(g2_grp, g2_dev, bt, "enc-B(g2)")
    _, query_h = enc(g1_grp, g1_dev, ht_scaled, "enc-H(g1)")
    filtered_pts, delta_abc_g1 = enc(g1_grp, g1_dev, filtered_abc,
                                     "enc-deltaABC(g1)")
    gamma_abc_g1 = _first_points(g1_grp, filtered_pts, ni)

    g1, g2 = g1_grp.host, g2_grp.host
    pk = ProvingKey(
        alpha_g1=g1.mul(g1_gen, alpha), beta_g1=g1.mul(g1_gen, beta),
        beta_g2=g2.mul(g2_gen, beta), delta_g1=g1.mul(g1_gen, delta),
        delta_g2=g2.mul(g2_gen, delta), delta_abc_g1=delta_abc_g1,
        query_a=query_a, query_b_g1=query_b_g1, query_b_g2=query_b_g2,
        query_h=query_h, r1cs=sr, packed=True, delta_abc_full=True)
    vk = VerificationKey(
        alpha_beta_gt=curve.pairing.reduced_pairing(pk.alpha_g1, pk.beta_g2),
        gamma_g2=g2.mul(g2_gen, gamma), delta_g2=pk.delta_g2,
        gamma_abc_g1=gamma_abc_g1)
    mark("host-points+pairing")
    return CRS(proving_key=pk, verification_key=vk)


def _to_host(grp, p):
    return grp.points_to_host(jac._map_coords(p, lambda c: c[..., None]))[0]


def distributed_prove(mesh, pk: ProvingKey, primary, auxiliary,
                      seed: int = 2, curve=None, config=None,
                      stage_seconds=None) -> Proof:
    """A proof from a sharded packed proving key (``distributed_setup`` or
    ``shard_crs``).  ``config.debug`` turns on the sharded satisfiability
    check; ``stage_seconds`` is an optional dict of each stage's wall
    time (the serial prover's stage names)."""
    if not pk.packed:
        raise ValueError("distributed_prove needs a packed sharded key")
    if curve is None:
        from octopuszk_tpu_torch.curves.family import bn254a
        curve = bn254a()
    fr = curve.fr
    g1_grp, g2_grp = curve.g1, curve.g2
    mark = _marker(mesh, stage_seconds)
    rng = random.Random(seed)
    r = rng.randrange(fr.p)
    s = rng.randrange(fr.p)
    sr = pk.r1cs
    nc, ni = sr.num_constraints, sr.num_inputs
    n = 1 << (nc + ni - 1).bit_length()
    # every query has the setup's one padded length
    pad = sum(q.shape[0] for q in pk.query_a)

    z_full = rel.assignment_to_device(fr, list(primary) + list(auxiliary),
                                      mesh.devices[0])
    z = _pad_and_shard(mesh, z_full, pad)
    del z_full
    mark("assignment")
    if config is not None and config.debug:
        assert distributed_is_satisfied(mesh, fr, sr, z), \
            "R1CS not satisfied"
    h = distributed_witness(mesh, fr, sr, n, z)
    h = _pad_and_shard(mesh, pmesh.unshard(h), pad)
    z_raw = [fp.from_mont(fr, x) for x in z]
    h_raw = [fp.from_mont(fr, x) for x in h]
    if pk.delta_abc_full:
        # all m variables: zero the primary scalars
        abc_raw = [torch.where(_global_index(x, i) < ni, 0, x)
                   for i, x in enumerate(z_raw)]
    else:
        # the serial setup's aux-only query: drop the primary prefix
        abc_raw = _pad_and_shard(mesh, pmesh.unshard(z_raw)[:, ni:], pad)
    mark("witness-map")

    def single(grp, query, scalars):
        return _to_host(grp, dmsm.distributed_pippenger_packed(
            mesh, grp, query, scalars))

    eval_a = single(g1_grp, pk.query_a, z_raw)
    mark("msm-A(g1)")
    b1, b2 = dmsm.distributed_pippenger_double_packed(
        mesh, g1_grp, g2_grp, pk.query_b_g1, pk.query_b_g2, z_raw)
    eval_b1, eval_b2 = _to_host(g1_grp, b1), _to_host(g2_grp, b2)
    mark("msm-B(g1+g2)")
    eval_h = single(g1_grp, pk.query_h, h_raw)
    mark("msm-H(g1)")
    eval_abc = single(g1_grp, pk.delta_abc_g1, abc_raw)
    mark("msm-deltaABC(g1)")

    g1, g2 = g1_grp.host, g2_grp.host
    a_pt = g1.add(g1.add(pk.alpha_g1, eval_a), g1.mul(pk.delta_g1, r))
    b1_pt = g1.add(g1.add(pk.beta_g1, eval_b1), g1.mul(pk.delta_g1, s))
    b2_pt = g2.add(g2.add(pk.beta_g2, eval_b2), g2.mul(pk.delta_g2, s))
    c_pt = g1.add(eval_abc, eval_h)
    c_pt = g1.add(c_pt, g1.mul(a_pt, s))
    c_pt = g1.add(c_pt, g1.mul(b1_pt, r))
    c_pt = g1.add(c_pt, g1.neg(g1.mul(pk.delta_g1, r * s % fr.p)))
    mark("host-assembly")
    return Proof(a=a_pt, b=b2_pt, c=c_pt)


# ---------------------------------------------------------------------------
# between the distributed and the serial CRS
# ---------------------------------------------------------------------------

def _unshard_matrix(sm: ShardedMatrix, device) -> SparseMatrix:
    """The shards' terms concatenated (the zero-valued nnz padding kept:
    every consumer adds it as zero)."""
    cat = lambda xs: pmesh.unshard(xs, device=device)
    return SparseMatrix(
        row=cat(sm.row), col=cat(sm.col), val=cat(sm.val),
        row_chunk=cat(sm.row_chunk),
        row_chunk_seg=pmesh.place(sm.row_chunk_seg[0], device),
        col_chunk=cat(sm.col_chunk),
        col_chunk_seg=pmesh.place(sm.col_chunk_seg[0], device),
        num_rows=sm.num_rows, num_cols=sm.num_cols)


def gather_crs(mesh, crs: CRS) -> CRS:
    """A distributed CRS in the serial form, on the first shard's device:
    the packed queries whole, the R1CS a SparseMatrix R1CS.  The serial
    prover proves from it, and ``serialize.save_crs`` writes it."""
    pk = crs.proving_key
    if not pk.packed:
        raise ValueError("gather_crs expects a packed distributed CRS")
    dev = mesh.devices[0]
    sr = pk.r1cs
    r1cs = R1CS(a=_unshard_matrix(sr.a, dev), b=_unshard_matrix(sr.b, dev),
                c=_unshard_matrix(sr.c, dev),
                num_constraints=sr.num_constraints,
                num_inputs=sr.num_inputs, num_variables=sr.num_variables)
    return CRS(proving_key=dataclasses.replace(pk, r1cs=r1cs, **{
        q: pmesh.unshard(getattr(pk, q), axis=0, device=dev)
        for q in QUERIES}), verification_key=crs.verification_key)


def shard_crs(mesh, crs: CRS) -> CRS:
    """A packed serial-form CRS (``setup.setup``, ``serialize.load_crs``)
    sharded over the mesh: every query by rows, the R1CS by terms.  The
    inverse of ``gather_crs`` up to where the tensors lie."""
    pk = crs.proving_key
    if not pk.packed:
        raise ValueError("shard_crs expects a packed CRS")

    def sq(q):
        if q.shape[0] % mesh.size:
            raise ValueError(f"{q.shape[0]} rows do not split over "
                             f"{mesh.size} shards")
        return pmesh.shard_vector(mesh, q, axis=0)

    sr = (pk.r1cs if isinstance(pk.r1cs, ShardedR1CS)
          else shard_r1cs(mesh, pk.r1cs))
    return CRS(proving_key=dataclasses.replace(pk, r1cs=sr, **{
        q: sq(getattr(pk, q)) for q in QUERIES}),
        verification_key=crs.verification_key)
