"""Profiler CLI: per-kernel and end-to-end size sweeps on the card.

Port of ``octopuszk_tpu/profiler/profiler.py``: serial
``python -m octopuszk_tpu_torch.profiler <app> <log2size> [--inputs=N]``
and distributed ``python -m octopuszk_tpu_torch.profiler <ndev> <app>
<log2size>`` over a mesh of ndev shards (parallel/mesh.py: shard i on card
i % the cards present, so several shards may share one card).  The app
names, the workloads (the same seeds and draws as the reference) and the
printed lines are the reference's: fft, lagrange, fmsm-g1, fmsm-g2,
vmsm-g1, vmsm-g2, relation, witness, zksnark, zksnark-large (Groth16 on
the second curve, BN254b), bace, matmul, regression, gaussian, in both
forms.  Each app's timings are appended to ``<events_dir>/<app>.csv``
(utils/config.py; the ``devices`` column carries ndev).
"""

from __future__ import annotations

import math
import sys

import numpy as np
import torch

from octopuszk_tpu_torch.utils import device as _device
from octopuszk_tpu_torch.utils.config import Config


def _rand_scalars(n, seed=0, device=None):
    """n scalars below 2^253 as int32[8, n] words: the reference's draw of
    sixteen 16-bit limbs per scalar (the top one cut to 13 bits), joined
    pairwise into words, so a seed gives the same scalars."""
    rng = np.random.default_rng(seed)
    limbs = rng.integers(0, 1 << 16, size=(16, n), dtype=np.uint32)
    limbs[15] &= (1 << 13) - 1
    words = limbs[0::2] | (limbs[1::2] << np.uint32(16))
    return torch.from_numpy(np.ascontiguousarray(words).view(np.int32)).to(
        _device.resolve(device))


def _rand_packed(group, n, device, seed=1, chunk_log=22):
    """n pseudo-random points as packed rows, generated in chunks of at
    most 2^chunk_log (bounds the fixed-base batch's temporaries)."""
    from octopuszk_tpu_torch.ops import msm
    gen = group.point_to_device(group.generator_affine, device)
    chunk = min(n, 1 << chunk_log)
    packs = []
    for i in range(-(-n // chunk)):
        pts = msm.fixed_base_msm(group, gen,
                                 _rand_scalars(chunk, seed + i, device))
        packs.append(msm.points_to_packed(group, pts, pad_to=chunk))
    return torch.cat(packs, dim=0) if len(packs) > 1 else packs[0]


def _force(where):
    """Wait for the queued work of a device, or of every card of a mesh (a
    no-op on the CPU)."""
    for device in set(getattr(where, "devices", (where,))):
        if device.type == "cuda":
            torch.cuda.synchronize(device)


def _timed(config, name, fn, size, where):
    """``where``: the app's device, or its mesh."""
    fn()                    # warm-up
    _force(where)
    config.begin_runtime(name)
    fn()
    _force(where)
    dt = config.end_runtime(name)
    print(f"{name} size=2^{size.bit_length()-1}: {dt:.4f}s", flush=True)
    return dt


def profile_fft(config, n, device):
    from octopuszk_tpu_torch.fields.spec import FR
    from octopuszk_tpu_torch.ops import ntt
    x = _rand_scalars(n, device=device)
    _timed(config, "serial-fft", lambda: ntt.ntt(FR, x), n, device)
    _timed(config, "serial-ifft", lambda: ntt.intt(FR, x), n, device)


def profile_lagrange(config, n, device):
    from octopuszk_tpu_torch.fields.spec import FR
    from octopuszk_tpu_torch.ops import ntt
    t = ntt._elem(FR, 12345678, device)
    _timed(config, "lagrange", lambda: ntt.lagrange_coeffs(FR, n, t), n,
           device)


def _group(which):
    from octopuszk_tpu_torch.curves import bn254
    return bn254.G1 if which == "g1" else bn254.G2


def profile_fmsm(config, n, device, which):
    from octopuszk_tpu_torch.ops import msm
    grp = _group(which)
    base = grp.point_to_device(grp.generator_affine, device)
    s = _rand_scalars(n, device=device)
    _timed(config, f"fixed-msm-{which}",
           lambda: msm.fixed_base_msm(grp, base, s), n, device)


def profile_vmsm(config, n, device, which):
    from octopuszk_tpu_torch.ops import msm
    grp = _group(which)
    s = _rand_scalars(n, seed=2, device=device)
    # the packed-row base (the CRS's at-rest layout) through the
    # signed-digit Pippenger with the mixed-add scans
    packed = _rand_packed(grp, msm._msm_pad_to(grp, n, None, 22), device)
    dt = _timed(config, f"var-msm-{which}",
                lambda: msm.pippenger_msm_packed(grp, packed, s), n, device)
    print(f"throughput: {n / dt:.0f} points/s", flush=True)


def profile_relation(config, n, device):
    from octopuszk_tpu_torch.fields.spec import FR
    from octopuszk_tpu_torch.reductions.r1cs_to_qap import qap_instance
    from octopuszk_tpu_torch.relations import construct
    r1cs, _, _ = construct.serial_construct(n - 3, 3, device=device)
    _timed(config, "qap-relation",
           lambda: qap_instance(FR, r1cs, 987654321), n, device)


def profile_witness(config, n, device):
    from octopuszk_tpu_torch.fields.spec import FR
    from octopuszk_tpu_torch.reductions.r1cs_to_qap import (
        domain_size, qap_witness)
    from octopuszk_tpu_torch.relations import construct
    from octopuszk_tpu_torch.relations.r1cs import assignment_to_device
    r1cs, primary, aux = construct.serial_construct(n - 3, 3, device=device)
    z = assignment_to_device(FR, primary + aux, device)
    dom = domain_size(r1cs)
    _timed(config, "qap-witness",
           lambda: qap_witness(FR, r1cs, dom, z), n, device)


# the zksnark app's default input count; ``--inputs=N`` sets another for
# one run (the reference CI's configuration is numInputs=1023,
# SerialzkSNARKTest.java:141-150: ``zksnark 20 --inputs=1023``)
ZKSNARK_INPUTS = 3


def profile_zksnark(config, n, device, inputs=ZKSNARK_INPUTS):
    from octopuszk_tpu_torch.models.groth16 import prover, setup, verifier
    from octopuszk_tpu_torch.relations import construct
    r1cs, primary, aux = construct.serial_construct(n - inputs, inputs,
                                                    device=device)
    # the first setup includes the card's warm-up, the second (same shapes,
    # another seed) only compute
    config.begin_runtime("setup-cold")
    crs = setup.setup(r1cs, seed=config.seed)
    _force(device)
    cold = config.end_runtime("setup-cold")
    config.begin_runtime("setup-warm")
    crs = setup.setup(r1cs, seed=config.seed + 1)
    _force(device)
    warm = config.end_runtime("setup-warm")
    print(f"setup: cold {cold:.3f}s | warm {warm:.3f}s "
          f"(inputs={inputs})", flush=True)
    prover.prove(crs.proving_key, primary, aux)  # warm-up
    config.begin_runtime("prove")
    proof = prover.prove(crs.proving_key, primary, aux)
    print(f"prove: {config.end_runtime('prove'):.3f}s", flush=True)
    config.begin_runtime("verify")
    ok = verifier.verify(crs.verification_key, primary, proof)
    print(f"verify: {config.end_runtime('verify'):.3f}s ok={ok}", flush=True)
    _require(ok, "zksnark")


def profile_zksnark_large(config, n, device):
    """Groth16 end to end on the second curve family, BN254b: the
    reference's ``zksnark-large`` app (its Profiler.java dispatches the
    same pipeline over the bn254b package)."""
    from octopuszk_tpu_torch.curves.family import bn254b
    from octopuszk_tpu_torch.models.groth16 import prover, setup, verifier
    from octopuszk_tpu_torch.relations import construct
    curve = bn254b()
    r1cs, primary, aux = construct.serial_construct(n - 3, 3, spec=curve.fr,
                                                    device=device)
    config.begin_runtime("setup-bn254b")
    crs = setup.setup(r1cs, seed=config.seed, curve=curve)
    _force(device)
    print(f"setup: {config.end_runtime('setup-bn254b'):.3f}s", flush=True)
    prover.prove(crs.proving_key, primary, aux, curve=curve)  # warm-up
    config.begin_runtime("prove-bn254b")
    proof = prover.prove(crs.proving_key, primary, aux, curve=curve)
    _force(device)
    print(f"prove: {config.end_runtime('prove-bn254b'):.3f}s", flush=True)
    ok = verifier.verify(crs.verification_key, primary, proof, curve=curve)
    print(f"verify ok={ok}", flush=True)
    _require(ok, "zksnark-large")


def bace_circuit():
    """The bace app's circuit: (x0 + x1) * x0."""
    from octopuszk_tpu_torch.models.bace.circuit import (
        Circuit, InputGate, ProductGate, SumGate)
    return Circuit(2, ProductGate(SumGate(InputGate(0), InputGate(1)),
                                  InputGate(0)))


def profile_bace(config, n, device):
    from octopuszk_tpu_torch.fields.spec import FR
    from octopuszk_tpu_torch.models.bace import prover as bprover
    c = bace_circuit()
    inputs = _rand_scalars(2 * n, device=device)
    _timed(config, "bace-prove",
           lambda: bprover.compute_proof(FR, c, inputs, n), n, device)


def _require(ok, app):
    """A proof that does not verify fails the app (an error, not an
    assertion: it must hold under ``python -O`` too)."""
    if not ok:
        raise RuntimeError(f"{app}: the proof did not verify")


def _prove_app(r1cs, primary, aux):
    """setup -> prove -> verify with the default seeds; returns ok."""
    from octopuszk_tpu_torch.models.groth16 import prover, setup, verifier
    crs = setup.setup(r1cs)
    proof = prover.prove(crs.proving_key, primary, aux)
    return verifier.verify(crs.verification_key, primary, proof)


def profile_matmul(config, n, device):
    """C = A @ B proof: dims chosen so that constraints ~= n."""
    from octopuszk_tpu_torch.relations import apps
    dim = max(1, round(math.pow(n / 2, 1 / 3)))
    r1cs, primary, aux = apps.matmul_construct(dim, dim, dim, device=device)
    print(f"matmul {dim}^3: {r1cs.num_constraints} constraints", flush=True)
    config.begin_runtime("matmul-zksnark")
    ok = _prove_app(r1cs, primary, aux)
    dt = config.end_runtime("matmul-zksnark")
    print(f"matmul setup+prove+verify: {dt:.3f}s ok={ok}", flush=True)
    _require(ok, "matmul")


def profile_lr(config, n, device):
    from octopuszk_tpu_torch.relations import apps
    d = max(1, n.bit_length() - 1)
    rows = max(1, n // (d + 2))
    r1cs, primary, aux = apps.lr_construct(rows, d, device=device)
    print(f"lr {rows}x{d}: {r1cs.num_constraints} constraints", flush=True)
    _require(_prove_app(r1cs, primary, aux), "regression")


def profile_gaussian(config, n, device):
    from octopuszk_tpu_torch.relations import apps
    d = max(1, n.bit_length() // 2)
    rows = max(1, n // (d * d))
    r1cs, primary, aux = apps.gaussian_construct(rows, d, device=device)
    print(f"gaussian {rows}x{d}: {r1cs.num_constraints} constraints",
          flush=True)
    _require(_prove_app(r1cs, primary, aux), "gaussian")


APPS = {
    "fft": profile_fft,
    "lagrange": profile_lagrange,
    "fmsm-g1": lambda c, n, d: profile_fmsm(c, n, d, "g1"),
    "fmsm-g2": lambda c, n, d: profile_fmsm(c, n, d, "g2"),
    "vmsm-g1": lambda c, n, d: profile_vmsm(c, n, d, "g1"),
    "vmsm-g2": lambda c, n, d: profile_vmsm(c, n, d, "g2"),
    "relation": profile_relation,
    "witness": profile_witness,
    "zksnark": profile_zksnark,
    "zksnark-large": profile_zksnark_large,
    "bace": profile_bace,
    "matmul": profile_matmul,
    "regression": profile_lr,
    "gaussian": profile_gaussian,
}

# ---------------------------------------------------------------------------
# the distributed apps: the reference's over a mesh of shards
# ---------------------------------------------------------------------------

def _dev0(mesh):
    """The first shard's device, where an app's inputs are made."""
    return mesh.devices[0]


def dprofile_fft(config, mesh, n):
    from octopuszk_tpu_torch.fields.spec import FR
    from octopuszk_tpu_torch.parallel import dntt, mesh as pmesh
    x = pmesh.shard_vector(mesh, _rand_scalars(n, device=_dev0(mesh)))
    _timed(config, "dist-fft",
            lambda: dntt.distributed_ntt(mesh, FR, x), n, mesh)
    _timed(config, "dist-ifft",
            lambda: dntt.distributed_ntt(mesh, FR, x, inverse=True), n, mesh)


def dprofile_lagrange(config, mesh, n):
    from octopuszk_tpu_torch.fields.spec import FR
    from octopuszk_tpu_torch.parallel import dgroth16
    _timed(config, "dist-lagrange",
            lambda: dgroth16.distributed_lagrange(mesh, FR, n, 12345678), n,
            mesh)


def dprofile_fmsm(config, mesh, n, which):
    from octopuszk_tpu_torch.parallel import dmsm, mesh as pmesh
    grp = _group(which)
    base = pmesh.replicate_point(
        mesh, grp.point_to_device(grp.generator_affine, _dev0(mesh)))
    s = pmesh.shard_vector(mesh, _rand_scalars(n, device=_dev0(mesh)))
    _timed(config, f"dist-fixed-msm-{which}",
            lambda: dmsm.distributed_fixed_base_msm(mesh, grp, base, s), n,
            mesh)


def _rand_points(group, n, device, seed=1):
    """n pseudo-random projective points: [s_i] G for the seed's
    scalars."""
    from octopuszk_tpu_torch.ops import msm
    return msm.fixed_base_msm(
        group, group.point_to_device(group.generator_affine, device),
        _rand_scalars(n, seed, device))


def dprofile_vmsm(config, mesh, n, which):
    from octopuszk_tpu_torch.parallel import dmsm, mesh as pmesh
    grp = _group(which)
    pts = pmesh.shard_point_batch(mesh, _rand_points(grp, n, _dev0(mesh)))
    s = pmesh.shard_vector(mesh, _rand_scalars(n, seed=2,
                                               device=_dev0(mesh)))
    dt = _timed(config, f"dist-var-msm-{which}",
                 lambda: dmsm.distributed_pippenger(mesh, grp, pts, s), n,
                 mesh)
    print(f"throughput: {n / dt:.0f} points/s", flush=True)


def dprofile_witness(config, mesh, n):
    from octopuszk_tpu_torch.fields.spec import FR
    from octopuszk_tpu_torch.parallel import dgroth16, mesh as pmesh
    from octopuszk_tpu_torch.reductions.r1cs_to_qap import domain_size
    from octopuszk_tpu_torch.relations import construct
    from octopuszk_tpu_torch.relations.r1cs import assignment_to_device
    r1cs, primary, aux = construct.serial_construct(n - 3, 3,
                                                    device=_dev0(mesh))
    sr = dgroth16.shard_r1cs(mesh, r1cs)
    dom = domain_size(r1cs)
    full = primary + aux
    m_pad = len(full) + (-len(full)) % mesh.size
    z = pmesh.shard_vector(mesh, assignment_to_device(
        FR, full + [0] * (m_pad - len(full)), _dev0(mesh)))
    _timed(config, "dist-qap-witness",
            lambda: dgroth16.distributed_witness(mesh, FR, sr, dom, z), n,
            mesh)


def _dgroth16(config, mesh, r1cs, primary, aux, names, curve=None,
              warm=False):
    """Distributed setup, (a warm-up prove,) a timed prove and verify;
    ``names``: the setup's and the prove's runtime records."""
    from octopuszk_tpu_torch.models.groth16 import verifier
    from octopuszk_tpu_torch.parallel import dgroth16
    sr = dgroth16.shard_r1cs(mesh, r1cs)
    config.begin_runtime(names[0])
    crs = dgroth16.distributed_setup(mesh, sr, seed=config.seed, curve=curve)
    _force(mesh)
    print(f"setup: {config.end_runtime(names[0]):.3f}s", flush=True)
    if warm:
        dgroth16.distributed_prove(mesh, crs.proving_key, primary, aux,
                                   curve=curve)
    config.begin_runtime(names[1])
    proof = dgroth16.distributed_prove(mesh, crs.proving_key, primary, aux,
                                       curve=curve)
    _force(mesh)
    print(f"prove: {config.end_runtime(names[1]):.3f}s", flush=True)
    ok = verifier.verify(crs.verification_key, primary, proof, curve=curve)
    print(f"verify ok={ok}", flush=True)
    return ok


def dprofile_zksnark(config, mesh, n):
    from octopuszk_tpu_torch.relations import construct
    r1cs, primary, aux = construct.serial_construct(n - 3, 3,
                                                    device=_dev0(mesh))
    _require(_dgroth16(config, mesh, r1cs, primary, aux,
                       ("dist-setup", "dist-prove"), warm=True), "zksnark")


def dprofile_relation(config, mesh, n):
    from octopuszk_tpu_torch.fields.spec import FR
    from octopuszk_tpu_torch.parallel import dgroth16
    from octopuszk_tpu_torch.relations import construct
    r1cs, _, _ = construct.serial_construct(n - 3, 3, device=_dev0(mesh))
    sr = dgroth16.shard_r1cs(mesh, r1cs)
    _timed(config, "dist-qap-relation",
            lambda: dgroth16.distributed_qap_instance(
                mesh, FR, sr, 987654321, n), n, mesh)


def dprofile_zksnark_large(config, mesh, n):
    """Distributed Groth16 on the second curve family, BN254b."""
    from octopuszk_tpu_torch.curves.family import bn254b
    from octopuszk_tpu_torch.relations import construct
    curve = bn254b()
    r1cs, primary, aux = construct.serial_construct(
        n - 3, 3, spec=curve.fr, device=_dev0(mesh))
    _require(_dgroth16(config, mesh, r1cs, primary, aux,
                       ("dist-setup-bn254b", "dist-prove-bn254b"),
                       curve=curve), "zksnark-large")


def _dprove_app(config, mesh, r1cs, primary, aux, name):
    """Distributed setup -> prove -> verify with the config's seed, as one
    runtime record."""
    from octopuszk_tpu_torch.models.groth16 import verifier
    from octopuszk_tpu_torch.parallel import dgroth16
    sr = dgroth16.shard_r1cs(mesh, r1cs)
    config.begin_runtime(name)
    crs = dgroth16.distributed_setup(mesh, sr, seed=config.seed)
    proof = dgroth16.distributed_prove(mesh, crs.proving_key, primary, aux)
    ok = verifier.verify(crs.verification_key, primary, proof)
    dt = config.end_runtime(name)
    print(f"{name} setup+prove+verify: {dt:.3f}s ok={ok}", flush=True)
    _require(ok, name)


def dprofile_matmul(config, mesh, n):
    from octopuszk_tpu_torch.relations import apps
    dim = max(2, round(math.pow(n / 2, 1 / 3)))
    r1cs, primary, aux = apps.matmul_construct(dim, dim, dim,
                                               device=_dev0(mesh))
    print(f"matmul {dim}^3: {r1cs.num_constraints} constraints", flush=True)
    _dprove_app(config, mesh, r1cs, primary, aux, "dist-matmul")


def dprofile_lr(config, mesh, n):
    from octopuszk_tpu_torch.relations import apps
    d = max(2, n.bit_length() - 1)
    rows = max(2, n // (d + 2))
    r1cs, primary, aux = apps.lr_construct(rows, d, device=_dev0(mesh))
    print(f"lr {rows}x{d}: {r1cs.num_constraints} constraints", flush=True)
    _dprove_app(config, mesh, r1cs, primary, aux, "dist-regression")


def dprofile_gaussian(config, mesh, n):
    from octopuszk_tpu_torch.relations import apps
    d = max(2, n.bit_length() // 2)
    rows = max(2, n // (d * d))
    r1cs, primary, aux = apps.gaussian_construct(rows, d, device=_dev0(mesh))
    print(f"gaussian {rows}x{d}: {r1cs.num_constraints} constraints",
          flush=True)
    _dprove_app(config, mesh, r1cs, primary, aux, "dist-gaussian")


def dprofile_bace(config, mesh, n):
    from octopuszk_tpu_torch.fields.spec import FR
    from octopuszk_tpu_torch.parallel import dbace
    c = bace_circuit()
    inputs = _rand_scalars(2 * n, device=_dev0(mesh))
    _timed(config, "dist-bace-prove",
            lambda: dbace.distributed_compute_proof(mesh, FR, c, inputs, n),
            n, mesh)


DIST_APPS = {
    "fft": dprofile_fft,
    "lagrange": dprofile_lagrange,
    "fmsm-g1": lambda c, m, n: dprofile_fmsm(c, m, n, "g1"),
    "fmsm-g2": lambda c, m, n: dprofile_fmsm(c, m, n, "g2"),
    "vmsm-g1": lambda c, m, n: dprofile_vmsm(c, m, n, "g1"),
    "vmsm-g2": lambda c, m, n: dprofile_vmsm(c, m, n, "g2"),
    "relation": dprofile_relation,
    "witness": dprofile_witness,
    "zksnark": dprofile_zksnark,
    "zksnark-large": dprofile_zksnark_large,
    "bace": dprofile_bace,
    "matmul": dprofile_matmul,
    "regression": dprofile_lr,
    "gaussian": dprofile_gaussian,
}


def main(argv=None, device=None, events_dir=None):
    """Run one app, serial (``<app> <log2>``) or distributed (``<ndev>
    <app> <log2>``); returns the exit code.  ``device``: None is the card
    (raises without one; a mesh's shards go round the cards present);
    ``events_dir``: where the CSV goes (default Config's)."""
    argv = list(argv) if argv is not None else sys.argv[1:]
    inputs = ZKSNARK_INPUTS
    for fl in [a for a in argv if a.startswith("--")]:
        if fl.startswith("--inputs="):
            inputs = int(fl.split("=", 1)[1])
        else:
            print(f"unknown flag {fl}")
            return 1
    argv = [a for a in argv if not a.startswith("--")]
    events = {} if events_dir is None else {"events_dir": events_dir}
    if len(argv) == 2:
        app, log2 = argv[0].lower(), int(argv[1])
        if app not in APPS:
            print(f"unknown app {app}; apps: {', '.join(APPS)}")
            return 1
        dev = _device.resolve(device)
        config = Config(**events)
        n = 1 << log2
        if app == "zksnark":
            profile_zksnark(config, n, dev, inputs)
        else:
            APPS[app](config, n, dev)
    elif len(argv) == 3:
        from octopuszk_tpu_torch.parallel import mesh as pmesh
        ndev, app, log2 = int(argv[0]), argv[1].lower(), int(argv[2])
        if app not in DIST_APPS:
            print(f"unknown distributed app {app}; "
                  f"apps: {', '.join(DIST_APPS)}")
            return 1
        mesh = pmesh.make_mesh(ndev, device)
        print(f"mesh: {ndev} shards on {[str(d) for d in mesh.devices]}",
              flush=True)
        config = Config(num_devices=ndev, num_partitions=ndev, **events)
        n = 1 << log2
        DIST_APPS[app](config, mesh, n)
    else:
        print("Args: [numDevices] {app} {size (log2)} [--inputs=N]  "
              f"serial apps: {', '.join(APPS)}  "
              f"distributed apps: {', '.join(DIST_APPS)}")
        return 1
    config.write_runtime_log(app, n)
    return 0
