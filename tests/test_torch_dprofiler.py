"""The profiler's distributed form ``<ndev> <app> <log2>`` in the PyTorch
port: every distributed app of the reference runs through ``main`` on a
mesh of CPU shards at 2^4 and writes the reference's CSV records, with
ndev in the ``devices`` column."""

import csv

import pytest
import torch

from octopuszk_tpu.profiler import profiler as rprofiler

from octopuszk_tpu_torch.profiler import profiler

# The port's CPU path is many small tensor ops.  Several test processes
# share the cores, and torch's intra-op thread pools would oversubscribe
# them (each op many times slower), so each process keeps one thread.
torch.set_num_threads(1)

# the runtime records each app writes (the reference's names), and the
# shards it runs on: four where the app's sizes take them (n >= d^2), two
# for the Groth16 apps (the app circuits' domains are as small as 8)
RECORDS = {
    "fft": (4, ["dist-fft", "dist-ifft"]),
    "lagrange": (4, ["dist-lagrange"]),
    "fmsm-g1": (4, ["dist-fixed-msm-g1"]),
    "fmsm-g2": (4, ["dist-fixed-msm-g2"]),
    "vmsm-g1": (4, ["dist-var-msm-g1"]),
    "vmsm-g2": (2, ["dist-var-msm-g2"]),
    "relation": (4, ["dist-qap-relation"]),
    "witness": (4, ["dist-qap-witness"]),
    "bace": (4, ["dist-bace-prove"]),
    "zksnark": (2, ["dist-setup", "dist-prove"]),
    "zksnark-large": (2, ["dist-setup-bn254b", "dist-prove-bn254b"]),
    "matmul": (2, ["dist-matmul"]),
    "regression": (2, ["dist-regression"]),
    "gaussian": (2, ["dist-gaussian"]),
}


def test_every_distributed_app_is_covered():
    assert sorted(RECORDS) == sorted(profiler.DIST_APPS)
    assert set(profiler.DIST_APPS) == set(rprofiler.DIST_APPS)


def test_an_unknown_distributed_app_returns_1(tmp_path, capsys):
    assert profiler.main(["4", "nope", "4"], device="cpu",
                         events_dir=str(tmp_path)) == 1
    assert "unknown distributed app nope" in capsys.readouterr().out
    assert not list(tmp_path.iterdir())


def test_the_distributed_form_asks_for_the_card(tmp_path):
    with pytest.raises(RuntimeError, match="CUDA"):
        profiler.main(["4", "fft", "4"], events_dir=str(tmp_path))
    assert not list(tmp_path.iterdir())


@pytest.mark.parametrize("app", ["zksnark", "zksnark-large", "matmul",
                                 "regression", "gaussian"])
def test_a_distributed_proof_that_does_not_verify_fails(app, tmp_path,
                                                         monkeypatch):
    """The setup and the prove stand in (a proof that verifies is the
    test above); the verifier says no, and the app raises."""
    import types
    from octopuszk_tpu_torch.models.groth16 import verifier
    from octopuszk_tpu_torch.parallel import dgroth16
    crs = types.SimpleNamespace(proving_key=None, verification_key=None)
    monkeypatch.setattr(dgroth16, "distributed_setup", lambda *a, **k: crs)
    monkeypatch.setattr(dgroth16, "distributed_prove", lambda *a, **k: None)
    monkeypatch.setattr(verifier, "verify", lambda *args, **kw: False)
    with pytest.raises(RuntimeError, match="did not verify"):
        profiler.main(["2", app, "4"], device="cpu",
                      events_dir=str(tmp_path))


@pytest.mark.parametrize("app", list(RECORDS))
def test_distributed_app_runs_and_writes_the_csv(app, tmp_path, capsys):
    ndev, names = RECORDS[app]
    assert profiler.main([str(ndev), app, "4"], device="cpu",
                         events_dir=str(tmp_path)) == 0
    out = capsys.readouterr().out
    assert f"mesh: {ndev} shards on {['cpu'] * ndev}" in out
    with open(tmp_path / f"{app}.csv") as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["app", "size", "devices", "name", "seconds"]
    assert [r[3] for r in rows[1:]] == names
    assert all(r[:3] == [app, "16", str(ndev)] and float(r[4]) > 0
               for r in rows[1:])
    if app in ("zksnark", "zksnark-large"):
        assert "verify ok=True" in out
    if app in ("matmul", "regression", "gaussian"):
        assert f"dist-{app} setup+prove+verify" in out and "ok=True" in out
