"""profiler/ and utils/config.py of the PyTorch port: every serial app runs
through ``main`` on the CPU and writes the reference's CSV; the scalars
and the Config behave as the reference's."""

import csv
import re

import numpy as np
import pytest
import torch

from octopuszk_tpu.profiler import profiler as rprofiler
from octopuszk_tpu.utils.config import Config as RConfig

from octopuszk_tpu_torch import convert
from octopuszk_tpu_torch.profiler import profiler
from octopuszk_tpu_torch.utils.config import Config

# The port's CPU path is many small tensor ops.  Several test processes
# share the cores, and torch's intra-op thread pools would oversubscribe
# them (each op many times slower), so each process keeps one thread.
torch.set_num_threads(1)

# the runtime records each app writes (the reference's names)
RECORDS = {
    "fft": ["serial-fft", "serial-ifft"],
    "lagrange": ["lagrange"],
    "fmsm-g1": ["fixed-msm-g1"],
    "fmsm-g2": ["fixed-msm-g2"],
    "vmsm-g1": ["var-msm-g1"],
    "vmsm-g2": ["var-msm-g2"],
    "relation": ["qap-relation"],
    "witness": ["qap-witness"],
    "zksnark": ["setup-cold", "setup-warm", "prove", "verify"],
    "zksnark-large": ["setup-bn254b", "prove-bn254b"],
    "bace": ["bace-prove"],
    "matmul": ["matmul-zksnark"],
    "regression": [],
    "gaussian": [],
}


def test_every_serial_app_is_covered():
    assert sorted(RECORDS) == sorted(profiler.APPS)
    assert set(profiler.APPS) == set(rprofiler.APPS)


@pytest.mark.parametrize("seed", [0, 2])
def test_rand_scalars_equal_reference(seed):
    got = profiler._rand_scalars(37, seed, device="cpu")
    np.testing.assert_array_equal(convert.field_to_ref(got),
                                  np.asarray(rprofiler._rand_scalars(37, seed)))


@pytest.mark.parametrize("app", sorted(RECORDS))
def test_app_runs_and_writes_the_csv(app, tmp_path, capsys):
    # zksnark with another input count, through the flag
    argv = [app, "4"] + (["--inputs=2"] if app == "zksnark" else [])
    assert profiler.main(argv, device="cpu", events_dir=str(tmp_path)) == 0
    out = capsys.readouterr().out
    with open(tmp_path / f"{app}.csv") as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["app", "size", "devices", "name", "seconds"]
    assert [r[3] for r in rows[1:]] == RECORDS[app]
    assert all(r[:3] == [app, "16", "1"] and float(r[4]) > 0
               for r in rows[1:])
    if app == "zksnark":
        assert "(inputs=2)" in out and "ok=True" in out
    if app == "zksnark-large":     # Groth16 on BN254b
        assert "verify ok=True" in out


@pytest.mark.parametrize("argv,message", [
    (["nope", "4"], "unknown app nope"),
    (["4", "nope", "4"], "unknown distributed app nope"),
    (["fft", "4", "--bogus"], "unknown flag --bogus"),
    (["fft"], "Args:"),
])
def test_what_does_not_run_returns_1(argv, message, tmp_path, capsys):
    assert profiler.main(argv, device="cpu", events_dir=str(tmp_path)) == 1
    assert message in capsys.readouterr().out
    assert not list(tmp_path.iterdir())


@pytest.mark.parametrize("app", ["matmul", "regression", "gaussian"])
def test_a_proof_that_does_not_verify_fails_the_app(app, tmp_path,
                                                    monkeypatch):
    monkeypatch.setattr(profiler, "_prove_app", lambda *args: False)
    with pytest.raises(RuntimeError, match="did not verify"):
        profiler.main([app, "4"], device="cpu", events_dir=str(tmp_path))


def _drive_config(cls, events_dir):
    """One nested log, two runtime records (one with metadata), a written
    log, and a mismatched end_log."""
    c = cls(events_dir=str(events_dir))
    c.begin_log("outer")
    c.begin_log("inner")
    inner = c.end_log("inner")
    outer = c.end_log("outer")
    assert 0 <= inner <= outer
    c.begin_runtime("a")
    c.begin_runtime("b")
    c.end_runtime("b", extra=1)
    c.end_runtime("a")
    path = c.write_runtime_log("app", 64)
    c.begin_log("x")
    with pytest.raises(AssertionError):
        c.end_log("y")
    with open(path) as f:
        lines = f.read().splitlines()
    return (path.rsplit("/", 1)[1],
            [re.sub(r"[0-9.]+$", "T", s) for s in lines],
            c._records, cls.suggest_partitions(1 << 25, 4),
            cls.suggest_partitions(1 << 24, 4))


def test_config_behaves_as_reference(tmp_path, capsys):
    want = _drive_config(RConfig, tmp_path / "ref")
    ref_out = capsys.readouterr().out
    got = _drive_config(Config, tmp_path / "port")
    mask = lambda s: re.sub(r"[0-9.]+s", "Ts", s)
    assert got == want
    assert mask(capsys.readouterr().out) == mask(ref_out)
    assert Config().events_dir != RConfig().events_dir
