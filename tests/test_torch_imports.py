"""The PyTorch port stands alone: every module imports without CUDA, and
nothing in it imports JAX or the JAX package."""

import importlib
import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "octopuszk_tpu_torch"

MODULES = sorted(
    ".".join(p.relative_to(ROOT).with_suffix("").parts)
    for p in PKG.rglob("*.py") if p.name != "__init__.py")
SOURCES = sorted(PKG.rglob("*.py")) + sorted(PKG.rglob("*.cu*")) + [
    ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("mod", MODULES)
def test_module_imports(mod):
    importlib.import_module(mod)


def test_importing_the_port_loads_no_jax():
    code = (
        "import importlib, sys\n"
        f"mods = {MODULES!r}\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'jaxlib' or m == 'octopuszk_tpu'"
        " or m.startswith('octopuszk_tpu.')]\n"
        "assert not bad, bad\n"
        "import torch\n"
        "assert not torch.cuda.is_available()\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_source_names_no_jax(path):
    text = path.read_text()
    assert not re.search(r"^\s*(import|from)\s+jax\b", text, re.M)
    assert not re.search(r"\boctopuszk_tpu\.", text)
    assert not re.search(r"^\s*(import|from)\s+octopuszk_tpu\b(?!_torch)",
                         text, re.M)


def test_every_module_and_source_is_covered():
    """The lists above are globbed; these are the modules and kernel
    sources the checks must not lose."""
    for mod in ("octopuszk_tpu_torch.models.groth16.serialize",
                "octopuszk_tpu_torch.models.groth16.prover",
                "octopuszk_tpu_torch.ops.msm", "octopuszk_tpu_torch.convert",
                "octopuszk_tpu_torch.utils.config",
                "octopuszk_tpu_torch.ops.poly",
                "octopuszk_tpu_torch.models.bace.circuit",
                "octopuszk_tpu_torch.models.bace.prover",
                "octopuszk_tpu_torch.models.bace.verifier",
                "octopuszk_tpu_torch.relations.apps",
                "octopuszk_tpu_torch.scripts.gather_experiment",
                "octopuszk_tpu_torch.profiler.profiler",
                "octopuszk_tpu_torch.profiler.__main__"):
        assert mod in MODULES
    names = {p.name for p in SOURCES}
    assert {"ntt_kernels.cu", "ntt.cuh", "scan_kernels.cu",
            "gather_kernels.cu", "table_kernels.cu", "bucket_kernels.cu",
            "prefix_kernels.cu", "chip_smoke.py"} <= names


def test_entry_points_default_to_the_card(tmp_path):
    """Asked for the card (device=None) with none present, the entry
    points raise instead of running on the CPU."""
    from octopuszk_tpu_torch.models.groth16 import serialize
    from octopuszk_tpu_torch.profiler import profiler
    from octopuszk_tpu_torch.relations import apps, construct
    from octopuszk_tpu_torch.scripts import gather_experiment
    with pytest.raises(RuntimeError, match="CUDA"):
        construct.serial_construct(6, 3)
    with pytest.raises(RuntimeError, match="CUDA"):
        serialize.load_crs(str(tmp_path / "absent.npz"))
    with pytest.raises(RuntimeError, match="CUDA"):
        apps.matmul_construct(1, 1, 1)
    with pytest.raises(RuntimeError, match="CUDA"):
        profiler.main(["fft", "4"], events_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA"):
        profiler._rand_scalars(4)
    # the gather experiment is row_gather's one caller
    with pytest.raises(RuntimeError, match="CUDA"):
        gather_experiment.main(4)
    assert not list(tmp_path.iterdir())
