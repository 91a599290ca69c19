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
                "octopuszk_tpu_torch.profiler.__main__",
                "octopuszk_tpu_torch.curves.family",
                "octopuszk_tpu_torch.curves.fake",
                "octopuszk_tpu_torch.fields.tower",
                "octopuszk_tpu_torch.fields.host_ext",
                "octopuszk_tpu_torch.parallel.mesh",
                "octopuszk_tpu_torch.parallel.dntt",
                "octopuszk_tpu_torch.parallel.dmsm",
                "octopuszk_tpu_torch.parallel.dgroth16",
                "octopuszk_tpu_torch.parallel.dbace"):
        assert mod in MODULES
    names = {p.name for p in SOURCES}
    assert {"ntt_kernels.cu", "ntt.cuh", "scan_kernels.cu",
            "gather_kernels.cu", "table_kernels.cu", "bucket_kernels.cu",
            "prefix_kernels.cu", "curve.cuh", "chip_smoke.py"} <= names


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
    # BN254b (zksnark-large) asks for the card too
    with pytest.raises(RuntimeError, match="CUDA"):
        profiler.main(["zksnark-large", "4"], events_dir=str(tmp_path))
    # and so does a mesh, and the distributed form
    from octopuszk_tpu_torch.parallel import mesh as pmesh
    with pytest.raises(RuntimeError, match="CUDA"):
        pmesh.make_mesh(4)
    with pytest.raises(RuntimeError, match="CUDA"):
        profiler.main(["4", "zksnark", "4"], events_dir=str(tmp_path))
    assert not list(tmp_path.iterdir())


def test_bn254b_wrappers_launch_or_raise(monkeypatch):
    """A BN254b operand on the card goes to its curve's library: with no
    kernel library to launch from, the wrapper raises and computes
    nothing on the CPU.  (A CPU tensor that reports ``is_cuda`` stands for
    one on the card.)  A field or group that no curve knows raises
    ValueError."""
    import torch
    from octopuszk_tpu_torch.curves.family import bn254b
    from octopuszk_tpu_torch.fields.spec import FieldSpec, FQ_B
    from octopuszk_tpu_torch.ops import kernels

    class OnCard(torch.Tensor):
        @property
        def is_cuda(self):
            return True

    def no_library(curve):
        raise RuntimeError(f"no kernel library for {curve}")

    monkeypatch.setattr(kernels, "lib", no_library)
    a = torch.zeros((8, 4), dtype=torch.int32)
    card = a.as_subclass(OnCard)
    with pytest.raises(RuntimeError, match="library for bn254b"):
        kernels.mont_mul(FQ_B, card, card)
    g = bn254b().g2
    pt = tuple((c0.as_subclass(OnCard), c1.as_subclass(OnCard))
               for c0, c1 in g.infinity((4,), "cpu"))
    with pytest.raises(RuntimeError, match="library for bn254b"):
        kernels.add_points(g.name, pt, pt)
    # on the CPU the plain version runs
    assert torch.equal(kernels.mont_mul(FQ_B, a, a), a)
    with pytest.raises(ValueError, match="no kernel for group"):
        kernels.add_points("bn254c-G1", (a, a, a), (a, a, a))
    with pytest.raises(ValueError, match="no kernel for field"):
        kernels._field_entry(FieldSpec("other", 7, 3, 1, 6), "oz_mont_mul")
