"""Kernel (i) ``row_gather`` of the PyTorch port against the reference's
Pallas row gather (``scripts/gather_experiment.py::_pallas_gather``, in
interpret mode on the CPU), exact; and the port's gather experiment."""

import importlib.util
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from octopuszk_tpu_torch.ops import kernels
from octopuszk_tpu_torch.scripts import gather_experiment

# The port's CPU path is many small tensor ops.  Several test processes
# share the cores, and torch's intra-op thread pools would oversubscribe
# them (each op many times slower), so each process keeps one thread.
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
R, W = 64, 128


@pytest.fixture(scope="module")
def pallas_gather():
    """The reference script, loaded from its file (it is not a package)."""
    spec = importlib.util.spec_from_file_location(
        "reference_gather_experiment", ROOT / "scripts" / "gather_experiment.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod._pallas_gather


def _table(width, rows=R):
    rng = np.random.default_rng(3)
    return rng.integers(0, 1 << 32, size=(rows, width), dtype=np.uint32)


def _gather(table_np, idx_np):
    got = kernels.row_gather(torch.from_numpy(table_np.view(np.int32)),
                             torch.from_numpy(idx_np))
    return got.numpy().view(np.uint32)


@pytest.mark.parametrize("case", ["permutation", "repeating"])
def test_row_gather_equals_pallas_gather(pallas_gather, case):
    """A permutation of the 64 rows (m = R, the experiment's shape) and a
    32-row index that repeats rows."""
    rng = np.random.default_rng(5)
    if case == "permutation":
        idx = rng.permutation(R).astype(np.int32)
    else:
        idx = rng.integers(0, 8, size=32).astype(np.int32)
        assert len(set(idx.tolist())) < len(idx)
    table = _table(W)
    want = np.asarray(pallas_gather(len(idx))(jnp.asarray(idx),
                                              jnp.asarray(table)))
    np.testing.assert_array_equal(want, table[idx])
    np.testing.assert_array_equal(_gather(table, idx), want)


@pytest.mark.parametrize("width", [16, 32])
def test_row_gather_packed_point_rows(width):
    """The port's own packed rows: one G1 (16 words) or G2 (32) point."""
    table = _table(width, rows=50)
    idx = np.random.default_rng(6).integers(0, 50, size=77).astype(np.int32)
    np.testing.assert_array_equal(_gather(table, idx), table[idx])


def test_row_gather_refuses_bad_operands():
    table = torch.zeros((8, 16), dtype=torch.int32)
    idx = torch.arange(4, dtype=torch.int32)
    with pytest.raises(TypeError, match="multiple of 4"):
        kernels.row_gather(torch.zeros((8, 6), dtype=torch.int32), idx)
    with pytest.raises(TypeError):
        kernels.row_gather(table.to(torch.int64), idx)
    with pytest.raises(TypeError):
        kernels.row_gather(table, idx.to(torch.int64))
    with pytest.raises(TypeError):
        kernels.row_gather(table.T, idx)            # not contiguous
    for bad in (8, -1):
        with pytest.raises(IndexError):
            kernels.row_gather(table, torch.tensor([0, bad], dtype=torch.int32))
    assert kernels.LAUNCHES["row_gather"] == 0      # CPU tensors: no launch


def test_gather_experiment_needs_the_card():
    with pytest.raises(RuntimeError, match="CUDA"):
        gather_experiment.main(4)
