"""Row-gather microbenchmark: the framework's gather against the CUDA kernel.

Port of ``scripts/gather_experiment.py``.  A packed MSM's window shuffle
is a random row gather from a table of rows; this measures, on the same
data as the reference (``np.random.default_rng(3)``: a table of R rows of
128 random words and a random permutation of the rows, m = R gathered):

  1. ``torch_index_select``: ``torch.index_select(table, 0, idx)``, the
     framework's own gather (the reference's ``xla_row_gather``);
  2. ``cuda_row_gather``: kernel (i), ``ops/kernels.py::row_gather``, whose
     threads read their row indices themselves (the reference's
     ``pallas_prefetch_gather``).  Its output is checked against the index
     before it is timed.

Usage: python -m octopuszk_tpu_torch.scripts.gather_experiment [log2_rows]
(default 21).  Prints one JSON line per measurement (``metric``,
``log2_rows``, ``seconds``, ``GBps``).  It needs the card and raises
without one.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

from octopuszk_tpu_torch.ops import kernels
from octopuszk_tpu_torch.utils import device as _device

WIDTH = 128     # words per row, as the reference's packed rows


def _bench(fn, dev, iters: int = 10) -> float:
    """Seconds per call: one warm-up call, then ``iters`` calls between two
    synchronisations."""
    fn()
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize(dev)
    return (time.perf_counter() - t0) / iters


def _line(metric: str, log2r: int, dt: float, bytes_moved: int) -> None:
    print(json.dumps({"metric": metric, "log2_rows": log2r,
                      "seconds": round(dt, 5),
                      "GBps": round(bytes_moved / dt / 1e9, 2)}), flush=True)


def main(log2r: int = 21) -> None:
    dev = _device.resolve(None)             # the card; raises without one
    R = 1 << log2r
    m = R               # gather as many rows as the table holds
    rng = np.random.default_rng(3)
    table_np = rng.integers(0, 1 << 32, size=(R, WIDTH), dtype=np.uint32)
    idx_np = rng.permutation(R).astype(np.int32)
    table = torch.from_numpy(table_np.view(np.int32)).to(dev)
    idx = torch.from_numpy(idx_np).to(dev)
    bytes_moved = m * WIDTH * 4

    idx_long = idx.long()
    dt = _bench(lambda: torch.index_select(table, 0, idx_long), dev)
    _line("torch_index_select", log2r, dt, bytes_moved)

    got = kernels.row_gather(table, idx).cpu().numpy().view(np.uint32)
    if not np.array_equal(got, table_np[idx_np]):
        raise AssertionError("row_gather differs from table[idx]")
    dt = _bench(lambda: kernels.row_gather(table, idx), dev)
    _line("cuda_row_gather", log2r, dt, bytes_moved)


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 21)
