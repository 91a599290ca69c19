"""Run configuration and nested wall-clock instrumentation.

Port of ``octopuszk_tpu/utils/config.py``: the same fields, the nested
section timers (``begin_log`` / ``end_log``), the runtime records
(``begin_runtime`` / ``end_runtime``) and the CSV they are appended to
(``write_runtime_log``, columns ``app,size,devices,name,seconds``).  The
default ``events_dir`` is a directory of its own under the temporary
directory, so rows of the two packages never mix in one file.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Optional


def _default_events_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "octopuszk-torch-events")


@dataclasses.dataclass
class Config:
    num_devices: int = 1
    num_partitions: int = 1
    seed: int = 1
    debug: bool = False
    verbose: bool = True
    events_dir: str = dataclasses.field(default_factory=_default_events_dir)

    def __post_init__(self):
        self._log_stack = []
        self._runtime = {}
        self._records = []

    # -- nested section timers --

    def begin_log(self, message: str):
        if self.verbose:
            indent = "  " * len(self._log_stack)
            print(f"{indent}[begin] {message}", flush=True)
        self._log_stack.append((message, time.perf_counter()))

    def end_log(self, message: str):
        name, t0 = self._log_stack.pop()
        assert name == message, f"mismatched log section: {name} vs {message}"
        dt = time.perf_counter() - t0
        if self.verbose:
            indent = "  " * len(self._log_stack)
            print(f"{indent}[end]   {message}: {dt:.3f}s", flush=True)
        return dt

    # -- runtime CSV records --

    def begin_runtime(self, name: str):
        self._runtime[name] = time.perf_counter()

    def end_runtime(self, name: str, **meta):
        dt = time.perf_counter() - self._runtime.pop(name)
        self._records.append({"name": name, "seconds": dt, **meta})
        return dt

    @staticmethod
    def suggest_partitions(size: int, num_devices: int) -> int:
        """Chunks per device for a problem of ``size`` elements: from 2^25
        up, 8 per device (bounds transient device memory), else one."""
        return 8 * num_devices if size >= (1 << 25) else num_devices

    def write_runtime_log(self, app: str, size: Optional[int] = None):
        """Append the records to ``<events_dir>/<app>.csv`` (header on a new
        file) and clear them.  Returns the file's path."""
        os.makedirs(self.events_dir, exist_ok=True)
        path = os.path.join(self.events_dir, f"{app}.csv")
        new = not os.path.exists(path)
        with open(path, "a") as f:
            if new:
                f.write("app,size,devices,name,seconds\n")
            for r in self._records:
                f.write(f"{app},{size},{self.num_devices},"
                        f"{r['name']},{r['seconds']:.6f}\n")
        self._records.clear()
        return path
