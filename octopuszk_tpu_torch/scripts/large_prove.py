"""One Groth16 proof at 2^log2 constraints on the card (BN254a, packed keys
resident on the card, 3 public inputs), stage by stage, with the device
memory at each stage: ``serial_construct(2^log2 - 3, 3, seed=5)``,
``setup(seed=6)``, ``prove(seed=7)`` (the seeds of ``chip_smoke.py``'s
packed path), ``verify``, and the same proof against a tampered public
input, which must be rejected.

Prints one JSON line: seconds per stage (``setup_seconds`` and
``prove_seconds`` as ``setup`` and ``prove`` fill them), ``stage_bytes``
(bytes allocated and the running peak at each mark, the peak counted from
the start of the run), the run's peak (``torch.cuda.max_memory_allocated``),
the fixed-base (g) launches of setup and the chunks a query, a sha256 of
the proof's words, and the card's name and power limit as ``nvidia-smi``
gives them.

    python -m octopuszk_tpu_torch.scripts.large_prove [log2]      # default 24

Needs the card and raises without one; exits 1 if the proof does not
verify or the tampered input is accepted.
"""

from __future__ import annotations

import hashlib
import json
import subprocess
import sys
import time

import torch

from octopuszk_tpu_torch.fields.spec import FR
from octopuszk_tpu_torch.models.groth16 import prover, setup, verifier
from octopuszk_tpu_torch.ops import kernels
from octopuszk_tpu_torch.relations import construct
from octopuszk_tpu_torch.utils import device as _device

NUM_INPUTS = 3
# setup encodes five queries in chunks and gammaABC's public entries in
# one launch of (g)
CHUNKED_QUERIES = 5


def run(log2: int = 24, device=None) -> dict:
    """Construct, set up, prove and verify at 2^log2 constraints on a CUDA
    device (None: the card); returns the JSON line's fields but the card's.
    ``ok`` is true if the proof verifies and the tampered input is
    rejected."""
    dev = _device.resolve(device)
    if dev.type != "cuda":
        raise RuntimeError(f"large_prove runs on a CUDA device, not {dev}")
    ni = NUM_INPUTS
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    seconds, stage_bytes = {}, {}
    setup_seconds, setup_bytes, prove_seconds, prove_bytes = {}, {}, {}, {}

    t0 = time.perf_counter()
    r1cs, primary, aux = construct.serial_construct(
        (1 << log2) - ni, ni, seed=5, device=dev)
    torch.cuda.synchronize(dev)
    seconds["construct"] = time.perf_counter() - t0
    stage_bytes["construct"] = _device.memory_mark(dev)

    fixed0 = kernels.LAUNCHES["scan_accumulate_mixed_total"]
    t0 = time.perf_counter()
    crs = setup.setup(r1cs, seed=6, stage_seconds=setup_seconds,
                      stage_bytes=setup_bytes)
    seconds["setup"] = time.perf_counter() - t0
    fixed = kernels.LAUNCHES["scan_accumulate_mixed_total"] - fixed0

    t0 = time.perf_counter()
    proof = prover.prove(crs.proving_key, primary, aux, seed=7,
                         stage_seconds=prove_seconds, stage_bytes=prove_bytes)
    seconds["prove"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    accepted = verifier.verify(crs.verification_key, primary, proof)
    seconds["verify"] = time.perf_counter() - t0
    bad = list(primary)
    bad[1] = (bad[1] + 1) % FR.p
    rejected = not verifier.verify(crs.verification_key, bad, proof)

    pk = crs.proving_key
    return {
        "log2": log2, "constraints": (1 << log2) - ni, "inputs": ni,
        "curve": "bn254a", "query_rows": int(pk.query_a.shape[0]),
        "ok": accepted and rejected, "verify": accepted,
        "tampered_input_rejected": rejected,
        "seconds": seconds, "setup_seconds": setup_seconds,
        "prove_seconds": prove_seconds,
        "stage_bytes": {**stage_bytes, "setup": setup_bytes,
                        "prove": prove_bytes},
        "peak_memory_bytes": torch.cuda.max_memory_allocated(dev),
        "fixed_base_launches": fixed,
        "fixed_base_chunks_per_query": (fixed - 1) / CHUNKED_QUERIES,
        "proof_sha256": hashlib.sha256(
            repr((proof.a, proof.b, proof.c)).encode()).hexdigest(),
    }


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def main(log2: int = 24) -> dict:
    out = run(log2)
    out["card"] = card()
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    sys.exit(0 if main(*(int(a) for a in sys.argv[1:]))["ok"] else 1)
