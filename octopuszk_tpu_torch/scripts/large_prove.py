"""One Groth16 proof at 2^log2 constraints on the card (BN254a, packed keys,
3 public inputs), stage by stage, with the device memory at each stage:
``serial_construct(2^log2 - 3, 3, seed=5)``, ``setup(seed=6)``,
``prove(seed=7)`` with the queries resident on the card (the seeds of
``chip_smoke.py``'s packed path), ``verify``, and the same proof against a
tampered public input, which must be rejected.  With ``--stream`` the same
key then proves again with the same seed from host memory: the five packed
queries are copied to pinned host memory and the card's copies freed
(``convert.queries_to_host``, as ``load_crs(stream=True)`` leaves a key),
and the prover stages them to the card chunk by chunk.  That proof must
verify, reject the tampered input and equal the resident one word for
word.

Prints one JSON line: seconds per stage (``setup_seconds`` and
``prove_seconds`` as ``setup`` and ``prove`` fill them), ``stage_bytes``
(bytes allocated and the running peak at each mark), each stage's own peak
(``stage_peak_bytes``: the peak statistics are reset at the start of
construct, setup, each prove and the move to host memory, so a mark's peak
counts from the start of its stage; ``stage_peak_reserved_bytes``, the
caching allocator's reserved bytes at their peak) and the run's peak (the
largest of them), the fixed-base (g) launches of setup and the chunks a query, a
sha256 of the proof's words, the process's peak resident host memory, with
``--stream`` a ``streamed`` object (its prove's seconds, marks and peak,
the bytes pinned, the bytes staged to the card, the equality), and the
card's name and power limit as ``nvidia-smi`` gives them.

    python -m octopuszk_tpu_torch.scripts.large_prove [log2] [--stream]
    # default 24

Needs the card and raises without one; exits 1 if a proof does not
verify, the tampered input is accepted or the two proofs differ.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import hashlib
import json
import resource
import subprocess
import sys
import time

import torch

from octopuszk_tpu_torch import convert
from octopuszk_tpu_torch.fields.spec import FR
from octopuszk_tpu_torch.models.groth16 import prover, setup, verifier
from octopuszk_tpu_torch.ops import kernels, msm
from octopuszk_tpu_torch.relations import construct
from octopuszk_tpu_torch.utils import device as _device

NUM_INPUTS = 3
# setup encodes five queries in chunks and gammaABC's public entries in
# one launch of (g)
CHUNKED_QUERIES = 5


def _check(crs, primary, proof) -> dict:
    """The proof verifies, and a tampered public input is rejected."""
    accepted = verifier.verify(crs.verification_key, primary, proof)
    bad = list(primary)
    bad[1] = (bad[1] + 1) % FR.p
    rejected = not verifier.verify(crs.verification_key, bad, proof)
    return {"verify": accepted, "tampered_input_rejected": rejected}


def _digest(proof) -> str:
    return hashlib.sha256(
        repr((proof.a, proof.b, proof.c)).encode()).hexdigest()


def run(log2: int = 24, device=None, stream: bool = False) -> dict:
    """Construct, set up, prove and verify at 2^log2 constraints on a CUDA
    device (None: the card), and with ``stream`` prove once more from host
    memory; returns the JSON line's fields but the card's.  ``ok`` is true
    if every proof verifies, the tampered input is rejected and the two
    proofs are equal."""
    dev = _device.resolve(device)
    if dev.type != "cuda":
        raise RuntimeError(f"large_prove runs on a CUDA device, not {dev}")
    ni = NUM_INPUTS
    seconds, stage_bytes, peaks, reserved = {}, {}, {}, {}
    setup_seconds, setup_bytes, prove_seconds, prove_bytes = {}, {}, {}, {}

    @contextlib.contextmanager
    def stage(label):
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        yield
        torch.cuda.synchronize(dev)
        seconds[label] = time.perf_counter() - t0
        peaks[label] = torch.cuda.max_memory_allocated(dev)
        reserved[label] = torch.cuda.max_memory_reserved(dev)

    with stage("construct"):
        r1cs, primary, aux = construct.serial_construct(
            (1 << log2) - ni, ni, seed=5, device=dev)
    stage_bytes["construct"] = _device.memory_mark(dev)

    fixed0 = kernels.LAUNCHES["scan_accumulate_mixed_total"]
    with stage("setup"):
        crs = setup.setup(r1cs, seed=6, stage_seconds=setup_seconds,
                          stage_bytes=setup_bytes)
    fixed = kernels.LAUNCHES["scan_accumulate_mixed_total"] - fixed0
    query_rows = int(crs.proving_key.query_a.shape[0])

    with stage("prove"):
        proof = prover.prove(crs.proving_key, primary, aux, seed=7,
                             stage_seconds=prove_seconds,
                             stage_bytes=prove_bytes)
    t0 = time.perf_counter()
    checks = _check(crs, primary, proof)
    seconds["verify"] = time.perf_counter() - t0
    ok = checks["verify"] and checks["tampered_input_rejected"]

    out = {
        "log2": log2, "constraints": (1 << log2) - ni, "inputs": ni,
        "curve": "bn254a", "query_rows": query_rows, **checks,
        "seconds": seconds, "setup_seconds": setup_seconds,
        "prove_seconds": prove_seconds,
        "stage_bytes": {**stage_bytes, "setup": setup_bytes,
                        "prove": prove_bytes},
        "stage_peak_bytes": peaks, "stage_peak_reserved_bytes": reserved,
        "fixed_base_launches": fixed,
        "fixed_base_chunks_per_query": (fixed - 1) / CHUNKED_QUERIES,
        "proof_sha256": _digest(proof),
    }
    if stream:
        sprove_seconds, sprove_bytes = {}, {}
        with stage("to-host"):
            crs = dataclasses.replace(crs, proving_key=convert.queries_to_host(
                crs.proving_key))
        to_host = _device.memory_mark(dev)
        pinned = sum(getattr(crs.proving_key, q).nbytes
                     for q in convert.QUERIES)
        staged0 = sum(msm.STAGED_BYTES.values())
        with stage("prove-streamed"):
            sproof = prover.prove(crs.proving_key, primary, aux, seed=7,
                                  stage_seconds=sprove_seconds,
                                  stage_bytes=sprove_bytes)
        staged = sum(msm.STAGED_BYTES.values()) - staged0
        schecks = _check(crs, primary, sproof)
        equal = (sproof.a, sproof.b, sproof.c) == (proof.a, proof.b, proof.c)
        out["streamed"] = {
            **schecks, "proof_equals_resident": equal,
            "prove_seconds": sprove_seconds,
            "stage_bytes": {"to-host": to_host, "prove": sprove_bytes},
            "pinned_host_bytes": pinned, "staged_bytes": staged,
            "all_pinned": all(getattr(crs.proving_key, q).is_pinned()
                              for q in convert.QUERIES),
            "proof_sha256": _digest(sproof)}
        ok = (ok and equal and schecks["verify"]
              and schecks["tampered_input_rejected"])
    out.update(ok=ok, peak_memory_bytes=max(peaks.values()),
               host_peak_rss_bytes=resource.getrusage(
                   resource.RUSAGE_SELF).ru_maxrss * 1024)
    return out


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("log2", type=int, nargs="?", default=24)
    ap.add_argument("--stream", action="store_true",
                    help="prove a second time from pinned host memory")
    args = ap.parse_args(argv)
    out = run(args.log2, stream=args.stream)
    out["card"] = card()
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    sys.exit(0 if main()["ok"] else 1)
