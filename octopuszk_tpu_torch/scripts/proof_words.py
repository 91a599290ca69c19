"""The Groth16 proof of the main path's circuit on each curve, printed as a
digest of its words: ``serial_construct(2^log2 - 3, 3, seed=5)``,
``setup(seed=6)``, ``prove(seed=7)`` on the card (the seeds of
``chip_smoke.py``'s packed and ``bn254b`` paths), then sha256 of the
proof's affine coordinates as python ints.  Run it once with each of two
commits' packages on the path: equal digests mean equal proofs.  With
``setups`` above 1 the setup and the prove run that many times each on
the same circuit and seeds (the same CRS and proof); the line then carries
each setup stage's and each prove stage's median seconds (the witness
map's split included) and the fixed-base (g) launches a setup, for
comparing two commits in one call.

    python -m octopuszk_tpu_torch.scripts.proof_words [log2 [setups]]  # 20 1
    (cd <other checkout> && PYTHONPATH=$PWD python3 <this file> 20 5)

Needs the card and raises without one.
"""

from __future__ import annotations

import hashlib
import json
import statistics
import sys

from octopuszk_tpu_torch.curves.family import bn254b
from octopuszk_tpu_torch.models.groth16 import prover, setup, verifier
from octopuszk_tpu_torch.ops import kernels
from octopuszk_tpu_torch.relations import construct
from octopuszk_tpu_torch.utils import device as _device


def main(log2: int = 20, setups: int = 1) -> list:
    dev = _device.resolve(None)
    ni = 3
    out = []
    for name, cv in (("bn254a", None), ("bn254b", bn254b())):
        extra = {} if cv is None else {"spec": cv.fr}
        r1cs, primary, aux = construct.serial_construct(
            (1 << log2) - ni, ni, seed=5, device=dev, **extra)
        fixed0 = kernels.LAUNCHES["scan_accumulate_mixed_total"]
        stages = []
        for _ in range(setups):
            stages.append({})
            crs = setup.setup(r1cs, seed=6, curve=cv,
                              stage_seconds=stages[-1])
        fixed = kernels.LAUNCHES["scan_accumulate_mixed_total"] - fixed0
        proves = []
        for _ in range(setups):
            proves.append({})
            proof = prover.prove(crs.proving_key, primary, aux, seed=7,
                                 curve=cv, stage_seconds=proves[-1])
        words = repr((proof.a, proof.b, proof.c)).encode()
        line = {"curve": name, "log2": log2,
                "verify": verifier.verify(crs.verification_key, primary,
                                          proof, curve=cv),
                "proof_sha256": hashlib.sha256(words).hexdigest()}
        if setups > 1:
            line.update(setups=setups, fixed_base_launches_per_setup=(
                fixed / setups), setup_seconds_median={
                    k: statistics.median(s[k] for s in stages)
                    for k in stages[0]}, prove_seconds_median={
                    k: statistics.median(s[k] for s in proves)
                    for k in proves[0]})
        print(json.dumps(line), flush=True)
        out.append(line)
    return out


if __name__ == "__main__":
    main(*(int(a) for a in sys.argv[1:]))
    sys.exit(0)
