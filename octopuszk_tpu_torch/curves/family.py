"""The BN254a curve bundle: field specs, device groups, host ops and the
pairing, as one object that Groth16 is generic over."""

from __future__ import annotations

import functools
import types

from octopuszk_tpu_torch.curves import bn254, pairing
from octopuszk_tpu_torch.fields.spec import FQ, FR


@functools.cache
def bn254a() -> types.SimpleNamespace:
    return types.SimpleNamespace(
        name="bn254a", fq=FQ, fr=FR, g1=bn254.G1, g2=bn254.G2,
        pairing=pairing)
