"""Where new tensors are created: the card unless the caller names the CPU."""

from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """``None`` means the CUDA device; raises if that is asked for and no
    card is present (entry points never fall back to the CPU silently)."""
    if device is None:
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "a CUDA device was requested and none is available; "
            "pass device='cpu' to run the plain PyTorch path")
    return device


def memory_mark(device) -> dict:
    """The caching allocator's bytes on a CUDA device: live now
    (``allocated``) and the running peak since the last reset
    (``peak``)."""
    return {"allocated": torch.cuda.memory_allocated(device),
            "peak": torch.cuda.max_memory_allocated(device)}
