"""PyTorch + CUDA port of the ``repro`` LM framework, for one NVIDIA H100.

Each module mirrors the module of the same path under ``repro`` and keeps
its public layouts, so the two packages can be held against each other.
The port imports torch, numpy and the standard library only.

Entry points run on ``cuda`` unless the caller asks for ``device="cpu"``;
they raise when CUDA is absent and the CPU was not asked for.
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means the card.  Never falls back to the CPU silently."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU")
    return dev
