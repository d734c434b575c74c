"""What the tensor-core kernels' TMA copies need from an operand.

A TMA tensor map (``csrc/tc.cuh``) takes a base address aligned to 16
bytes and strides that are multiples of 16 bytes: for bf16, every stride
but the last dim's (which must be 1) a multiple of 8 elements.  A stride
of a dim of size 1 is never stepped, so it does not count (the C entry
points check the same rule, ``tc::tma_ready``).  The model's
operands are views of fused projections that meet this; a view that does
not (an odd head dim, an offset of a few elements) is copied by
:func:`operand`, which counts the copies in ``copies``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

ALIGN_BYTES = 16
copies = 0


def ready(t: torch.Tensor) -> bool:
    """Whether TMA can read ``t`` as it is."""
    if t.stride(-1) != 1 and t.shape[-1] > 1:
        return False
    if t.data_ptr() % ALIGN_BYTES:
        return False
    per = ALIGN_BYTES // t.element_size()
    return all(s % per == 0 for n, s in zip(t.shape[:-1], t.stride()[:-1])
               if n > 1)


def operand(t: torch.Tensor, last: int | None = None) -> torch.Tensor:
    """``t`` as TMA can read it: itself when :func:`ready`, else a fresh
    contiguous copy; ``last`` pads the last dim with zeros to that size
    (for a width whose rows are not a whole number of 16 bytes)."""
    global copies
    pad = (last or t.shape[-1]) - t.shape[-1]
    if not pad and ready(t):
        return t
    copies += 1
    if pad:
        return F.pad(t, (0, pad))
    return t.clone(memory_format=torch.contiguous_format)


def round_up(n: int, per: int = 8) -> int:
    """``n`` rounded up to a whole number of 16-byte (8 bf16) pieces."""
    return -(-n // per) * per
