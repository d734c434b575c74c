"""Model-side entry used by ``models.ssm.ssm_block``."""
from __future__ import annotations

from . import kernel
from .ref import ssd_chunked


def ssd(xs, dt, A, B_, C_, chunk: int = 128):
    """A tensor on the CPU goes to the plain chunked form, one on the card
    to the CUDA kernel (which raises on what it does not take; there is no
    fallback).  Any sequence length."""
    if xs.device.type == "cpu":
        return ssd_chunked(xs, dt, A, B_, C_, chunk)
    return kernel.ssd(xs, dt, A, B_, C_, chunk=chunk)
