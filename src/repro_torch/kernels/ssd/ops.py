"""Model-side entry used by ``models.ssm.ssm_block``."""
from __future__ import annotations

import torch

from . import autograd, kernel
from .ref import ssd_chunked


def ssd(xs, dt, A, B_, C_, chunk: int = 128):
    """A tensor on the CPU or on ``meta`` (the dry run's trace) goes to the
    plain chunked form, one on the card to the CUDA kernel (which raises on
    what it does not take; there is no fallback).  When a gradient is
    wanted (grad mode on and an input that requires grad), the call goes
    through ``autograd.SSDFn``, whose forward is the same kernel or plain
    form.  Any sequence length."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (xs, dt, A, B_, C_)):
        return autograd.SSDFn.apply(xs, dt, A, B_, C_, chunk)
    if autograd.on_card(xs):
        return kernel.ssd(xs, dt, A, B_, C_, chunk=chunk)
    return ssd_chunked(xs, dt, A, B_, C_, chunk)
