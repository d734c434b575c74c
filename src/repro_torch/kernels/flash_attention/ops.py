"""Model-side entry used by ``models.attention.attention_block``."""
from __future__ import annotations

import torch

from . import autograd, kernel
from .ref import flash_attention_ref


def flash_attention(q, k, v, q_pos, kv_pos, *, causal=True, window=0,
                    cap=0.0, scale=None):
    """Self-attention over [B,S,H,hd] / [B,S,KV,hd].

    A tensor on the CPU or on ``meta`` (the dry run's trace) goes to the
    plain version, one on the card to the CUDA kernel (which raises on what
    it does not take; there is no fallback).  When a gradient is wanted
    (grad mode on and an input that requires grad), the call goes through
    ``autograd.FlashAttentionFn``, whose forward is the same kernel or
    plain version.  ``q_pos``/``kv_pos`` must be the self-attention iota:
    they are accepted for signature parity and positions are derived
    inside.  ``window`` is honoured as given, in every layer.
    """
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return autograd.FlashAttentionFn.apply(q, k, v, causal, window, cap,
                                               scale)
    if autograd.on_card(q):
        return kernel.flash_attention(q, k, v, causal=causal, window=window,
                                      cap=cap, scale=scale)
    return flash_attention_ref(q, k, v, causal=causal, window=window,
                               cap=cap, scale=scale)
