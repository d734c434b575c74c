"""Model-side entry used by ``models.attention.attention_block``."""
from __future__ import annotations

from . import kernel
from .ref import flash_attention_ref


def flash_attention(q, k, v, q_pos, kv_pos, *, causal=True, window=0,
                    cap=0.0, scale=None):
    """Self-attention over [B,S,H,hd] / [B,S,KV,hd].

    A tensor on the CPU goes to the plain version, one on the card to the
    CUDA kernel (which raises on what it does not take; there is no
    fallback).  ``q_pos``/``kv_pos`` must be the self-attention iota: they
    are accepted for signature parity and positions are derived inside.
    ``window`` is honoured as given, in every layer.
    """
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   cap=cap, scale=scale)
    return kernel.flash_attention(q, k, v, causal=causal, window=window,
                                  cap=cap, scale=scale)
