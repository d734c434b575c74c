"""The flash-attention kernel inside a training graph.

The JAX package has no backward kernel: it trains through XLA's autodiff
of ``blockwise_attention`` (``repro/models/attention.py``), recomputed
per layer under ``jax.checkpoint``.  :class:`FlashAttentionFn` does the
same on the port's side: its forward is the CUDA kernel for a tensor on
the card (the plain version, without a graph, for one on the CPU), and it
saves only q, k and v.  Its backward recomputes the plain blockwise
online softmax (:func:`flash_attention_ref`) on those inputs and takes
its gradient, so it launches no kernel.  The upstream gradient is what
the rest of the graph made of the kernel's output, so the kernel's
forward is part of every gradient the loss sends back.
"""
from __future__ import annotations

import torch

from . import kernel
from .ref import flash_attention_ref


def on_card(t) -> bool:
    """Whether ``t`` goes to the CUDA kernel: ``cuda`` does, ``cpu`` and
    ``meta`` (the dry run's trace, which allocates nothing) go to the
    plain version; any other device raises.  ``ops`` routes by it too."""
    kind = t.device.type
    if kind == "cuda":
        return True
    if kind in ("cpu", "meta"):
        return False
    raise ValueError(f"no route for a tensor on {t.device}: the kernel "
                     "takes cuda, the plain version cpu or meta")


class FlashAttentionFn(torch.autograd.Function):
    """``apply(q, k, v, causal, window, cap, scale)`` -> [B,Sq,H,hd]."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, cap, scale):
        ctx.save_for_backward(q, k, v)
        ctx.opts = dict(causal=causal, window=window, cap=cap, scale=scale)
        if on_card(q):
            return kernel.flash_attention(q, k, v, **ctx.opts)
        with torch.no_grad():
            return flash_attention_ref(q, k, v, **ctx.opts)

    @staticmethod
    def backward(ctx, g):
        q, k, v = (t.detach().requires_grad_() for t in ctx.saved_tensors)
        with torch.enable_grad():
            out = flash_attention_ref(q, k, v, **ctx.opts)
        dq, dk, dv = torch.autograd.grad(out, (q, k, v), g)
        return dq, dk, dv, None, None, None, None
