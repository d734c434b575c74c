"""The flash-attention kernel inside a training graph.

The JAX package has no backward kernel: it trains through XLA's autodiff
of ``blockwise_attention`` (``repro/models/attention.py``), recomputed
per layer under ``jax.checkpoint``.  :class:`FlashAttentionFn` routes by
what its input shows:

- bf16 on the card: the forward is the kernel that also returns each
  row's log-sum-exp (``kernel.flash_attention_lse``); q, k, v, the output
  and the log-sum-exp are saved, and the backward is the bf16 backward
  kernel (``kernel.flash_attention_bwd``, FlashAttention-2's algebra).
  Nothing falls back: what the kernels do not take raises.
- f32 on the card, and the CPU and ``meta`` (the dry run's trace): the
  forward is the kernel on the card (the plain version, without a graph,
  elsewhere), only q, k and v are saved, and the backward recomputes the
  plain blockwise online softmax (:func:`flash_attention_ref`) and takes
  its gradient, launching no kernel.

The upstream gradient is what the rest of the graph made of the kernel's
output, so the kernel's forward is part of every gradient the loss sends
back.
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


def kernel_backward(q) -> bool:
    """Whether a gradient at ``q`` goes through the backward kernel: bf16
    on the card does; f32 on the card, and the CPU and ``meta``, take the
    plain version's autograd."""
    return on_card(q) and q.dtype == torch.bfloat16


class FlashAttentionFn(torch.autograd.Function):
    """``apply(q, k, v, causal, window, cap, scale)`` -> [B,Sq,H,hd]."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, cap, scale):
        ctx.opts = dict(causal=causal, window=window, cap=cap, scale=scale)
        ctx.kernel_bwd = kernel_backward(q)
        if ctx.kernel_bwd:
            out, lse = kernel.flash_attention_lse(q, k, v, **ctx.opts)
            ctx.save_for_backward(q, k, v, out, lse)
            return out
        ctx.save_for_backward(q, k, v)
        if on_card(q):
            return kernel.flash_attention(q, k, v, **ctx.opts)
        with torch.no_grad():
            return flash_attention_ref(q, k, v, **ctx.opts)

    @staticmethod
    def backward(ctx, g):
        if ctx.kernel_bwd:
            dq, dk, dv = kernel.flash_attention_bwd(*ctx.saved_tensors, g,
                                                    **ctx.opts)
            return dq, dk, dv, None, None, None, None
        q, k, v = (t.detach().requires_grad_() for t in ctx.saved_tensors)
        with torch.enable_grad():
            out = flash_attention_ref(q, k, v, **ctx.opts)
        dq, dk, dv = torch.autograd.grad(out, (q, k, v), g)
        return dq, dk, dv, None, None, None, None
