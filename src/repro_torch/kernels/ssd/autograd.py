"""The SSD chunk-scan kernel inside a training graph.

The JAX package has no backward kernel: it trains through XLA's autodiff
of ``ssd_chunked`` (``repro/models/ssm.py``), recomputed per layer under
``jax.checkpoint``.  :class:`SSDFn` does the same on the port's side: its
forward is the CUDA kernel for a tensor on the card (the plain chunked
form, without a graph, for one on the CPU), and it saves only its five
inputs.  Its backward recomputes :func:`ssd_chunked` on them and takes
its gradient, so it launches no kernel.  A, dt, B and C all get a
gradient (A comes from ``A_log``, dt from ``dt_bias``).  Training never
uses the final state, so its gradient may be ``None``: the Function does
not materialise it.
"""
from __future__ import annotations

import torch

from . import kernel
from .ref import ssd_chunked


def on_card(t) -> bool:
    """Whether ``t`` goes to the CUDA kernel: ``cuda`` does, ``cpu`` and
    ``meta`` (the dry run's trace, which allocates nothing) go to the
    plain form; any other device raises.  ``ops`` routes by it too."""
    kind = t.device.type
    if kind == "cuda":
        return True
    if kind in ("cpu", "meta"):
        return False
    raise ValueError(f"no route for a tensor on {t.device}: the kernel "
                     "takes cuda, the plain form cpu or meta")


class SSDFn(torch.autograd.Function):
    """``apply(xs, dt, A, B_, C_, chunk)`` -> (y, final state)."""

    @staticmethod
    def forward(ctx, xs, dt, A, B_, C_, chunk):
        ctx.save_for_backward(xs, dt, A, B_, C_)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        if on_card(xs):
            return kernel.ssd(xs, dt, A, B_, C_, chunk=chunk)
        with torch.no_grad():
            return ssd_chunked(xs, dt, A, B_, C_, chunk)

    @staticmethod
    def backward(ctx, gy, gstate):
        ins = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        outs, grads = [], []
        with torch.enable_grad():
            y, state = ssd_chunked(*ins, ctx.chunk)
        for o, g in ((y, gy), (state, gstate)):
            if g is not None:
                outs.append(o)
                grads.append(g)
        if not outs:
            return (None,) * 6
        return (*torch.autograd.grad(outs, ins, grads, allow_unused=True),
                None)
