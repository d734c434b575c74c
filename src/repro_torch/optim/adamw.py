"""AdamW with optional 8-bit (error-feedback-free, blockwise-scaled) moment
states.  Counterpart of ``repro.optim.adamw``, with its f32 arithmetic
step for step: the bias corrections are ``b1 ** count`` with the count an
f32 tensor, Python constants enter as f32 (JAX's weak types), and int8
rounding is half to even (``torch.round``, as ``jnp.round``).

Trees are nested dicts of tensors (``repro_torch.models.transformer.
param_tree`` gives a model's); the state is ``{"m", "v", "count"}`` with
``m`` and ``v`` shaped like the parameters (int8: a ``{"q", "s"}`` dict
per leaf) and ``count`` an int32 scalar.  The update is functional, as in
the reference: it returns new parameters and a new state.
"""
from __future__ import annotations

import torch

from repro_torch.core.engine import ref_leaves, ref_map

BLOCK = 256


def _q8(x):
    """Blockwise int8 quantization along the flattened last axis."""
    flat = x.reshape(-1)
    pad = (-flat.numel()) % BLOCK
    flat = torch.nn.functional.pad(flat, (0, pad))
    blocks = flat.reshape(-1, BLOCK)
    scale = torch.amax(torch.abs(blocks), dim=1, keepdim=True) / 127.0 \
        + 1e-12
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale.float()


def _dq8(q, scale, shape):
    flat = (q.float() * scale).reshape(-1)
    n = 1
    for s in shape:
        n *= s
    return flat[:n].reshape(shape)


def adamw_init(params, *, moments_dtype: str = "float32"):
    def zero(p):
        z = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        if moments_dtype == "int8":
            q, s = _q8(z)
            return {"q": q, "s": s}
        return z

    dev = ref_leaves(params)[0].device
    return {"m": ref_map(zero, params), "v": ref_map(zero, params),
            "count": torch.zeros((), dtype=torch.int32, device=dev)}


@torch.no_grad()
def adamw_update(grads, state, params, *, lr, b1=0.9, b2=0.95, eps=1e-8,
                 weight_decay=0.1, moments_dtype: str = "float32"):
    """-> (new params, new state).  Every leaf is updated, so a leaf whose
    gradient is zero still decays and moves its moments."""
    count = state["count"] + 1
    cf = count.float()
    int8 = moments_dtype == "int8"
    c1 = 1 - torch.pow(b1, cf)
    c2 = 1 - torch.pow(b2, cf)

    def upd(g, m, v, p):
        g = g.float()
        mf = _dq8(m["q"], m["s"], g.shape) if int8 else m
        vf = _dq8(v["q"], v["s"], g.shape) if int8 else v
        mf = b1 * mf + (1 - b1) * g
        vf = b2 * vf + (1 - b2) * g * g
        mh = mf / c1
        vh = vf / c2
        step = mh / (torch.sqrt(vh) + eps) + weight_decay * p.float()
        new_p = (p.float() - lr * step).to(p.dtype)
        if int8:
            qm, sm = _q8(mf)
            qv, sv = _q8(vf)
            return new_p, {"q": qm, "s": sm}, {"q": qv, "s": sv}
        return new_p, mf, vf

    new_p, new_m, new_v = tree_unzip(
        ref_map(upd, grads, state["m"], state["v"], params), 3)
    return new_p, {"m": new_m, "v": new_v, "count": count}


def tree_unzip(tree, n: int) -> list:
    """A tree whose leaves are n-tuples -> n trees."""
    if isinstance(tree, dict):
        parts = {k: tree_unzip(v, n) for k, v in tree.items()}
        return [{k: p[i] for k, p in parts.items()} for i in range(n)]
    return list(tree)


@torch.no_grad()
def sum_squares(grads, acc=0):
    """``acc`` plus the squares of every leaf, added leaf by leaf in
    :func:`ref_leaves` order (``acc`` carries the sum across the parts
    of one tree taken in that order)."""
    for g in ref_leaves(grads):
        acc = acc + torch.sum(torch.square(g.float()))
    return acc


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float, norm=None):
    """-> (grads scaled so their global norm is at most ``max_norm``, the
    norm before scaling).  Squares are summed leaf by leaf in
    :func:`tree_leaves` order, as the reference sums ``jax.tree.leaves``;
    a per-layer tree still sums in another order than the reference's
    stacked one (f32 differences near 1e-7 of the norm).  ``norm`` gives
    the global norm of a tree that ``grads`` is a part of."""
    if norm is None:
        norm = torch.sqrt(sum_squares(grads))
    factor = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return ref_map(lambda g: (g.float() * factor).to(g.dtype), grads), norm
