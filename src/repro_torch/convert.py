"""Trees of the JAX package as port trees, and back.

``from_jax_params`` takes the JAX parameter tree as numpy arrays (for
example ``jax.tree.map(np.asarray, params)``), unstacks the scanned
``[L, ...]`` leaves under ``"layers"`` into one parameter set per layer
(a dense ``"layer0"`` stays apart), and so builds a model that computes
the same function as the JAX one.  ``from_jax_opt_state`` does the same
for the AdamW state, and ``to_jax_tree`` maps a port tree (parameters,
gradients, moments) back to the stacked layout, so that the two packages
can be compared leaf by leaf.  A training checkpoint does not cross
between the packages: its layer layouts differ, and only these functions
map one to the other.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.transformer import Model, model_specs, n_scanned
from repro_torch.optim.adamw import BLOCK, _dq8, _q8


def to_tensor(a) -> torch.Tensor:
    """numpy (f32, or ml_dtypes bfloat16 as JAX hands it out) -> CPU
    tensor of the same dtype."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy())
        return t.view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def _tensors(t, index=None):
    """A numpy tree as CPU tensors; ``index`` picks one layer of stacked
    leaves."""
    if isinstance(t, dict):
        return {k: _tensors(v, index) for k, v in t.items()}
    return to_tensor(t if index is None else np.asarray(t)[index])


def _unstack(cfg, tree):
    """Stacked JAX layout -> the port's per-layer dict tree of tensors."""
    out = {k: _tensors(v) for k, v in tree.items() if k != "layers"}
    out["layers"] = {str(i): _tensors(tree["layers"], i)
                     for i in range(n_scanned(cfg))}
    return out


def from_jax_params(cfg, tree, requires_grad: bool = False) -> Model:
    """``tree`` mirrors ``repro.models.transformer.model_specs(cfg)``:
    ``"layers"`` stacks ``n_layers`` layers, or ``n_layers - 1`` beside a
    dense ``"layer0"`` (``first_dense_d_ff``).  MoE, MLA and frontend
    leaves convert like any other.  Returns a model on the CPU;
    ``.to(device)`` moves it."""
    return Model(cfg, _unstack(cfg, tree), requires_grad)


def _int8_layers(spec_tree, mom_tree, L):
    """The reference's int8 moments of stacked leaves -> one ``{"q",
    "s"}`` per layer.  A leaf whose per-layer size is a multiple of
    ``BLOCK`` owns whole blocks, which are sliced out exactly; elsewhere
    the reference's blocks straddle layers, so the leaf is dequantized,
    cut per layer and quantized again (within one quantization step)."""
    if "q" not in mom_tree:
        subs = {k: _int8_layers(spec_tree[k], mom_tree[k], L)
                for k in spec_tree}
        return [{k: subs[k][i] for k in subs} for i in range(L)]
    shape = tuple(spec_tree.shape)
    n = int(np.prod(shape))
    q, s = to_tensor(mom_tree["q"]), to_tensor(mom_tree["s"])
    if n % BLOCK == 0:
        nb = n // BLOCK
        return [{"q": q[i * nb:(i + 1) * nb].clone(),
                 "s": s[i * nb:(i + 1) * nb].clone()} for i in range(L)]
    full = _dq8(q, s, (L,) + shape)
    return [dict(zip(("q", "s"), _q8(full[i]))) for i in range(L)]


def from_jax_opt_state(cfg, tree) -> dict:
    """The reference's ``adamw_init``/``adamw_update`` state (numpy
    leaves) -> the port's: ``m`` and ``v`` unstacked per layer as the
    parameters are (f32 leaves, or int8 ``{"q", "s"}`` blocks), ``count``
    an int32 scalar tensor.  CPU tensors."""
    int8 = isinstance(tree["m"]["final_norm"], dict)     # {"q", "s"}

    def moments(t):
        if not int8:
            return _unstack(cfg, t)
        out = {k: _tensors(v) for k, v in t.items() if k != "layers"}
        L = n_scanned(cfg)
        per = _int8_layers(model_specs(cfg)["layers"]["0"], t["layers"], L)
        out["layers"] = {str(i): per[i] for i in range(L)}
        return out

    return {"m": moments(tree["m"]), "v": moments(tree["v"]),
            "count": torch.tensor(int(np.asarray(tree["count"])),
                                  dtype=torch.int32)}


def to_jax_tree(cfg, tree) -> dict:
    """A port tree shaped like ``param_tree`` (parameters, gradients, f32
    moments) -> numpy in the JAX package's stacked layout: ``"layers"``
    stacked along a new axis 0, layer 0 first.  bf16 leaves come back as
    f32, exactly."""
    def host(t):
        return t.detach().cpu().float().numpy()

    def stack(ts):
        if isinstance(ts[0], dict):
            return {k: stack([t[k] for t in ts]) for k in ts[0]}
        return np.stack([host(t) for t in ts])

    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        return host(t)

    out = {k: conv(v) for k, v in tree.items() if k != "layers"}
    out["layers"] = stack([tree["layers"][str(i)]
                           for i in range(n_scanned(cfg))])
    return out
