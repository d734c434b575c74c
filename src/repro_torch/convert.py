"""Parameters of the JAX package as a port :class:`Model`.

``from_jax_params`` takes the JAX parameter tree as numpy arrays (for
example ``jax.tree.map(np.asarray, params)``), unstacks the scanned
``[L, ...]`` leaves under ``"layers"`` into one parameter set per layer
(a dense ``"layer0"`` stays apart), and so builds a model that computes
the same function as the JAX one.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.transformer import Model, n_scanned


def to_tensor(a) -> torch.Tensor:
    """numpy (f32, or ml_dtypes bfloat16 as JAX hands it out) -> CPU
    tensor of the same dtype."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy())
        return t.view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def from_jax_params(cfg, tree) -> Model:
    """``tree`` mirrors ``repro.models.transformer.model_specs(cfg)``:
    ``"layers"`` stacks ``n_layers`` layers, or ``n_layers - 1`` beside a
    dense ``"layer0"`` (``first_dense_d_ff``).  MoE, MLA and frontend
    leaves convert like any other.  Returns a model on the CPU;
    ``.to(device)`` moves it."""
    def conv(t, index=None):
        if isinstance(t, dict):
            return {k: conv(v, index) for k, v in t.items()}
        return to_tensor(t if index is None else np.asarray(t)[index])

    params = {"embed": conv(tree["embed"]),
              "final_norm": conv(tree["final_norm"]),
              "layers": {str(i): conv(tree["layers"], i)
                         for i in range(n_scanned(cfg))}}
    if cfg.first_dense_d_ff:
        params["layer0"] = conv(tree["layer0"])
    return Model(cfg, params)
