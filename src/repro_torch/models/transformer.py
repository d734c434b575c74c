"""Family assembly for the ported blocks: dense attention + MLP, SSM, and
the attention + SSM hybrid.  Counterpart of ``repro.models.transformer``.

Where the JAX package stacks per-layer parameters ``[L, ...]`` and scans,
the port keeps one :class:`ParamTree` per layer in a :class:`Model` and
loops over layers in Python.  MoE, MLA and modality frontends belong to
later slices of the port and raise ``NotImplementedError``.

Modes: ``train`` (loss-ready logits), ``prefill`` (build decode cache),
``decode`` (one token against the cache).
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch import resolve_device

from . import attention as attn_mod
from . import ssm as ssm_mod
from .layers import (embed, embed_specs, init_params, mlp, mlp_specs, norm,
                     norm_spec, unembed)


# ---------------------------------------------------------------------------
# parameter specs and the model
# ---------------------------------------------------------------------------
def _unported(cfg):
    if cfg.use_mla or cfg.n_experts or cfg.first_dense_d_ff:
        raise NotImplementedError(
            f"{cfg.name}: MoE and MLA blocks are not ported yet "
            f"(ROADMAP.md queue 1, model path)")
    if cfg.frontend != "none":
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.frontend} frontend is not ported yet "
            f"(ROADMAP.md queue 1, model path)")


def _block_specs(cfg):
    s = {"ln1": norm_spec(cfg)}
    if cfg.has_attn:
        s["attn"] = attn_mod.attn_specs(cfg)
    if cfg.has_ssm:
        s["ssm"] = ssm_mod.ssm_specs(cfg)
    if cfg.d_ff:
        s["ln2"] = norm_spec(cfg)
        s["mlp"] = mlp_specs(cfg.d_model, cfg.d_ff, cfg.act)
    return s


def model_specs(cfg):
    """PSpec tree with one entry per layer under ``"layers"``."""
    _unported(cfg)
    return {"embed": embed_specs(cfg),
            "layers": {str(i): _block_specs(cfg)
                       for i in range(cfg.n_layers)},
            "final_norm": norm_spec(cfg)}


class ParamTree(nn.Module):
    """Nested parameters that index like the JAX package's dict tree."""

    def __init__(self, tree: dict):
        super().__init__()
        for k, v in tree.items():
            if isinstance(v, dict):
                self.add_module(k, ParamTree(v))
            else:
                self.register_parameter(k, nn.Parameter(v,
                                                        requires_grad=False))

    def __getitem__(self, k):
        return getattr(self, k)

    def __contains__(self, k):
        return k in self._parameters or k in self._modules


class Model(nn.Module):
    """Parameters of one model: ``embed``, per-layer ``layers`` and
    ``final_norm``, built from a tree of tensors whose ``"layers"`` entry
    maps the layer index (as a string) to that layer's parameters."""

    def __init__(self, cfg, params: dict):
        super().__init__()
        _unported(cfg)
        self.cfg = cfg
        self.embed = ParamTree(params["embed"])
        self.layers = nn.ModuleList(
            ParamTree(params["layers"][str(i)]) for i in range(cfg.n_layers))
        self.final_norm = nn.Parameter(params["final_norm"],
                                       requires_grad=False)

    def __getitem__(self, k):
        return getattr(self, k)

    @property
    def device(self) -> torch.device:
        return self.final_norm.device


def init_model(cfg, seed: int = 0, device=None, dtype=torch.bfloat16):
    """Random weights from the port's own init, drawn on ``device`` (the
    card unless the caller asks for the CPU) from a seeded generator."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    return Model(cfg, init_params(model_specs(cfg), g, dtype))


# ---------------------------------------------------------------------------
# one layer
# ---------------------------------------------------------------------------
def _layer(cfg, p, x, q_pos, window, cache, cache_len, mode):
    """Returns (x, new_cache_slice, aux)."""
    h = norm(cfg, x, p["ln1"])
    new_cache = {}
    parts = []
    if cfg.has_attn:
        out, nc = attn_mod.attention_block(
            p["attn"], cfg, h, q_pos, window=window,
            cache=None if cache is None else (cache["k"], cache["v"]),
            cache_len=cache_len)
        if nc is not None:
            new_cache["k"], new_cache["v"] = nc
        elif mode == "prefill":
            # stash this layer's K/V, recomputed as the JAX package does
            k = torch.einsum("bsd,dke->bske", h,
                             p["attn"]["wk"].to(h.dtype))
            v = torch.einsum("bsd,dke->bske", h,
                             p["attn"]["wv"].to(h.dtype))
            k = attn_mod.rope(k, q_pos, cfg.rope_theta)
            new_cache["k"], new_cache["v"] = k, v
        parts.append(out)
    if cfg.has_ssm:
        sc = None
        if cache is not None:
            sc = (cache["conv"], cache["ssm"])
        elif mode == "prefill":
            sc = "init"
        out2, nc2 = ssm_mod.ssm_block(p["ssm"], cfg, h, cache=sc)
        if nc2 is not None:
            new_cache["conv"], new_cache["ssm"] = nc2
        parts.append(out2)
    mix = parts[0] if len(parts) == 1 else \
        0.5 * (parts[0] + parts[1])          # hymba: parallel heads, averaged
    x = x + mix
    if "mlp" in p:
        h2 = norm(cfg, x, p["ln2"])
        x = x + mlp(p["mlp"], h2, cfg.act)
    return x, new_cache, 0.0


# ---------------------------------------------------------------------------
# embedding and forward
# ---------------------------------------------------------------------------
def embed_inputs(params, cfg, batch):
    """Text tokens -> (x [B,S,d], positions [B,S], label_mask None)."""
    _unported(cfg)
    x = embed(params["embed"], cfg, batch["tokens"])
    B, S = x.shape[:2]
    pos = torch.arange(S, dtype=torch.int32, device=x.device).expand(B, S)
    return x, pos, None


def forward(params, cfg, batch, mode: str = "train", cache=None,
            positions=None, cache_len=None):
    """Forward pass, a Python loop over layers.

    train:   batch -> logits [B,S,Vp], aux
    prefill: batch -> logits, cache (stacked [L,...]), aux
    decode:  batch['tokens'] [B,1] + cache + positions [B,1] -> logits,
             cache.  K/V are written into ``cache["k"]``/``cache["v"]`` in
             place; the conv and SSM states come back as new tensors.
    """
    assert mode in ("train", "prefill", "decode")
    if mode == "decode":
        x = embed(params["embed"], cfg, batch["tokens"])
        q_pos = positions
    else:
        x, q_pos, _ = embed_inputs(params, cfg, batch)

    windows = cfg.layer_windows()
    ncs = []
    for li, p in enumerate(params["layers"]):
        c = None if cache is None else {k: t[li] for k, t in cache.items()}
        x, nc, _ = _layer(cfg, p, x, q_pos, windows[li], c, cache_len, mode)
        ncs.append(nc)

    x = norm(cfg, x, params["final_norm"])
    logits = unembed(params["embed"], cfg, x)

    new_cache = None
    if mode in ("prefill", "decode") and ncs[0]:
        new_cache = {}
        for k in ncs[0]:
            if cache is not None and k in ("k", "v"):
                new_cache[k] = cache[k]        # updated in place
            else:
                new_cache[k] = torch.stack([nc[k] for nc in ncs])
    return logits, new_cache, 0.0


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------
def needs_unrolled_decode(cfg, S_max: int) -> bool:
    """Heterogeneous cache shapes (ring vs full) => unroll the layer loop."""
    ws = cfg.layer_windows()
    kinds = {("ring" if 0 < w < S_max else "full") for w in ws
             if cfg.has_attn}
    return len(kinds) > 1


def init_cache(cfg, B: int, S_max: int, dtype=torch.bfloat16, device=None):
    """Decode cache for the uniform path, stacked [L, ...], on ``device``
    (the card unless the caller asks for the CPU).  K/V and the conv state
    are ``dtype`` (bf16 by default, whatever the params are); the SSM state
    is f32."""
    device = resolve_device(device)
    L = cfg.n_layers
    c = {}
    if cfg.has_attn:
        kvh, hd = cfg.n_kv_heads, cfg.head_dim
        c["k"] = torch.zeros((L, B, S_max, kvh, hd), dtype=dtype,
                             device=device)
        c["v"] = torch.zeros((L, B, S_max, kvh, hd), dtype=dtype,
                             device=device)
    if cfg.has_ssm:
        conv_dim = cfg.d_inner + 2 * cfg.ssm_state
        c["conv"] = torch.zeros((L, B, cfg.conv_kernel - 1, conv_dim),
                                dtype=dtype, device=device)
        c["ssm"] = torch.zeros((L, B, cfg.n_ssm_heads, cfg.ssm_headdim,
                                cfg.ssm_state), dtype=torch.float32,
                               device=device)
    return c
