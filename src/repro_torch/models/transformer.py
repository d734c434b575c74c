"""Family assembly: dense / MoE / SSM / hybrid / audio / VLM models.
Counterpart of ``repro.models.transformer``.

Where the JAX package stacks per-layer parameters ``[L, ...]`` and scans,
the port keeps one :class:`ParamTree` per layer in a :class:`Model` and
loops over layers in Python.  A model whose layer 0 is dense
(``first_dense_d_ff``, deepseek-v2) keeps it apart as ``layer0``, before
the ``n_layers - 1`` layers of ``layers``, as the JAX tree does.
Heterogeneous-cache decode (gemma2's alternating local/global layers,
hymba's 3 global layers) goes layer by layer through
:func:`decode_unrolled`, with ring buffers for the sliding-window layers.

Modes: ``train`` (loss-ready logits), ``prefill`` (build decode cache),
``decode`` (one token against the cache).  :func:`train_loss` is the
training objective; in ``train`` mode with gradients on, each layer is
recomputed in the backward pass as ``cfg.remat`` says.
"""
from __future__ import annotations

from functools import partial

import torch
from torch import nn
from torch.utils.checkpoint import (checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch import resolve_device
from repro_torch.core.tracing import subtask
from repro_torch.parallel.sharding import constrain

from . import attention as attn_mod
from . import mla as mla_mod
from . import moe as moe_mod
from . import ssm as ssm_mod
from .layers import (cross_entropy, embed, embed_specs, init_params, mlp,
                     mlp_specs, norm, norm_spec, promote, unembed)


# ---------------------------------------------------------------------------
# parameter specs and the model
# ---------------------------------------------------------------------------
def _block_specs(cfg, dense_ff: int | None = None):
    s = {"ln1": norm_spec(cfg)}
    if cfg.has_attn:
        s["attn"] = (mla_mod.mla_specs(cfg) if cfg.use_mla
                     else attn_mod.attn_specs(cfg))
    if cfg.has_ssm:
        s["ssm"] = ssm_mod.ssm_specs(cfg)
    ff = dense_ff if dense_ff is not None else cfg.d_ff
    if cfg.n_experts and dense_ff is None:
        s["ln2"] = norm_spec(cfg)
        s["moe"] = moe_mod.moe_specs(cfg)
    elif ff:
        s["ln2"] = norm_spec(cfg)
        s["mlp"] = mlp_specs(cfg.d_model, ff, cfg.act)
    return s


def n_scanned(cfg) -> int:
    """Layers under ``"layers"``: all but a dense layer 0."""
    return cfg.n_layers - (1 if cfg.first_dense_d_ff else 0)


def model_specs(cfg):
    """PSpec tree with one entry per layer under ``"layers"`` (and the
    dense layer 0 under ``"layer0"`` where the config has one)."""
    s = {"embed": embed_specs(cfg),
         "layers": {str(i): _block_specs(cfg)
                    for i in range(n_scanned(cfg))},
         "final_norm": norm_spec(cfg)}
    if cfg.first_dense_d_ff:
        s["layer0"] = _block_specs(cfg, dense_ff=cfg.first_dense_d_ff)
    return s


class ParamTree(nn.Module):
    """Nested parameters that index like the JAX package's dict tree.
    ``requires_grad`` is off for serving and on for training."""

    def __init__(self, tree: dict, requires_grad: bool = False):
        super().__init__()
        for k, v in tree.items():
            if isinstance(v, dict):
                self.add_module(k, ParamTree(v, requires_grad))
            else:
                self.register_parameter(
                    k, nn.Parameter(v, requires_grad=requires_grad))

    def __getitem__(self, k):
        return getattr(self, k)

    def __contains__(self, k):
        return k in self._parameters or k in self._modules


class Model(nn.Module):
    """Parameters of one model: ``embed``, per-layer ``layers``, a dense
    ``layer0`` where the config has one, and ``final_norm``, built from a
    tree of tensors whose ``"layers"`` entry maps the layer index (as a
    string) to that layer's parameters.  ``requires_grad`` is off for
    serving (the engine also runs under ``torch.inference_mode``) and on
    for training."""

    def __init__(self, cfg, params: dict, requires_grad: bool = False):
        super().__init__()
        self.cfg = cfg
        self.embed = ParamTree(params["embed"], requires_grad)
        self.layers = nn.ModuleList(
            ParamTree(params["layers"][str(i)], requires_grad)
            for i in range(n_scanned(cfg)))
        if cfg.first_dense_d_ff:
            self.layer0 = ParamTree(params["layer0"], requires_grad)
        self.final_norm = nn.Parameter(params["final_norm"],
                                       requires_grad=requires_grad)

    def __getitem__(self, k):
        return getattr(self, k)

    @property
    def device(self) -> torch.device:
        return self.final_norm.device


def param_tree(model: Model) -> dict:
    """The model's parameters as a dict tree shaped like
    :func:`model_specs` (``"layers"`` maps "0", "1", ... to each layer's
    dict): the tree the optimizer, its state and the checkpoint use."""
    def walk(m):
        out = {k: walk(c) for k, c in m.named_children()}
        out.update(m.named_parameters(recurse=False))
        return out
    t = walk(model)
    t["layers"] = {str(i): t["layers"][str(i)]
                   for i in range(n_scanned(model.cfg))}
    return t


def init_model(cfg, seed: int = 0, device=None, dtype=torch.bfloat16,
               requires_grad: bool = False):
    """Random weights from the port's own init, drawn on ``device`` (the
    card unless the caller asks for the CPU) from a seeded generator.  A
    model on ``meta`` has no weights to draw: build it from
    ``layers.abstract_params(model_specs(cfg))``."""
    dev = resolve_device(device)
    if dev.type == "meta":
        raise ValueError(
            "init_model draws weights, which a meta model does not have: "
            "use Model(cfg, abstract_params(model_specs(cfg), dtype)) "
            "(repro_torch.models.layers.abstract_params)")
    g = torch.Generator(device=dev).manual_seed(seed)
    return Model(cfg, init_params(model_specs(cfg), g, dtype), requires_grad)


# ---------------------------------------------------------------------------
# one layer
# ---------------------------------------------------------------------------
def _layer(cfg, p, x, q_pos, window, cache, cache_len, mode):
    """Returns (x, new_cache_slice, aux)."""
    h = norm(cfg, x, p["ln1"])
    new_cache = {}
    parts = []
    if cfg.has_attn:
        if cfg.use_mla:
            out, nc = mla_mod.mla_block(
                p["attn"], cfg, h, q_pos,
                cache=None if cache is None else (cache["ckv"], cache["kr"]),
                cache_len=cache_len, window=0)
            if nc is not None:
                new_cache["ckv"], new_cache["kr"] = nc
            elif mode == "prefill":
                c, kr = mla_mod._project_latent(p["attn"], cfg, h, q_pos)
                new_cache["ckv"], new_cache["kr"] = c, kr
        else:
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
    aux = 0.0
    if "moe" in p:
        h2 = norm(cfg, x, p["ln2"])
        y, aux = moe_mod.moe_block(p["moe"], cfg, h2)
        x = x + y
    elif "mlp" in p:
        h2 = norm(cfg, x, p["ln2"])
        x = x + mlp(p["mlp"], h2, cfg.act)
    return x, new_cache, aux


def _layer_params(params, cfg):
    """Every layer's parameters in order: a dense layer 0 first."""
    layers = list(params["layers"])
    return [params["layer0"]] + layers if cfg.first_dense_d_ff else layers


# ---------------------------------------------------------------------------
# embedding of heterogeneous inputs
# ---------------------------------------------------------------------------
def _iota(x):
    B, S = x.shape[:2]
    return torch.arange(S, dtype=torch.int32, device=x.device).expand(B, S)


def embed_inputs(params, cfg, batch):
    """-> (x [B,S,d], positions [B,S], label_mask [B,S] or None).

    Audio: frame features (masked where ``batch["mask"]`` is 1) through
    ``frontend_proj``, computed in bf16 whatever the params' dtype, as the
    JAX package does.  Vision: the ``batch["vision"]`` embeddings ahead of
    the text tokens; a batch without them embeds the text alone (the JAX
    package raises ``KeyError`` there, so its ServeEngine cannot serve a
    text prompt to a vision model; ROADMAP.md queue 3).
    """
    if cfg.frontend == "audio":
        feats = batch["features"]
        if "mask" in batch:  # HuBERT-style masked prediction
            feats = feats * (1.0 - batch["mask"][..., None])
        x = feats.to(torch.bfloat16) @ \
            params["embed"]["frontend_proj"].to(torch.bfloat16)
        return x, _iota(x), batch.get("mask")
    if cfg.frontend == "vision" and "vision" in batch:
        tok = embed(params["embed"], cfg, batch["tokens"])
        vis = batch["vision"].to(tok.dtype)
        x = torch.cat([vis, tok], dim=1)
        mask = torch.cat([torch.zeros(vis.shape[:2], device=x.device),
                          torch.ones(tok.shape[:2], device=x.device)], dim=1)
        return x, _iota(x), mask
    x = embed(params["embed"], cfg, batch["tokens"])
    return x, _iota(x), None


# ---------------------------------------------------------------------------
# forward (train / prefill / decode), a Python loop over layers
# ---------------------------------------------------------------------------
IN_PLACE = ("k", "v", "ckv", "kr")   # cache entries decode writes in place

# cfg.remat -> extra arguments of torch.utils.checkpoint.checkpoint.
# "block" and "full" keep nothing of a layer (the JAX package's
# nothing_saveable); "dots" keeps the outputs of the matrix products
# without batch dims (dots_with_no_batch_dims_saveable: aten.mm / addmm,
# not bmm) and recomputes the rest.
_REMAT = {"dots": dict(context_fn=partial(
    create_selective_checkpoint_contexts,
    [torch.ops.aten.mm.default, torch.ops.aten.addmm.default]))}


def forward(params, cfg, batch, mode: str = "train", cache=None,
            positions=None, cache_len=None):
    """Forward pass, a Python loop over layers.

    train:   batch -> logits [B,S,Vp], aux
    prefill: batch -> logits, cache (stacked [L,...], layer 0 first), aux
    decode:  batch['tokens'] [B,1] + cache + positions [B,1] -> logits,
             cache.  K/V (or MLA's latent ``ckv``/``kr``) are written into
             the cache tensors in place; the conv and SSM states come back
             as new tensors.
    ``aux`` (the MoE load-balancing loss) is the mean over the layers of
    ``"layers"``: a dense layer 0 adds nothing and does not count, as in
    the JAX package.  In ``train`` mode with gradients on and
    ``cfg.remat != "none"``, each layer runs under
    ``torch.utils.checkpoint`` (as the JAX package's ``jax.checkpoint``),
    so its kernels launch again in the backward pass.  Inside
    ``parallel.sharding.activation_sharding`` (the dry run's trace) each
    layer's input and the logits record their activation specs where the
    reference constrains them; elsewhere ``constrain`` does nothing.
    Inside a traced task (a train step's ``forward``, an engine's
    ``prefill`` or ``decode``), each layer is a ``layer`` task under it.
    """
    assert mode in ("train", "prefill", "decode")
    if mode == "decode":
        x = embed(params["embed"], cfg, batch["tokens"])
        q_pos = positions
    else:
        x, q_pos, _ = embed_inputs(params, cfg, batch)

    windows = cfg.layer_windows()
    layer = partial(_layer, cfg)
    if mode == "train" and cfg.remat != "none" and torch.is_grad_enabled():
        layer = partial(checkpoint, layer, use_reentrant=False,
                        **_REMAT.get(cfg.remat, {}))
    ncs, aux = [], 0.0
    n0 = 1 if cfg.first_dense_d_ff else 0
    for li, p in enumerate(_layer_params(params, cfg)):
        c = None if cache is None else {k: t[li] for k, t in cache.items()}
        if li >= n0:        # the reference's scan body; layer0 is outside
            x = constrain(x, "fsdp", None, None)
        with subtask("layer", str(li), "model"):
            x, nc, a = layer(p, x, q_pos, windows[li], c, cache_len, mode)
        ncs.append(nc)
        aux = aux + a

    x = norm(cfg, x, params["final_norm"])
    logits = constrain(unembed(params["embed"], cfg, x), "fsdp", None,
                       "tensor")
    aux = aux / max(n_scanned(cfg), 1)

    new_cache = None
    if mode in ("prefill", "decode") and ncs[0]:
        new_cache = {}
        for k in ncs[0]:
            if cache is not None and k in IN_PLACE:
                new_cache[k] = cache[k]        # updated in place
            else:
                new_cache[k] = torch.stack([nc[k] for nc in ncs])
    return logits, new_cache, aux


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
    (the card unless the caller asks for the CPU).  K/V (MLA: the latent
    ``ckv`` and rope key ``kr``) and the conv state are ``dtype`` (bf16 by
    default, whatever the params are); the SSM state is f32."""
    device = resolve_device(device)
    L = cfg.n_layers

    def zeros(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)
    c = {}
    if cfg.has_attn:
        if cfg.use_mla:
            c["ckv"] = zeros(L, B, S_max, cfg.kv_lora)
            c["kr"] = zeros(L, B, S_max, cfg.qk_rope_dim)
        else:
            kvh, hd = cfg.n_kv_heads, cfg.head_dim
            c["k"] = zeros(L, B, S_max, kvh, hd)
            c["v"] = zeros(L, B, S_max, kvh, hd)
    if cfg.has_ssm:
        conv_dim = cfg.d_inner + 2 * cfg.ssm_state
        c["conv"] = zeros(L, B, cfg.conv_kernel - 1, conv_dim)
        c["ssm"] = zeros(L, B, cfg.n_ssm_heads, cfg.ssm_headdim,
                         cfg.ssm_state, dt=torch.float32)
    return c


def init_cache_unrolled(cfg, B: int, S_max: int, dtype=torch.bfloat16,
                        device=None):
    """Heterogeneous cache: a ring buffer of ``window`` slots for each
    sliding-window layer whose window is below ``S_max``, ``S_max`` slots
    for the others.  ``pos`` holds each slot's absolute position, -1 while
    it is empty."""
    device = resolve_device(device)
    c = {"layers": []}
    for w in cfg.layer_windows():
        lc = {}
        if cfg.has_attn:
            kvh, hd = cfg.n_kv_heads, cfg.head_dim
            S = min(w, S_max) if 0 < w < S_max else S_max
            lc["k"] = torch.zeros((B, S, kvh, hd), dtype=dtype, device=device)
            lc["v"] = torch.zeros((B, S, kvh, hd), dtype=dtype, device=device)
            lc["pos"] = torch.full((B, S), -1, dtype=torch.int32,
                                   device=device)
        if cfg.has_ssm:
            conv_dim = cfg.d_inner + 2 * cfg.ssm_state
            lc["conv"] = torch.zeros((B, cfg.conv_kernel - 1, conv_dim),
                                     dtype=dtype, device=device)
            lc["ssm"] = torch.zeros((B, cfg.n_ssm_heads, cfg.ssm_headdim,
                                     cfg.ssm_state), dtype=torch.float32,
                                    device=device)
        c["layers"].append(lc)
    return c


def decode_unrolled(params, cfg, tokens, cache, positions):
    """One decode step, layer by layer, each layer against its own cache
    group (ring or full).  The new K/V and position go to slot
    ``positions % S`` of the layer's buffers, in place; the conv and SSM
    states come back as new tensors.  -> (logits, cache)."""
    x = embed(params["embed"], cfg, tokens)
    B = x.shape[0]
    ws = cfg.layer_windows()
    bidx = torch.arange(B, device=x.device)[:, None]
    new_layers = []
    for li, p in enumerate(_layer_params(params, cfg)):
        lc = cache["layers"][li]
        nlc = dict(lc)
        h = norm(cfg, x, p["ln1"])
        parts = []
        if cfg.has_attn:
            a = p["attn"]
            q = torch.einsum("bsd,dhe->bshe", h, a["wq"].to(h.dtype))
            k = torch.einsum("bsd,dke->bske", h, a["wk"].to(h.dtype))
            v = torch.einsum("bsd,dke->bske", h, a["wv"].to(h.dtype))
            q = attn_mod.rope(q, positions, cfg.rope_theta)
            k = attn_mod.rope(k, positions, cfg.rope_theta)
            kk, vv, pp = lc["k"], lc["v"], lc["pos"]
            slot = (positions % kk.shape[1]).long()            # ring write
            kk[bidx, slot] = k.to(kk.dtype)
            vv[bidx, slot] = v.to(vv.dtype)
            pp[bidx, slot] = positions.to(torch.int32)
            out = attn_mod.blockwise_attention(
                q, kk, vv, positions, pp, causal=cfg.causal, window=ws[li],
                cap=cfg.attn_softcap)
            out, wo = promote(out, a["wo"].to(h.dtype))
            parts.append(torch.einsum("bshe,hed->bsd", out, wo))
        if cfg.has_ssm:
            out2, (cs, hs) = ssm_mod.ssm_block(
                p["ssm"], cfg, h, cache=(lc["conv"], lc["ssm"]))
            nlc.update(conv=cs, ssm=hs)
            parts.append(out2)
        x = x + (parts[0] if len(parts) == 1 else 0.5 * (parts[0] + parts[1]))
        if "moe" in p:
            y, _ = moe_mod.moe_block(p["moe"], cfg, norm(cfg, x, p["ln2"]))
            x = x + y
        elif "mlp" in p:
            x = x + mlp(p["mlp"], norm(cfg, x, p["ln2"]), cfg.act)
        new_layers.append(nlc)
    x = norm(cfg, x, params["final_norm"])
    return unembed(params["embed"], cfg, x), {"layers": new_layers}


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------
def train_loss(params, cfg, batch, aux_coef: float = 0.01,
               z_loss: float = 1e-4):
    """Next-token loss (audio: masked-frame prediction of ``labels``;
    vision: the text after the vision tokens) plus ``aux_coef`` times the
    MoE load-balancing loss."""
    logits, _, aux = forward(params, cfg, batch, mode="train")
    if cfg.frontend == "audio":
        loss = cross_entropy(logits, batch["labels"], mask=batch.get("mask"),
                             z_loss=z_loss)
    elif cfg.frontend == "vision":
        nv = batch["vision"].shape[1]
        loss = cross_entropy(logits[:, nv:-1], batch["tokens"][:, 1:],
                             z_loss=z_loss)
    else:
        loss = cross_entropy(logits[:, :-1], batch["tokens"][:, 1:],
                             z_loss=z_loss)
    return loss + aux_coef * aux
