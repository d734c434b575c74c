"""Serving steps: prefill (context -> cache) and decode (one token against
the cache), with cache PartitionSpecs for the production meshes.
Counterpart of ``repro.serve.step``.

The steps are plain functions over the port's ``forward`` /
``decode_unrolled`` and the greedy argmax (``ServeEngine`` drives the same
model calls on the card).  :func:`assemble_decode` and
:func:`assemble_prefill` give a step with ``meta`` arguments and the
PartitionSpecs of its arguments and results on a mesh, for the dry run.

Cache sharding rules (as the reference's):
* batch over (pod, data) when divisible;
* GQA KV heads over 'model' when divisible, else head_dim over 'model'
  (deepseek-67b/grok/internvl: kv=8 < tp=16 -> shard the 128-wide head_dim);
* MLA latent: kv_lora (512) over 'model';
* long_500k (batch=1): sequence dimension over 'data';
* SSM states: batch-sharded only (O(1) size).
"""
from __future__ import annotations

import torch

from repro_torch.models import transformer as tfm
from repro_torch.models.layers import abstract_params, make_pspecs
from repro_torch.parallel.sharding import (P, batch_pspec,
                                           make_rules_for_mesh)
from repro_torch.train.step import Assembled, abstract_batch, batch_pspecs


def cache_pspecs(cfg, mesh, B: int, S: int, unrolled: bool):
    tp = mesh.shape["model"]
    bp = batch_pspec(mesh, B)              # P over batch dim (maybe empty)
    b0 = bp[0] if len(bp) else None
    seq = "data" if (b0 is None and S % mesh.shape["data"] == 0) else None
    kv_ax = "model" if (cfg.n_kv_heads and cfg.n_kv_heads % tp == 0) else None
    hd_ax = "model" if (kv_ax is None and cfg.head_dim
                        and cfg.head_dim % tp == 0) else None

    def attn_specs(with_layer):
        lead = (None,) if with_layer else ()
        return {"k": P(*lead, b0, seq, kv_ax, hd_ax),
                "v": P(*lead, b0, seq, kv_ax, hd_ax)}

    def mla_specs(with_layer):
        lead = (None,) if with_layer else ()
        lat = "model" if cfg.kv_lora % tp == 0 else None
        return {"ckv": P(*lead, b0, seq, lat), "kr": P(*lead, b0, seq, None)}

    def ssm_specs(with_layer):
        lead = (None,) if with_layer else ()
        return {"conv": P(*lead, b0, None, None),
                "ssm": P(*lead, b0, None, None, None)}

    if unrolled:
        # every layer's K/V takes the same sequence spec, ring or full:
        # the reference computes a per-layer one and never uses it
        per_layer = []
        for _ in cfg.layer_windows():
            lc = {}
            if cfg.has_attn:
                lc.update(attn_specs(False))
                lc["pos"] = P(b0, None)
            if cfg.has_ssm:
                lc.update(ssm_specs(False))
            per_layer.append(lc)
        return {"layers": per_layer}
    c = {}
    if cfg.has_attn:
        c.update(mla_specs(True) if cfg.use_mla else attn_specs(True))
    if cfg.has_ssm:
        c.update(ssm_specs(True))
    return c


def _greedy(logits):
    return torch.argmax(logits[:, -1], dim=-1).to(torch.int32)


def make_decode_step(cfg, unrolled: bool):
    """``decode_step(model, cache, tokens, positions) -> (next tokens
    [B] int32, cache)``; K/V are written into the cache in place."""
    def decode_step(params, cache, tokens, positions):
        if unrolled:
            logits, cache = tfm.decode_unrolled(params, cfg, tokens, cache,
                                                positions)
        else:
            logits, cache, _ = tfm.forward(
                params, cfg, {"tokens": tokens}, mode="decode", cache=cache,
                positions=positions, cache_len=positions + 1)
        return _greedy(logits), cache

    return decode_step


def make_prefill_step(cfg):
    """``prefill_step(model, batch) -> (next tokens [B] int32, stacked
    cache)``."""
    def prefill_step(params, batch):
        logits, cache, _ = tfm.forward(params, cfg, batch, mode="prefill")
        return _greedy(logits), cache

    return prefill_step


def _meta_model(cfg, mesh):
    specs = tfm.model_specs(cfg)
    p_pspecs = make_pspecs(specs, make_rules_for_mesh(cfg, mesh))
    return tfm.Model(cfg, abstract_params(specs)), p_pspecs


def assemble_decode(cfg, mesh, shape):
    """The decode step with ``meta`` (model, cache, tokens, positions)
    and their specs on ``mesh``."""
    B, S = shape.global_batch, shape.seq_len
    unrolled = tfm.needs_unrolled_decode(cfg, S)
    model, p_pspecs = _meta_model(cfg, mesh)
    cache_fn = tfm.init_cache_unrolled if unrolled else tfm.init_cache
    cache = cache_fn(cfg, B, S, device="meta")
    c_pspecs = cache_pspecs(cfg, mesh, B, S, unrolled)
    bp = batch_pspec(mesh, B)
    b0 = bp[0] if len(bp) else None
    tok = torch.empty((B, 1), dtype=torch.int32, device="meta")
    pos = torch.empty((B, 1), dtype=torch.int32, device="meta")
    tp_spec = P(b0, None)
    return Assembled(make_decode_step(cfg, unrolled),
                     (model, cache, tok, pos),
                     (p_pspecs, c_pspecs, tp_spec, tp_spec),
                     (P(b0), c_pspecs))


def assemble_prefill(cfg, mesh, shape):
    """The prefill step with ``meta`` (model, batch) and their specs on
    ``mesh``; the cache comes out stacked."""
    model, p_pspecs = _meta_model(cfg, mesh)
    B, S = shape.global_batch, shape.seq_len
    bp = batch_pspec(mesh, B)
    c_pspecs = cache_pspecs(cfg, mesh, B, S, unrolled=False)
    return Assembled(make_prefill_step(cfg),
                     (model, abstract_batch(cfg, shape)),
                     (p_pspecs, batch_pspecs(cfg, mesh, shape)),
                     (P(bp[0] if len(bp) else None), c_pspecs))
