"""Multi-head Latent Attention (DeepSeek-V2): the materialised form for
train and prefill, the absorbed form for decode.  Counterpart of
``repro.models.mla``.

MLA compresses K/V into a low-rank latent c_kv (``kv_lora`` dims) plus one
RoPE key (``qk_rope_dim``) shared by all heads.  Prefill materialises each
head's K/V from the latent and attends with :func:`blockwise_attention`,
as the JAX package does (no Pallas kernel on this path).  Decode folds the
K up-projection into the query, so attention runs against the cached
latent: the cache holds kv_lora + rope values a token (576 at
deepseek-v2's widths) instead of 2 * H * hd.
"""
from __future__ import annotations

import math

import torch

from .attention import blockwise_attention, rope
from .layers import PSpec, matmul, promote, rmsnorm

NEG = -1e30


def mla_specs(cfg):
    d, H = cfg.d_model, cfg.n_heads
    qd = cfg.qk_nope_dim + cfg.qk_rope_dim
    return {"wq_a": PSpec((d, cfg.q_lora), ("fsdp", None)),
            "wq_b": PSpec((cfg.q_lora, H, qd), (None, "tensor_q", None)),
            "wkv_a": PSpec((d, cfg.kv_lora + cfg.qk_rope_dim),
                           ("fsdp", None)),
            "wk_b": PSpec((cfg.kv_lora, H, cfg.qk_nope_dim),
                          (None, "tensor_q", None)),
            "wv_b": PSpec((cfg.kv_lora, H, cfg.v_head_dim),
                          (None, "tensor_q", None)),
            "wo": PSpec((H, cfg.v_head_dim, d), ("tensor_q", None, "fsdp")),
            "q_norm": PSpec((cfg.q_lora,), (None,), "zeros"),
            "kv_norm": PSpec((cfg.kv_lora,), (None,), "zeros")}


def _project_q(params, cfg, x, q_pos):
    qa = rmsnorm(matmul(x, params["wq_a"].to(x.dtype)), params["q_norm"])
    q = torch.einsum("bsl,lhe->bshe", qa, params["wq_b"].to(x.dtype))
    q_nope, q_rope = q[..., :cfg.qk_nope_dim], q[..., cfg.qk_nope_dim:]
    return q_nope, rope(q_rope, q_pos, cfg.rope_theta)


def _project_latent(params, cfg, x, pos):
    kv = matmul(x, params["wkv_a"].to(x.dtype))
    c_kv = rmsnorm(kv[..., :cfg.kv_lora], params["kv_norm"])
    k_rope = rope(kv[..., cfg.kv_lora:][:, :, None, :], pos, cfg.rope_theta)
    return c_kv, k_rope[:, :, 0, :]


def absorbed_attention(params, cfg, q_nope, q_rope, c_c, kr_c, q_pos,
                       kv_pos, *, scale):
    """Attention of the queries against the latent cache, with ``wk_b``
    folded into q and ``wv_b`` applied after the sum over keys.

    q_nope [B,Sq,H,nope], q_rope [B,Sq,H,rope]; c_c [B,S,kv_lora], kr_c
    [B,S,rope]; q_pos [B,Sq]; kv_pos [B,S] (< 0: empty slot) ->
    [B,Sq,H,v_head_dim].  The softmax runs in f32 and its probabilities
    are cast to the queries' dtype before the value side, as in the JAX
    package."""
    dt = q_nope.dtype
    valid = (kv_pos >= 0)[:, None, None, :]                    # [B,1,1,S]
    q_abs = torch.einsum("bshe,lhe->bshl", q_nope,
                         params["wk_b"].to(dt))                # [B,Sq,H,L]
    # f32 scores from exactly widened operands (preferred_element_type)
    s = (torch.einsum("bshl,btl->bhst", q_abs.float(), c_c.float())
         + torch.einsum("bshe,bte->bhst", q_rope.float(), kr_c.float())
         ) * scale
    if cfg.causal:
        valid = valid & (kv_pos[:, None, None, :] <= q_pos[:, None, :, None])
    p = torch.softmax(torch.where(valid, s, NEG), dim=-1)
    ctx = torch.einsum("bhst,btl->bshl", *promote(p.to(dt), c_c))
    return torch.einsum("bshl,lhe->bshe",
                        *promote(ctx, params["wv_b"].to(dt)))


def mla_block(params, cfg, x, q_pos, *, cache=None, cache_len=None,
              window=0):
    """cache: (c_kv [B,S,kv_lora], k_rope [B,S,rope]), the latent cache.
    Decode writes the new token(s) into both IN PLACE at q_pos (the JAX
    package returns updated copies) and returns (out, cache)."""
    B, Sq, _ = x.shape
    H = cfg.n_heads
    scale = 1.0 / math.sqrt(cfg.qk_nope_dim + cfg.qk_rope_dim)
    q_nope, q_rope = _project_q(params, cfg, x, q_pos)
    c_new, kr_new = _project_latent(params, cfg, x, q_pos)

    if cache is None:
        # train/prefill: per-head K/V materialised from the latent
        k_nope = torch.einsum("bsl,lhe->bshe", c_new,
                              params["wk_b"].to(x.dtype))
        vv = torch.einsum("bsl,lhe->bshe", c_new, params["wv_b"].to(x.dtype))
        kk = torch.cat([k_nope, kr_new[:, :, None, :].expand(
            B, Sq, H, cfg.qk_rope_dim)], dim=-1)
        qq = torch.cat([q_nope, q_rope], dim=-1)
        out = blockwise_attention(qq, kk, vv, q_pos, q_pos,
                                  causal=cfg.causal, window=window,
                                  scale=scale)
        new_cache = None
    else:
        # absorbed decode: wk_b folded into q, attention on the latent
        c_c, kr_c = cache
        S = c_c.shape[1]
        idx = q_pos.long()
        b = torch.arange(B, device=x.device)[:, None]
        c_c[b, idx] = c_new.to(c_c.dtype)
        kr_c[b, idx] = kr_new.to(kr_c.dtype)
        new_cache = (c_c, kr_c)
        pos = torch.arange(S, device=x.device)[None, :]
        limit = cache_len if cache_len is not None else q_pos[:, -1:] + 1
        kv_pos = torch.where(pos <= limit - 1, pos, -1)
        out = absorbed_attention(params, cfg, q_nope, q_rope, c_c, kr_c,
                                 idx, kv_pos, scale=scale)
    o = torch.einsum("bshe,hed->bsd", *promote(out, params["wo"].to(x.dtype)))
    return o, new_cache
