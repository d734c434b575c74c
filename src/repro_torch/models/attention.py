"""GQA attention: RoPE, causal/sliding-window masks, logit softcap, and the
blockwise online-softmax attention.  Counterpart of
``repro.models.attention``.

Prefill self-attention goes to ``kernels.flash_attention.ops``: the CUDA
kernel for a tensor on the card, its plain version for one on the CPU.
Decode attends against the cache with :func:`blockwise_attention` in plain
PyTorch, as the JAX package computes it outside any Pallas kernel.
"""
from __future__ import annotations

import math

import torch

from .layers import PSpec, promote, softcap

NEG = -1e30


def rope(x, positions, theta: float):
    """Rotary embedding. x: [..., S, H, hd]; positions: [..., S]."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = torch.exp(-math.log(theta) * torch.arange(
        half, dtype=torch.float32, device=x.device) / half)
    ang = positions.float()[..., None] * freqs                # [..., S, half]
    ang = ang[..., None, :]                                   # [..., S, 1, half]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def attn_specs(cfg):
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {"wq": PSpec((d, H, hd), ("fsdp", "tensor_q", None)),
            "wk": PSpec((d, KV, hd), ("fsdp", "tensor_kv", None)),
            "wv": PSpec((d, KV, hd), ("fsdp", "tensor_kv", None)),
            "wo": PSpec((H, hd, d), ("tensor_q", None, "fsdp"))}


def _mask(q_pos, kv_pos, causal, window):
    """q_pos [B,Sq], kv_pos [B,Sk] -> bool [B,Sq,Sk]; kv_pos<0 = invalid.
    ``window`` <= 0 means full attention."""
    qp = q_pos[:, :, None]
    kp = kv_pos[:, None, :]
    m = kp >= 0
    if causal:
        m = m & (kp <= qp)
    if window > 0:
        m = m & (qp - kp < window)
    return m


def blockwise_attention(q, k, v, q_pos, kv_pos, *, causal=True, window=0,
                        cap=0.0, scale=None, chunk=1024, probs_bf16=False):
    """Online-softmax attention.

    q: [B,Sq,H,hd]; k,v: [B,Sk,KV,hd]; q_pos: [B,Sq]; kv_pos: [B,Sk]
    (kv_pos < 0 marks invalid cache slots).  Returns [B,Sq,H,hd].
    Scores and the softmax are f32 (f64 for f64 inputs, which the
    gradient checks use).
    """
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    hd_v = v.shape[-1]
    G = H // KV
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    wide = torch.float64 if q.dtype == torch.float64 else torch.float32
    qf = q.reshape(B, Sq, KV, G, hd).to(wide)

    def scores_of(kc, kvp):
        # f32 scores from (exactly widened) inputs: preferred_element_type
        s = torch.einsum("bqkgd,bskd->bkgqs", qf, kc.to(wide)) * scale
        if cap:
            s = softcap(s, cap)
        m = _mask(q_pos, kvp, causal, window)            # [B,Sq,ck]
        return torch.where(m[:, None, None, :, :], s, NEG)

    if Sk <= chunk:
        s = scores_of(k, kv_pos)
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bkgqs,bskd->bqkgd", p.to(v.dtype), v)
        return o.reshape(B, Sq, H, hd_v)

    n = -(-Sk // chunk)
    pad = n * chunk - Sk
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        kv_pos = torch.nn.functional.pad(kv_pos, (0, pad), value=-1)

    m = torch.full((B, KV, G, Sq), NEG, dtype=wide, device=q.device)
    l = torch.zeros((B, KV, G, Sq), dtype=wide, device=q.device)
    acc = torch.zeros((B, KV, G, Sq, hd_v), dtype=wide, device=q.device)
    for c in range(n):
        sl = slice(c * chunk, (c + 1) * chunk)
        kc, vc, kvp = k[:, sl], v[:, sl], kv_pos[:, sl]
        s = scores_of(kc, kvp)                            # [B,KV,G,Sq,ck]
        m2 = torch.maximum(m, torch.amax(s, dim=-1))
        p = torch.exp(s - m2[..., None])
        corr = torch.exp(m - m2)
        l = l * corr + torch.sum(p, dim=-1)
        if probs_bf16:   # bf16 operands, f32 accumulation
            pv = torch.einsum("bkgqs,bskd->bkgqd",
                              p.to(torch.bfloat16).float(),
                              vc.to(torch.bfloat16).float())
        else:
            pv = torch.einsum("bkgqs,bskd->bkgqd", p, vc.to(wide))
        acc = acc * corr[..., None] + pv
        m = m2
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd_v).to(q.dtype)


def attention_block(params, cfg, x, q_pos, *, window, cache=None,
                    cache_len=None):
    """Full attention sub-block: qkv proj, rope, attend, out proj.

    Training/prefill: cache=None -> self-attention over x through the
    flash-attention kernel (or its plain version on the CPU).
    Decode: cache=(k_cache [B,S,KV,hd], v_cache); the new token(s) are
    written into the cache tensors IN PLACE at q_pos (the JAX package
    returns updated copies); returns (out, (k_cache, v_cache)).
    """
    B, Sq, _ = x.shape
    q = torch.einsum("bsd,dhe->bshe", x, params["wq"].to(x.dtype))
    k = torch.einsum("bsd,dke->bske", x, params["wk"].to(x.dtype))
    v = torch.einsum("bsd,dke->bske", x, params["wv"].to(x.dtype))
    q = rope(q, q_pos, cfg.rope_theta)
    k = rope(k, q_pos, cfg.rope_theta)

    if cache is None:
        from repro_torch.kernels.flash_attention import ops as fa
        out = fa.flash_attention(q, k, v, q_pos, q_pos, causal=cfg.causal,
                                 window=window, cap=cfg.attn_softcap)
        new_cache = None
    else:
        ck, cv = cache
        S = ck.shape[1]
        idx = q_pos.long()                                    # [B,Sq]
        bidx = torch.arange(B, device=x.device)[:, None]
        ck[bidx, idx] = k.to(ck.dtype)
        cv[bidx, idx] = v.to(cv.dtype)
        new_cache = (ck, cv)
        pos = torch.arange(S, device=x.device)[None, :]
        limit = (cache_len if cache_len is not None
                 else q_pos[:, -1:] + 1)                       # [B,1]
        kv_pos = torch.where(pos <= limit - 1, pos, -1)
        out = blockwise_attention(
            q, ck, cv, q_pos, kv_pos, causal=cfg.causal, window=window,
            cap=cfg.attn_softcap, probs_bf16=cfg.attn_probs_bf16)
    out, wo = promote(out, params["wo"].to(x.dtype))
    return torch.einsum("bshe,hed->bsd", out, wo), new_cache
