"""Plain PyTorch versions: the blockwise online-softmax attention of the
model library, at self-attention positions, and the backward kernel's
algebra (FlashAttention-2's, from the forward's log-sum-exp)."""
from __future__ import annotations

import math

import torch

from repro_torch.models.attention import NEG, blockwise_attention


def flash_attention_ref(q, k, v, *, causal=True, window=0, cap=0.0,
                        scale=None):
    B, Sq = q.shape[:2]
    Sk = k.shape[1]
    q_pos = torch.arange(Sq, device=q.device).expand(B, Sq)
    kv_pos = torch.arange(Sk, device=q.device).expand(B, Sk)
    return blockwise_attention(q, k, v, q_pos, kv_pos, causal=causal,
                               window=window, cap=cap, scale=scale)


def _scores(q, k, q0, causal, window, cap, scale):
    """Queries q [B,c,H,hd] at positions q0.. against every key: the
    scaled (and capped) scores [B,KV,G,c,Sk] in f32 (f64 for f64 inputs),
    tanh of the capped ones (None without a cap) and the mask [c,Sk]."""
    B, c, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    wide = torch.float64 if q.dtype == torch.float64 else torch.float32
    x = torch.einsum("bqkgd,bskd->bkgqs",
                     q.reshape(B, c, KV, H // KV, hd).to(wide),
                     k.to(wide)) * scale
    t = None
    if cap:
        t = torch.tanh(x / cap)
        x = cap * t
    qp = torch.arange(q0, q0 + c, device=q.device)[:, None]
    kp = torch.arange(Sk, device=q.device)[None, :]
    m = torch.ones((c, Sk), dtype=torch.bool, device=q.device)
    if causal:
        m = m & (kp <= qp)
    if window > 0:
        m = m & (qp - kp < window)
    return x, t, m


def attention_lse_ref(q, k, *, causal=True, window=0, cap=0.0, scale=None,
                      chunk=1024):
    """Each row's log-sum-exp of the scaled, capped and masked scores, f32
    (f64 for f64 inputs) [B,H,Sq]: what the bf16 kernel's forward saves
    for its backward (masked scores are NEG, as in the forward)."""
    B, Sq, H, hd = q.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    out = []
    for q0 in range(0, Sq, chunk):
        x, _, m = _scores(q[:, q0:q0 + chunk], k, q0, causal, window, cap,
                          scale)
        x = torch.where(m, x, NEG)
        out.append(torch.logsumexp(x, dim=-1).reshape(B, H, -1))
    return torch.cat(out, dim=-1)


def flash_attention_bwd_ref(q, k, v, out, lse, dout, *, causal=True,
                            window=0, cap=0.0, scale=None, chunk=1024):
    """(dq, dk, dv) of :func:`flash_attention_ref` at q, k, v for the
    upstream gradient ``dout``, by the backward kernel's algebra, in f32
    (f64 for f64 inputs), ``chunk`` query positions at a time:

      P = exp(s - lse) where the masks keep (s the scaled, capped score),
      D = rowsum(dout * out), dV = P^T dout, dP = dout V^T,
      dS = P (dP - D) (1 - tanh^2 of the capped score) scale,
      dQ = dS K, dK = dS^T Q, summed over each KV head's query heads.

    ``out`` [B,Sq,H,hd] and ``lse`` [B,H,Sq] are the forward's.  Returns
    the gradients in the inputs' dtype."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    wide = torch.float64 if q.dtype == torch.float64 else torch.float32
    kw, vw = k.to(wide), v.to(wide)
    dq = torch.empty((B, Sq, H, hd), dtype=wide, device=q.device)
    dk = torch.zeros((B, Sk, KV, hd), dtype=wide, device=q.device)
    dv = torch.zeros_like(dk)
    for q0 in range(0, Sq, chunk):
        sl = slice(q0, q0 + chunk)
        qc = q[:, sl]
        c = qc.shape[1]
        x, t, m = _scores(qc, k, q0, causal, window, cap, scale)
        lc = lse[:, :, sl].to(wide).reshape(B, KV, G, c, 1)
        p = torch.where(m, torch.exp(x - lc), 0.0)            # [B,KV,G,c,Sk]
        do = dout[:, sl].to(wide).reshape(B, c, KV, G, hd)
        D = (do * out[:, sl].to(wide).reshape(B, c, KV, G, hd)).sum(-1)
        dv += torch.einsum("bkgqs,bqkgd->bskd", p, do)
        dp = torch.einsum("bqkgd,bskd->bkgqs", do, vw)
        ds = p * (dp - D.permute(0, 2, 3, 1)[..., None])
        if t is not None:
            ds = ds * (1 - t * t)
        ds = ds * scale
        dq[:, sl] = torch.einsum("bkgqs,bskd->bqkgd", ds, kw) \
            .reshape(B, c, H, hd)
        dk += torch.einsum("bkgqs,bqkgd->bskd", ds,
                           qc.to(wide).reshape(B, c, KV, G, hd))
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)
