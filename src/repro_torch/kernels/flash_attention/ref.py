"""Plain PyTorch version: the blockwise online-softmax attention of the
model library, at self-attention positions."""
from __future__ import annotations

import torch

from repro_torch.models.attention import blockwise_attention


def flash_attention_ref(q, k, v, *, causal=True, window=0, cap=0.0,
                        scale=None):
    B, Sq = q.shape[:2]
    Sk = k.shape[1]
    q_pos = torch.arange(Sq, device=q.device).expand(B, Sq)
    kv_pos = torch.arange(Sk, device=q.device).expand(B, Sk)
    return blockwise_attention(q, k, v, q_pos, kv_pos, causal=causal,
                               window=window, cap=cap, scale=scale)
