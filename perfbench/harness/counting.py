"""The yardstick's arithmetic: the card's peaks, the roofline bound, the
work of the two hand-written kernels counted from their shapes, and the
model FLOPs of a decoder configuration.

``attn_pairs``, ``ssd_ops`` and ``bound`` are frozen copies of the
functions of the same names in ``chip_smoke.py`` (there ``_attn_pairs``,
``_ssd_ops``, ``bound``), so that a change to the program never moves the
benchmark's rulers.  Every count is of the work the algorithm needs at
these shapes, whatever implements it: each input byte is read once and
each output byte written once.
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates, at the full 700 W limit
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 494.7e12 / 3}
A_BYTES = 2              # the served activations and cache: bf16


def bound(nbytes, ops, dtype_name):
    """-> (least time in ms, "bytes" or "operations": which one bounds)."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[dtype_name]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def attn_pairs(S, causal, window):
    """(q, k) pairs the masks keep at self-attention positions."""
    if not causal:
        return S * (S if window <= 0 else min(S, window))
    if window <= 0:
        return S * (S + 1) // 2
    # closed form of sum(min(q + 1, window) for q in range(S))
    w = min(window, S)
    return w * (w + 1) // 2 + (S - w) * window


def ssd_ops(B, S, H, P, N, chunk):
    """Operations of the chunked form at these shapes (per step pair inside
    a chunk: C.B, decay, dt and the P-wide product; per step: the
    inter-chunk read and the state update)."""
    ops = 0
    for c0 in range(0, S, chunk):
        ln = min(chunk, S - c0)
        pairs = ln * (ln + 1) // 2
        ops += pairs * (2 * N + 3 + 2 * P) + ln * (2 * N * P + 2 * P) \
            + ln * (2 * P * N + 2) + 2 * P * N
    return B * H * ops


# ---------------------------------------------------------------------------
# one kernel call
# ---------------------------------------------------------------------------
def flash_call(B, S, H, KV, hd, window):
    """(bytes, ops) of one causal self-attention forward in bf16: q, k and
    v read, the output written; 4 operations a kept (q, k) pair and head
    dim."""
    nbytes = B * S * (2 * H + 2 * KV) * hd * A_BYTES
    return nbytes, 4 * B * H * hd * attn_pairs(S, True, window)


def decode_attn(ctx, H, KV, hd, window):
    """(bytes, ops) of one decoded token's attention in one layer over a
    bf16 cache: its query read and output written, the keys and values
    of the ``ctx`` positions it sees (itself included), windows applied."""
    keys = min(ctx, window) if window > 0 else ctx
    nbytes = (2 * H * hd + 2 * KV * hd * keys) * A_BYTES
    return nbytes, 4 * H * hd * keys


def ssd_call(B, S, H, P, N, chunk):
    """(bytes, ops) of one SSD forward as the model calls it: x, B and C in
    bf16, dt and A in f32; y out in bf16, the final state in f32."""
    a = A_BYTES
    nbytes = (B * S * H * P * a * 2          # x in, y out
              + B * S * H * 4 + H * 4        # dt, A
              + 2 * B * S * N * a            # B, C
              + B * H * P * N * 4)           # final state
    return nbytes, ssd_ops(B, S, H, P, N, chunk)


# ---------------------------------------------------------------------------
# a decoder configuration (the keys of perfbench/configs/*.json)
# ---------------------------------------------------------------------------
def layer_windows(cfg):
    """Each layer's attention window, 0 for a full (global) layer."""
    L, w = cfg["n_layers"], cfg.get("window", 0)
    pattern = cfg.get("attn_pattern", "full")
    if pattern == "global3":
        g = {0, L // 2, L - 1}
        return [0 if i in g else w for i in range(L)]
    if pattern == "alt":
        return [w if i % 2 == 0 else 0 for i in range(L)]
    return [w] * L


def ssm_dims(cfg):
    """(heads, head dim, state, inner width) of the SSM, or None."""
    N = cfg.get("ssm_state", 0)
    if not N:
        return None
    di = cfg.get("ssm_expand", 2) * cfg["d_model"]
    P = cfg.get("ssm_headdim", 64)
    return di // P, P, N, di


def matmul_params(cfg):
    """Weights that enter a matrix product once a token: every layer's
    projections and MLP, and the output head over the real vocabulary.
    The embedding is a lookup, the norms and the SSM's per-head vectors
    and depthwise conv are not products of matrices."""
    d, H, KV, hd = cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"], \
        cfg["head_dim"]
    per = 0
    if H:
        per += 2 * d * H * hd + 2 * d * KV * hd
    s = ssm_dims(cfg)
    if s:
        Hs, P, N, di = s
        per += d * (2 * di + 2 * N + Hs) + di * d
    per += (3 if cfg.get("act", "swiglu") == "swiglu" else 2) * d * cfg["d_ff"]
    return cfg["n_layers"] * per + d * cfg["vocab"]


def _attn_and_ssd_ops(cfg, S):
    ops = 0
    H, hd = cfg["n_heads"], cfg["head_dim"]
    s = ssm_dims(cfg)
    for w in layer_windows(cfg):
        if H:
            ops += 4 * H * hd * attn_pairs(S, True, w)
        if s:
            Hs, P, N, _ = s
            ops += ssd_ops(1, S, Hs, P, N, cfg.get("ssm_chunk", 128))
    return ops


def train_flops(cfg, batch, seq):
    """Model FLOPs of one training step (forward and backward, 3x the
    forward; the recompute of rematerialised layers is not counted)."""
    fwd = 2 * matmul_params(cfg) * seq + _attn_and_ssd_ops(cfg, seq)
    return 3 * batch * fwd


def prefill_flops(cfg, S):
    """A prompt of S tokens: every projection and MLP at each position,
    causal attention, the output head at the last position alone (the one
    whose logits the first token needs)."""
    d, V = cfg["d_model"], cfg["vocab"]
    return 2 * (matmul_params(cfg) - d * V) * S + 2 * d * V \
        + _attn_and_ssd_ops(cfg, S)


def decode_flops(cfg, ctx):
    """One decoded token whose attention sees ``ctx`` positions (itself
    included), windows applied; the SSM's state update is linear and
    counted as 6 operations a state element."""
    H, hd = cfg["n_heads"], cfg["head_dim"]
    ops = 2 * matmul_params(cfg)
    s = ssm_dims(cfg)
    for w in layer_windows(cfg):
        if H:
            ops += 4 * H * hd * (min(ctx, w) if w > 0 else ctx)
        if s:
            Hs, P, N, _ = s
            ops += 6 * Hs * P * N
    return ops
