"""Mamba-2 SSD (state-space duality): chunked prefill and O(1) decode.
Counterpart of ``repro.models.ssm``.

Prefill goes to ``kernels.ssd.ops``: the CUDA chunk-scan kernel for a
tensor on the card, :func:`ssd_chunked` for one on the CPU.  Both take any
sequence length: the ragged last chunk is handled, where the JAX package's
kernel asserts ``S % chunk == 0``.  :func:`ssd_ref` is the sequential
oracle.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .layers import PSpec, matmul, promote, rmsnorm


def ssm_specs(cfg):
    d, di, N, H = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads
    conv_dim = di + 2 * N
    return {
        "in_proj": PSpec((d, 2 * di + 2 * N + H), ("fsdp", None)),
        "conv_w": PSpec((cfg.conv_kernel, conv_dim), (None, None),
                        scale=0.5),
        "conv_b": PSpec((conv_dim,), (None,), "zeros"),
        "A_log": PSpec((H,), (None,), "zeros"),
        "D": PSpec((H,), (None,), "ones"),
        "dt_bias": PSpec((H,), (None,), "zeros"),
        "norm_w": PSpec((di,), (None,), "zeros"),
        "out_proj": PSpec((di, d), (None, "fsdp")),
    }


def _split(cfg, zxbcdt):
    di, N, H = cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads
    z = zxbcdt[..., :di]
    xBC = zxbcdt[..., di:di + di + 2 * N]
    dt = zxbcdt[..., -H:]
    return z, xBC, dt


def _conv(cfg, xBC, conv_w, conv_b):
    """Depthwise causal conv over sequence. xBC: [B, S, conv_dim]."""
    K = cfg.conv_kernel
    pad = F.pad(xBC, (0, 0, K - 1, 0))
    out = sum(pad[:, k:k + xBC.shape[1], :] * conv_w[k].to(xBC.dtype)
              for k in range(K))
    return F.silu(out + conv_b.to(xBC.dtype))


def ssd_chunked(xs, dt, A, B_, C_, chunk: int):
    """Chunked SSD. xs:[B,S,H,P] dt:[B,S,H] A:[H] B_,C_:[B,S,N].
    Returns y:[B,S,H,P] (xs's dtype) and final state [B,H,P,N] (f32).

    Any S: the tail is zero-padded to a whole chunk.  A padded step has
    dt=0, so it neither decays the state nor adds to it, and the rows it
    yields are dropped.  The arithmetic is f32 (f64, state included, for
    f64 inputs, which the gradient checks use).
    """
    wide = torch.float64 if xs.dtype == torch.float64 else torch.float32
    B, S, H, Pd = xs.shape
    N = B_.shape[-1]
    nc = -(-S // chunk)
    pad = nc * chunk - S
    if pad:
        xs_p = F.pad(xs, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B_ = F.pad(B_, (0, 0, 0, pad))
        C_ = F.pad(C_, (0, 0, 0, pad))
    else:
        xs_p = xs

    def r(t):
        return t.reshape((B, nc, chunk) + tuple(t.shape[2:]))

    xs_, dt_, Bc, Cc = r(xs_p), r(dt.to(wide)), r(B_), r(C_)

    a = dt_ * A.to(wide)                                      # [B,nc,l,H]
    # within-chunk cumsum, accumulated in f64 and rounded once: |cum|
    # reaches the hundreds at long chunks, where the order of an f32 scan
    # moves exp(cum_i - cum_j) by ~1e-4 (the CUDA kernels scan in f64 too)
    cum = torch.cumsum(a.double(), dim=2).to(wide)
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]       # [B,nc,i,j,H]
    li = torch.arange(chunk, device=xs.device)
    causal = (li[:, None] >= li[None, :])[None, None, :, :, None]
    # mask BEFORE exp: future entries have positive seg that overflows
    L = torch.exp(torch.where(causal, seg, -1e30))

    # intra-chunk: y[i] = sum_j (C_i·B_j) L[i,j] dt_j x_j
    cb = torch.einsum("bcin,bcjn->bcij", Cc.to(wide), Bc.to(wide))
    scores = cb[:, :, :, :, None] * L * dt_[:, :, None, :, :]
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", scores, xs_.to(wide))

    # per-chunk state contribution: sum_j exp(cum_end - cum_j) dt_j B_j x_j^T
    decay_out = torch.exp(cum[:, :, -1:, :] - cum)            # [B,nc,l,H]
    wB = (decay_out * dt_)[..., None] * Bc.to(wide)[:, :, :, None, :]
    contrib = torch.einsum("bcjhn,bcjhp->bchpn", wB, xs_.to(wide))
    chunk_decay = torch.exp(cum[:, :, -1])                    # [B,nc,H]

    h = torch.zeros((B, H, Pd, N), dtype=wide, device=xs.device)
    h_prevs = []
    for c in range(nc):
        h_prevs.append(h)
        h = h * chunk_decay[:, c, :, None, None] + contrib[:, c]
    h_prevs = torch.stack(h_prevs, dim=1)                     # [B,nc,H,P,N]

    # inter-chunk: y[i] += C_i · (h_prev * exp(cum_i))
    y_inter = torch.einsum("bcin,bchpn->bcihp", Cc.to(wide), h_prevs) * \
        torch.exp(cum)[:, :, :, :, None]
    y = (y_intra + y_inter).reshape(B, nc * chunk, H, Pd)[:, :S]
    return y.to(xs.dtype), h


def ssd_ref(xs, dt, A, B_, C_):
    """Sequential oracle: h_t = h_{t-1} e^{A dt_t} + dt_t B_t x_t^T."""
    B, S, H, Pd = xs.shape
    N = B_.shape[-1]
    Af = A.float()
    h = torch.zeros((B, H, Pd, N), dtype=torch.float32, device=xs.device)
    ys = []
    for t in range(S):
        dt_t = dt[:, t].float()
        dec = torch.exp(dt_t * Af)
        h = h * dec[:, :, None, None] + torch.einsum(
            "bh,bn,bhp->bhpn", dt_t, B_[:, t].float(), xs[:, t].float())
        ys.append(torch.einsum("bn,bhpn->bhp", C_[:, t].float(), h))
    return torch.stack(ys, dim=1).to(xs.dtype), h


def ssm_block(params, cfg, x, *, cache=None):
    """Full Mamba-2 block.  x: [B, S, d].

    Train/prefill (cache=None): chunked SSD over the sequence; returns
    (out, None), or (out, (conv_state, ssm_state)) if ``cache == "init"``
    to produce a decode cache from prefill.
    Decode: cache = (conv_state [B,K-1,conv_dim], ssm_state [B,H,P,N]),
    S must be 1; returns (out, new_cache).
    """
    B, S, d = x.shape
    di, N, H, Pd = cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads, cfg.ssm_headdim
    K = cfg.conv_kernel
    zxbcdt = matmul(x, params["in_proj"].to(x.dtype))
    z, xBC, dt = _split(cfg, zxbcdt)
    A = -torch.exp(params["A_log"].float())
    dt = F.softplus(dt.float() + params["dt_bias"].float())

    decode = cache is not None and cache != "init"
    if not decode:
        xBC_raw = xBC
        xBC = _conv(cfg, xBC, params["conv_w"], params["conv_b"])
        xs = xBC[..., :di].reshape(B, S, H, Pd)
        B_, C_ = xBC[..., di:di + N], xBC[..., di + N:]
        from repro_torch.kernels.ssd import ops as ssd_ops
        y, hT = ssd_ops.ssd(xs, dt, A, B_, C_, cfg.ssm_chunk)
        new_cache = None
        if cache == "init":
            pad = F.pad(xBC_raw, (0, 0, K - 1, 0))
            new_cache = (pad[:, -(K - 1):, :], hT)
    else:
        conv_state, h = cache
        assert S == 1
        # depthwise conv against the rolling window
        win = torch.cat(promote(conv_state, xBC), dim=1)      # [B,K,conv]
        win_, w_ = promote(win, params["conv_w"].to(x.dtype))
        conv_out = torch.einsum("bkc,kc->bc", win_, w_)
        conv_out, b_ = promote(conv_out, params["conv_b"].to(x.dtype))
        xBC1 = F.silu(conv_out + b_)[:, None, :]
        xs = xBC1[..., :di].reshape(B, 1, H, Pd)
        B_, C_ = xBC1[..., di:di + N], xBC1[..., di + N:]
        dec = torch.exp(dt[:, 0] * A)                         # [B,H]
        h = h * dec[:, :, None, None] + torch.einsum(
            "bh,bn,bhp->bhpn", dt[:, 0], B_[:, 0].float(), xs[:, 0].float())
        y = torch.einsum("bn,bhpn->bhp", C_[:, 0].float(),
                         h)[:, None].to(x.dtype)
        new_cache = (win[:, 1:, :], h)

    y = y + params["D"].float()[None, None, :, None] * xs.float()
    y = y.reshape(B, S, di).to(x.dtype)
    y = rmsnorm(y * F.silu(z), params["norm_w"])
    return matmul(y, params["out_proj"].to(x.dtype)), new_cache
