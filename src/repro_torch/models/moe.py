"""Mixture-of-Experts with GShard-style capacity dispatch.  Counterpart of
``repro.models.moe``.

Tokens pick their top-k experts; each expert's slots are handed out by a
running count in *choice-major* order (every first choice claims capacity
before any second choice), and tokens past an expert's capacity are
dropped to the residual path.  ``cfg.moe_groups`` splits the tokens into
groups that each have their own capacity and running count.  The drops
decide which tokens reach which expert, so every step here follows the
JAX package exactly: top-k ties go to the lower expert index (as
``jax.lax.top_k``), the capacity is computed in Python floats, and the
dropped rows land in one spare buffer row that is cut off (the JAX
package's out-of-bounds slot with ``mode="drop"``).  Expert weights are
stacked ``[E, ...]``; the experts run as batched matrix products over E.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.parallel.sharding import constrain

from .layers import PSpec, matmul, mlp, mlp_specs


def moe_specs(cfg):
    d, E, eff = cfg.d_model, cfg.n_experts, cfg.expert_d_ff
    s = {"router": PSpec((d, E), (None, None), scale=0.02),
         "we_i": PSpec((E, d, eff), ("expert", "fsdp", "expert_ff")),
         "we_g": PSpec((E, d, eff), ("expert", "fsdp", "expert_ff")),
         "we_o": PSpec((E, eff, d), ("expert", "expert_ff", "fsdp"))}
    if cfg.n_shared_experts:
        s["shared"] = mlp_specs(d, cfg.n_shared_experts * eff, "swiglu")
    return s


def _route(params, xf, K):
    """-> (probs [T,E] f32, gates [T,K], expert ids [T,K]).  The top k by a
    stable descending sort, so equal probabilities keep the lower index
    first, as ``jax.lax.top_k`` does."""
    logits = matmul(xf, params["router"].to(xf.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    gate_vals, eidx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, eidx = gate_vals[:, :K], eidx[:, :K]
    gates = gate_vals / torch.sum(gate_vals, dim=-1, keepdim=True)
    return probs, gates, eidx


def capacity_of(cfg, T: int, capacity: int | None = None):
    """-> (groups G, tokens a group Tg, slots an expert a group C)."""
    E, K = cfg.n_experts, cfg.top_k
    G = max(cfg.moe_groups, 1)
    if T % G != 0 or T // G < 8:   # tiny inputs: fall back to global
        G = 1
    Tg = T // G
    C = capacity if capacity is not None else max(
        8, int(Tg * K / E * cfg.moe_capacity))
    return G, Tg, min(C, Tg)


def dispatch(cfg, eidx, T: int, capacity: int | None = None):
    """Slots of the choice-major running count.

    eidx [T,K] -> (slot [T,K] int64, keep [T,K] bool, C per expert).
    Expert e owns buffer rows [e*C, (e+1)*C) with C = G * (slots a
    group); a dropped choice gets slot E*C, one past the buffer."""
    E, K = cfg.n_experts, cfg.top_k
    G, Tg, C = capacity_of(cfg, T, capacity)
    dev = eidx.device
    # choice-major per group: first choices claim capacity first
    e_flat = eidx.reshape(G, Tg, K).transpose(1, 2).reshape(G, K * Tg)
    oh = F.one_hot(e_flat, E)                                  # [G,K*Tg,E]
    pos = torch.cumsum(oh, dim=1) - 1                          # local count
    pos_in_e = torch.gather(pos, 2, e_flat[..., None])[..., 0]
    keep = pos_in_e < C
    slot = torch.where(
        keep, e_flat * G * C
        + torch.arange(G, device=dev)[:, None] * C + pos_in_e, E * G * C)
    # back to [T,K]: group g's choice k of its token t
    slot = slot.reshape(G, K, Tg).transpose(1, 2).reshape(T, K)
    keep = keep.reshape(G, K, Tg).transpose(1, 2).reshape(T, K)
    return slot, keep, G * C


def moe_block(params, cfg, x, capacity: int | None = None):
    """x: [B, S, d] -> (out [B, S, d], aux_loss scalar f32)."""
    B, S, d = x.shape
    E, K = cfg.n_experts, cfg.top_k
    T = B * S
    xf = x.reshape(T, d)
    probs, gates, eidx = _route(params, xf, K)

    # load-balancing aux loss (Switch): E * sum_e f_e * p_e
    f = torch.mean(torch.sum(F.one_hot(eidx, E).float(), dim=1), dim=0)
    aux = E * torch.sum(f * torch.mean(probs, dim=0))

    slot, keep, C = dispatch(cfg, eidx, T, capacity)
    # expert-major buffer with one spare row for every dropped choice
    buf = torch.zeros((E * C + 1, d), dtype=xf.dtype, device=x.device)
    buf[slot.reshape(-1)] = xf[:, None, :].expand(T, K, d).reshape(T * K, d)
    buf = constrain(buf[:E * C].reshape(E, C, d), "expert", "moe_cap",
                    None)                          # a2a/EP boundary

    # expert FFN (swiglu), batched over E
    h = F.silu(torch.bmm(buf, params["we_g"].to(xf.dtype))) * \
        torch.bmm(buf, params["we_i"].to(xf.dtype))
    out_flat = torch.bmm(h, params["we_o"].to(xf.dtype)).reshape(E * C, d)

    # combine by gathering each choice's row back to its token
    gathered = out_flat[torch.clamp(slot, max=E * C - 1)]      # [T,K,d]
    y = torch.sum(torch.where(keep[:, :, None], gathered, 0)
                  * gates.to(gathered.dtype)[:, :, None], dim=1)
    y = constrain(y, "fsdp", None)
    if cfg.n_shared_experts:
        y = y + mlp(params["shared"], xf, "swiglu")
    return y.reshape(B, S, d), aux


def moe_block_dense_ref(params, cfg, x):
    """Oracle: every expert on every token, weighted by its gate (no
    capacity drops).  Used by the tests and ``chip_smoke.py`` only."""
    B, S, d = x.shape
    E, K = cfg.n_experts, cfg.top_k
    xf = x.reshape(-1, d)
    _, gates, eidx = _route(params, xf, K)
    y = torch.zeros(xf.shape, dtype=torch.float32, device=x.device)
    for e in range(E):
        pe = {"wi": params["we_i"][e], "wg": params["we_g"][e],
              "wo": params["we_o"][e]}
        oe = mlp(pe, xf, "swiglu").float()
        w = torch.sum(torch.where(eidx == e, gates, 0.0), dim=-1)
        y = y + oe * w[:, None]
    y = y.to(x.dtype)
    if cfg.n_shared_experts:
        y = y + mlp(params["shared"], xf, "swiglu")
    return y.reshape(B, S, d)
