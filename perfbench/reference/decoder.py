"""Plain float32 reference of the decoder configurations the benchmark
runs (hymba-1.5b, phi3-medium-14b): forward, loss, gradient and the
optimizer step, written from the equations below in plain PyTorch.  It
imports nothing of the program and takes its weights from the
benchmark's seeded generator (``perfbench.harness.weights``), never from
the program.  Float32 throughout with TF32 off; computed one sequence at
a time, a block of queries at a time, and in training one layer at a
time under recomputation, so that it fits beside nothing else.

Each layer, for the residual stream x of one sequence:

    h   = rmsnorm(x) * (1 + w_ln1)            eps 1e-6
    att = attention(h): q, k, v projections, rotary embedding on the
          two halves of each head (theta from the config), causal
          softmax(q k^T / sqrt(hd)) over the layer's window (0 = all),
          grouped heads (H query heads over KV key/value heads), W_o
    ssm = Mamba-2 SSD block (hybrid configs): in_proj -> z, xBC, dt;
          xBC through a causal depthwise conv (K taps) and SiLU;
          dt = softplus(dt + dt_bias), A = -exp(A_log);
          h_t = exp(A dt_t) h_{t-1} + dt_t x_t B_t^T,  y_t = h_t C_t + D x_t;
          y = rmsnorm(y * silu(z)) * (1 + norm_w);  out_proj
    x   = x + att                      (dense)
    x   = x + (att + ssm) / 2          (hybrid: parallel heads, averaged)
    x   = x + W_o(silu(W_g h2) * W_i h2),  h2 = rmsnorm(x) * (1 + w_ln2)

then logits = rmsnorm(x) * (1 + w_final) @ W_unembed over the real
vocabulary.  The training loss is the mean over next-token positions of
lse - logit[target] + 1e-4 lse^2, the step clips the gradient to global
norm 1 and applies AdamW (b1 0.9, b2 0.95, eps 1e-8, decoupled weight
decay on every leaf), and the parameters are stored in the configuration's
dtype (bf16) after each update, as the configuration states them.

Departures from the published models, which the program shares and the
reference therefore follows: hymba's SSM is Mamba-2's SSD (one B and C
group, 64-wide heads) in place of Mamba's selective scan, without the 128
meta tokens and without cross-layer KV sharing, its global layers are 0,
n/2 and n-1, and the two heads are averaged without their learned
per-channel scales; the norms' eps is 1e-6 and their weights act as
(1 + w).  phi3-medium attends over the whole 4k context (no sliding
window).

``fp8=True`` is the control: the same computation with both operands of
every matrix product rounded to float8 e4m3 (per-tensor scale), the
precision below the configuration's bf16.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

EPS = 1e-6
QUERY_BLOCK = 1024
SSD_CHUNK = 128
Z_LOSS = 1e-4


def no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def q8(x, on):
    """Round to float8 e4m3 with a per-tensor scale (straight through for
    the gradient) when ``on``."""
    if not on:
        return x
    d = x.detach()
    s = d.abs().amax().clamp(min=1e-30) / 448.0
    xq = (d / s).to(torch.float8_e4m3fn).float() * s
    return x + (xq - d)


def rmsnorm(x, w):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + EPS) * (1 + w)


def rope(x, pos, theta):
    half = x.shape[-1] // 2
    freqs = torch.exp(-math.log(theta) * torch.arange(
        half, dtype=torch.float32, device=x.device) / half)
    ang = pos.float()[:, None] * freqs                     # [S, half]
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(cfg, p, h, pos, window, fp8):
    S = h.shape[0]
    H, KV, hd = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    G = H // KV
    d = h.shape[1]
    hq = q8(h, fp8)
    q = (hq @ q8(p["wq"].reshape(d, H * hd), fp8)).view(S, KV, G, hd)
    k = (hq @ q8(p["wk"].reshape(d, KV * hd), fp8)).view(S, KV, hd)
    v = (hq @ q8(p["wv"].reshape(d, KV * hd), fp8)).view(S, KV, hd)
    theta = cfg.get("rope_theta", 10000.0)
    q = rope(q.reshape(S, H, hd), pos, theta).view(S, KV, G, hd)
    k = rope(k, pos, theta)
    q, k, v = q8(q, fp8), q8(k, fp8), q8(v, fp8)
    outs = []
    for a in range(0, S, QUERY_BLOCK):
        b = min(S, a + QUERY_BLOCK)
        lo = max(0, a - window + 1) if window > 0 else 0
        s = torch.einsum("qkgd,skd->kgqs", q[a:b], k[lo:b]) / math.sqrt(hd)
        qp, kp = pos[a:b, None], pos[None, lo:b]
        keep = kp <= qp
        if window > 0:
            keep = keep & (qp - kp < window)
        s = s.masked_fill(~keep, float("-inf"))
        pr = q8(torch.softmax(s, dim=-1), fp8)
        outs.append(torch.einsum("kgqs,skd->qkgd", pr, v[lo:b]))
    o = torch.cat(outs).reshape(S, H * hd)
    return q8(o, fp8) @ q8(p["wo"].reshape(H * hd, d), fp8)


def ssd(x, dt, A, B, C, fp8):
    """y [S,H,P] of h_t = exp(A dt_t) h_{t-1} + dt_t x_t B_t^T, y_t = h_t
    C_t, by chunks: exact within a chunk by segment sums (accumulated in
    f64), the state carried between chunks."""
    S, H, P = x.shape
    L = SSD_CHUNK
    nc = -(-S // L)
    pad = nc * L - S
    if pad:   # dt = 0 at padded steps: no decay, no input
        x, dt = F.pad(x, (0, 0, 0, 0, 0, pad)), F.pad(dt, (0, 0, 0, pad))
        B, C = F.pad(B, (0, 0, 0, pad)), F.pad(C, (0, 0, 0, pad))
    x, B, C = q8(x, fp8), q8(B, fp8), q8(C, fp8)
    x, dt = x.view(nc, L, H, P), dt.view(nc, L, H)
    B, C = B.view(nc, L, -1), C.view(nc, L, -1)
    cum = torch.cumsum((dt * A).double(), dim=1).float()       # [nc,L,H]
    i = torch.arange(L, device=x.device)
    tri = (i[:, None] >= i[None, :])[None, :, :, None]
    seg = cum[:, :, None, :] - cum[:, None, :, :]               # [nc,i,j,H]
    decay = torch.exp(seg.masked_fill(~tri, float("-inf")))
    w = torch.einsum("cin,cjn->cij", C, B)[..., None] * decay * dt[:, None]
    y = torch.einsum("cijh,cjhp->cihp", w, x)
    to_end = torch.exp(cum[:, -1:, :] - cum) * dt               # [nc,L,H]
    contrib = torch.einsum("cjh,cjn,cjhp->chpn", to_end, B, x)
    state = torch.zeros_like(contrib[0])
    prev = []
    for c in range(nc):
        prev.append(state)
        state = state * torch.exp(cum[c, -1])[:, None, None] + contrib[c]
    prev = torch.stack(prev)                                    # [nc,H,P,N]
    y = y + torch.einsum("cin,chpn->cihp", C, prev) * \
        torch.exp(cum)[..., None]
    return y.reshape(nc * L, H, P)[:S]


def ssm_block(cfg, p, h, fp8):
    S, d = h.shape
    N = cfg["ssm_state"]
    P = cfg.get("ssm_headdim", 64)
    di = cfg.get("ssm_expand", 2) * d
    Hs = di // P
    K = cfg.get("conv_kernel", 4)
    zxbcdt = q8(h, fp8) @ q8(p["in_proj"], fp8)
    z, xBC, dt = zxbcdt[:, :di], zxbcdt[:, di:2 * di + 2 * N], \
        zxbcdt[:, 2 * di + 2 * N:]
    xp = F.pad(xBC, (0, 0, K - 1, 0))
    conv = sum(xp[k:k + S] * p["conv_w"][k] for k in range(K))
    xBC = F.silu(conv + p["conv_b"])
    x = xBC[:, :di].reshape(S, Hs, P)
    B, C = xBC[:, di:di + N], xBC[:, di + N:]
    dt = F.softplus(dt + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    y = ssd(x, dt, A, B, C, fp8) + p["D"][:, None] * x
    y = rmsnorm(y.reshape(S, di) * F.silu(z), p["norm_w"])
    return q8(y, fp8) @ q8(p["out_proj"], fp8)


def layer(cfg, p, x, pos, window, fp8):
    h = rmsnorm(x, p["ln1"])
    parts = []
    if cfg["n_heads"]:
        parts.append(attention(cfg, p["attn"], h, pos, window, fp8))
    if cfg.get("ssm_state", 0):
        parts.append(ssm_block(cfg, p["ssm"], h, fp8))
    x = x + (parts[0] if len(parts) == 1 else 0.5 * (parts[0] + parts[1]))
    h2 = q8(rmsnorm(x, p["ln2"]), fp8)
    m = p["mlp"]
    a = F.silu(h2 @ q8(m["wg"], fp8)) * (h2 @ q8(m["wi"], fp8))
    return x + q8(a, fp8) @ q8(m["wo"], fp8)


def windows(cfg):
    L, w = cfg["n_layers"], cfg.get("window", 0)
    if cfg.get("attn_pattern", "full") == "global3":
        return [0 if i in (0, L // 2, L - 1) else w for i in range(L)]
    return [w] * L


def _f32(tree):
    return {k: _f32(v) if isinstance(v, dict) else v.float()
            for k, v in tree.items()}


# ---------------------------------------------------------------------------
# serving: logits of one sequence at chosen positions
# ---------------------------------------------------------------------------
@torch.no_grad()
def logits(cfg, W, tokens, at, fp8=False):
    """f32 logits [len(at), vocab] of the sequence ``tokens`` (a 1-d
    tensor on the weights' device) at positions ``at``; the weights (the
    seeded bf16 tree) are widened one layer at a time."""
    no_tf32()
    S = tokens.shape[0]
    pos = torch.arange(S, device=tokens.device)
    x = W["embed"]["tok"][tokens].float()
    for li, w in enumerate(windows(cfg)):
        x = layer(cfg, _f32(W["layers"][str(li)]), x, pos, w, fp8)
    x = rmsnorm(x[at], W["final_norm"].float())
    V = cfg["vocab"]
    return q8(x, fp8) @ q8(W["embed"]["unembed"][:, :V].float(), fp8)


# ---------------------------------------------------------------------------
# training: the step the program takes, followed for a few steps
# ---------------------------------------------------------------------------
def _seq_loss(cfg, P, tokens, fp8, upto=None):
    """Sum over next-token positions (the first ``upto`` of them) of one
    sequence's loss terms."""
    S = tokens.shape[0]
    pos = torch.arange(S, device=tokens.device)
    x = P["embed"]["tok"][tokens]
    for li, w in enumerate(windows(cfg)):
        lp = P["layers"][str(li)]
        x = checkpoint(lambda x, lp=lp, w=w: layer(cfg, lp, x, pos, w, fp8),
                       x, use_reentrant=False)

    n = S - 1 if upto is None else upto

    def head(x):
        xf = rmsnorm(x[:n], P["final_norm"])
        lg = q8(xf, fp8) @ q8(P["embed"]["unembed"][:, :cfg["vocab"]], fp8)
        lse = torch.logsumexp(lg, dim=-1)
        ll = lg.gather(1, tokens[1:n + 1, None]).squeeze(1)
        return (lse - ll + Z_LOSS * lse * lse).sum()
    return checkpoint(head, x, use_reentrant=False)


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def train(cfg, W, batches, hp, fp8=False, half=False):
    """Follow the program's first ``len(batches)`` steps from the seeded
    weights ``W`` (the bf16 tree, widened to f32 leaves).  ``batches`` yields token ids
    [B, S].  ``half`` is a fault: the mean is taken over the first half of
    the batch's rows (of a single row's positions) and the rest left out.  -> dict with ``losses``, ``grad`` (each leaf's norm
    of the first clipped gradient, by path) and ``change`` (each leaf's
    norm of the change of the stored parameters over the steps)."""
    no_tf32()
    P = {}
    for path, t in list(_leaves(W)):
        node = P
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = t.float().requires_grad_(True)
    leaves = list(_leaves(P))
    p0 = [t.detach().to(torch.bfloat16) for _, t in leaves]
    m = [torch.zeros_like(t) for _, t in leaves]
    v = [torch.zeros_like(t) for _, t in leaves]
    b1, b2 = 0.9, 0.95
    out = {"losses": []}
    for step, tokens in enumerate(batches, start=1):
        B, S = tokens.shape
        rows, upto = range(B), None
        if half and B > 1:
            rows = range(B // 2)
        elif half:
            upto = (S - 1) // 2
        n = len(rows) * (S - 1 if upto is None else upto)
        total = 0.0
        for r in rows:
            loss = _seq_loss(cfg, P, tokens[r], fp8, upto) / n
            loss.backward()
            total += loss.detach().item()
        out["losses"].append(total)
        with torch.no_grad():
            g = [t.grad for _, t in leaves]
            gn = torch.sqrt(sum((x * x).sum() for x in g))
            f = torch.clamp(hp["grad_clip"] / (gn + 1e-9), max=1.0)
            g = [x * f for x in g]
            if step == 1:
                out["grad"] = dict(zip(
                    (p for p, _ in leaves),
                    torch.stack([x.norm() for x in g]).tolist()))
            c1, c2 = 1 - b1 ** step, 1 - b2 ** step
            for i, (_, t) in enumerate(leaves):
                m[i].mul_(b1).add_((1 - b1) * g[i])
                v[i].mul_(b2).add_((1 - b2) * g[i] * g[i])
                upd = (m[i] / c1) / (torch.sqrt(v[i] / c2) + 1e-8) \
                    + hp["weight_decay"] * t
                t.copy_((t - hp["lr"] * upd).to(torch.bfloat16).float())
                t.grad = None
    with torch.no_grad():
        out["change"] = dict(zip(
            (p for p, _ in leaves),
            torch.stack([(t - t0.float()).norm() for (_, t), t0 in
                         zip(leaves, p0)]).tolist()))
    return out
