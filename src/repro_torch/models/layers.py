"""Parameter specs, their initialisation, and the basic layers (norms, MLPs,
embeddings, the loss).  Counterpart of ``repro.models.layers``.

A :class:`PSpec` carries a parameter's shape, its logical sharding axes
(``'fsdp'``, ``'tensor'``, ... or ``None`` per dim, as in the JAX package)
and its init kind.  The same tree serves three uses:

* :func:`init_params`     -- real tensors from a ``torch.Generator``;
* :func:`abstract_params` -- ``meta`` tensors for the dry run (the
  counterpart of the reference's ``ShapeDtypeStruct``s): shapes and
  dtypes, no storage;
* :func:`make_pspecs`     -- PartitionSpecs for a mesh through the axis
  rules of ``repro_torch.parallel.sharding``.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.parallel.sharding import P


@dataclasses.dataclass(frozen=True)
class PSpec:
    shape: tuple
    axes: tuple          # logical axis name per dim: 'fsdp' | 'tensor' | None
    init: str = "normal"  # normal | zeros | ones
    scale: float | None = None

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"PSpec shape {self.shape} has "
                             f"{len(self.shape)} dims, axes {self.axes}")


def init_params(tree, generator: torch.Generator, dtype=torch.bfloat16):
    """Nested dict of PSpec -> nested dict of tensors on the generator's
    device.

    ``normal`` draws f32 N(0, 1) times ``scale`` (default 1/sqrt(shape[0]))
    and casts to ``dtype``, as the JAX package does.  Leaves are drawn in
    sorted key order.
    """
    device = generator.device

    def one(ps: PSpec):
        if ps.init == "zeros":
            return torch.zeros(ps.shape, dtype=dtype, device=device)
        if ps.init == "ones":
            return torch.ones(ps.shape, dtype=dtype, device=device)
        scale = ps.scale if ps.scale is not None else \
            1.0 / math.sqrt(max(ps.shape[0], 1))
        w = torch.randn(ps.shape, generator=generator, dtype=torch.float32,
                        device=device)
        return (w * scale).to(dtype)

    def walk(t):
        if isinstance(t, PSpec):
            return one(t)
        return {k: walk(t[k]) for k in sorted(t)}

    return walk(tree)


def _map_specs(fn, tree):
    if isinstance(tree, PSpec):
        return fn(tree)
    return {k: _map_specs(fn, v) for k, v in tree.items()}


def abstract_params(tree, dtype=torch.bfloat16):
    """The spec tree as ``meta`` tensors of ``dtype``: what the dry run
    traces with.  Nothing is allocated."""
    return _map_specs(
        lambda ps: torch.empty(ps.shape, dtype=dtype, device="meta"), tree)


def partition_spec(ps: PSpec, rules: dict) -> tuple:
    """The spec's PartitionSpec under ``rules`` (logical -> mesh axes)."""
    return P(*[rules.get(a) if a is not None else None for a in ps.axes])


def make_pspecs(tree, rules: dict):
    return _map_specs(lambda ps: partition_spec(ps, rules), tree)


def promote(*ts):
    """Cast tensors to their common type, as JAX promotes mixed operands."""
    dt = ts[0].dtype
    for t in ts[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return [t.to(dt) for t in ts]


def matmul(a, b):
    a, b = promote(a, b)
    return a @ b


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------
def rmsnorm(x, w, eps=1e-6):
    xf = x.float()
    n = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (n * (1.0 + w.float())).to(x.dtype)


def layernorm(x, w, b=None, eps=1e-5):
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    n = (xf - mu) * torch.rsqrt(var + eps) * w.float()
    if b is not None:
        n = n + b.float()
    return n.to(x.dtype)


def norm(cfg, x, w):
    return rmsnorm(x, w) if cfg.norm == "rms" else layernorm(x, w)


def norm_spec(cfg):
    return PSpec((cfg.d_model,), (None,),
                 "zeros" if cfg.norm == "rms" else "ones")


def mlp_specs(d_model: int, d_ff: int, act: str):
    if act == "swiglu":
        return {"wi": PSpec((d_model, d_ff), ("fsdp", "tensor")),
                "wg": PSpec((d_model, d_ff), ("fsdp", "tensor")),
                "wo": PSpec((d_ff, d_model), ("tensor", "fsdp"))}
    return {"wi": PSpec((d_model, d_ff), ("fsdp", "tensor")),
            "wo": PSpec((d_ff, d_model), ("tensor", "fsdp"))}


def mlp(params, x, act: str):
    if act == "swiglu":
        h = F.silu(matmul(x, params["wg"])) * matmul(x, params["wi"])
    else:
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(matmul(x, params["wi"]), approximate="tanh")
    return matmul(h, params["wo"])


def softcap(x, cap: float):
    return torch.tanh(x / cap) * cap if cap else x


def embed_specs(cfg):
    s = {"tok": PSpec((cfg.vocab_padded, cfg.d_model), ("tensor", "fsdp"),
                      scale=1.0)}
    if not cfg.tie_embeddings:
        s["unembed"] = PSpec((cfg.d_model, cfg.vocab_padded),
                             ("fsdp", "tensor"))
    if cfg.frontend == "audio":
        s["frontend_proj"] = PSpec((cfg.frontend_dim, cfg.d_model),
                                   (None, "fsdp"))
    return s


def embed(params, cfg, tokens):
    e = params["tok"][tokens]
    if cfg.norm == "rms" and cfg.final_softcap:   # gemma-style scaling
        e = e * torch.tensor(math.sqrt(cfg.d_model), dtype=e.dtype)
    return e


def unembed(params, cfg, x):
    w = params["tok"].T if cfg.tie_embeddings else params["unembed"]
    logits = x @ w.to(x.dtype)
    logits = softcap(logits.float(), cfg.final_softcap)
    if cfg.vocab_padded != cfg.vocab:  # mask padding columns
        logits[..., cfg.vocab:] = -1e30
    return logits


def cross_entropy(logits, labels, mask=None, z_loss: float = 0.0):
    """Mean token cross-entropy (f32), optional validity mask + z-loss.

    The vocab padding columns that :func:`unembed` sets to -1e30 add
    nothing to the log-sum-exp and get a zero gradient, as in the JAX
    package."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    loss = lse - ll
    if z_loss:
        loss = loss + z_loss * torch.square(lse)
    if mask is not None:
        return torch.sum(loss * mask) / torch.clamp(torch.sum(mask), min=1)
    return torch.mean(loss)
