"""Seeded weights of a decoder configuration, made on the device.

The benchmark owns the weights: their layout (the names and shapes the
program's ``Model`` takes), their init and their values.  Every normal
leaf is a view of one flat buffer in the served dtype, filled from one
``torch.Generator`` on the device in a few large draws, then scaled leaf
by leaf by ``1/sqrt(fan_in)``.  The same seed on the same kind of device
gives the same bits, so the reference makes its own copy from the seed
after the program's state is freed.
"""
from __future__ import annotations

import math

import torch

from .counting import ssm_dims

CHUNK = 1 << 27          # elements a draw: 512 MiB of f32 scratch


def vocab_padded(cfg):
    return -(-cfg["vocab"] // 256) * 256


def layout(cfg):
    """Nested dict of (shape, init, scale) leaves.  ``init`` is "normal",
    "zeros" or "ones"; a normal leaf is N(0, 1) times ``scale``."""
    d, V = cfg["d_model"], vocab_padded(cfg)
    H, KV, hd = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]

    def normal(*shape, fan_in=None, scale=None):
        s = scale if scale is not None else 1.0 / math.sqrt(fan_in)
        return (tuple(shape), "normal", s)

    def const(kind, *shape):
        return (tuple(shape), kind, None)

    layer = {"ln1": const("zeros", d)}
    if H:
        layer["attn"] = {"wq": normal(d, H, hd, fan_in=d),
                         "wk": normal(d, KV, hd, fan_in=d),
                         "wv": normal(d, KV, hd, fan_in=d),
                         "wo": normal(H, hd, d, fan_in=H * hd)}
    s = ssm_dims(cfg)
    if s:
        Hs, P, N, di = s
        conv = di + 2 * N
        layer["ssm"] = {"in_proj": normal(d, 2 * di + 2 * N + Hs, fan_in=d),
                        "conv_w": normal(cfg.get("conv_kernel", 4), conv,
                                         scale=0.5),
                        "conv_b": const("zeros", conv),
                        "A_log": const("zeros", Hs),
                        "D": const("ones", Hs),
                        "dt_bias": const("zeros", Hs),
                        "norm_w": const("zeros", di),
                        "out_proj": normal(di, d, fan_in=di)}
    ff = cfg["d_ff"]
    layer["ln2"] = const("zeros", d)
    layer["mlp"] = {"wi": normal(d, ff, fan_in=d), "wg": normal(d, ff, fan_in=d),
                    "wo": normal(ff, d, fan_in=ff)}
    return {"embed": {"tok": normal(V, d, scale=1.0),
                      "unembed": normal(d, V, fan_in=d)},
            "layers": {str(i): layer for i in range(cfg["n_layers"])},
            "final_norm": const("zeros", d)}


def _leaves(tree, prefix=()):
    """(path, leaf) in sorted key order, layers in numeric order."""
    keys = sorted(tree, key=lambda k: (0, int(k)) if k.isdigit() else (1, k))
    for k in keys:
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def paths(cfg):
    return [p for p, _ in _leaves(layout(cfg))]


def make(cfg, seed, device):
    """-> nested dict of bf16 tensors shaped like :func:`layout`, the
    normal leaves views of one flat buffer."""
    dtype = torch.bfloat16
    leaves = list(_leaves(layout(cfg)))
    total = sum(math.prod(shape) for _, (shape, init, _) in leaves
                if init == "normal")
    flat = torch.empty(total, dtype=dtype, device=device)
    g = torch.Generator(device=device).manual_seed(int(seed))
    for a in range(0, total, CHUNK):
        b = min(a + CHUNK, total)
        flat[a:b] = torch.randn(b - a, generator=g, device=device,
                                dtype=torch.float32)
    out, at = {}, 0
    for path, (shape, init, scale) in leaves:
        if init == "normal":
            n = math.prod(shape)
            t = flat[at:at + n].view(shape)
            t.mul_(scale)
            at += n
        else:
            fill = torch.zeros if init == "zeros" else torch.ones
            t = fill(shape, dtype=dtype, device=device)
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = t
    return out


def get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def leaf_norms(tree, names):
    """f32 norm of each named leaf, one host read for them all."""
    return torch.stack([get(tree, p).float().norm() for p in names]).tolist()
