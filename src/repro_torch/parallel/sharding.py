"""Logical-axis -> mesh-axis rules (DP/FSDP/TP/EP/SP).  Counterpart of
``repro.parallel.sharding``.

Parameters carry *logical* axes ('fsdp', 'tensor', 'tensor_q', 'tensor_kv',
'expert', 'expert_ff'); this module resolves them for a (config, mesh)
pair with the reference's divisibility-aware fallbacks:

* ``fsdp``      -> ('pod','data') -- ZeRO-3 parameter/optimizer sharding
* ``tensor``    -> 'model' (Megatron TP on d_ff / vocab-padded dims)
* ``tensor_q``  -> 'model' if n_heads % tp == 0 else None (phi3: 40 heads)
* ``tensor_kv`` -> 'model' if n_kv_heads % tp == 0 else None (GQA kv<tp:
                   replicate KV projections; decode caches shard head_dim)
* ``expert``    -> 'model' when E % tp == 0 (EP: deepseek-v2 160/16),
                   else None with ``expert_ff`` -> 'model' (grok-1: 8
                   experts tensor-sharded on their 32768-wide FFN)
* SSM params    -> fsdp-only

A mesh here is a logical one (``repro_torch.launch.mesh``): axis names and
sizes, no devices.  PartitionSpecs are :class:`P`, plain tuples that equal
the reference's ``PartitionSpec`` entry for entry.  The port runs on one
card, so nothing is laid out by these specs: the dry run
(``repro_torch.launch.dryrun``) reads them to plan per-device bytes and
collectives, and :func:`constrain` records the activation specs a traced
step asks for.
"""
from __future__ import annotations

import contextlib
import math


class P(tuple):
    """A PartitionSpec: one entry per dim, each ``None``, a mesh axis name
    or a tuple of names.  A one-name tuple is stored as the name, as JAX's
    ``PartitionSpec`` normalises it, so ``tuple(P(...))`` equals
    ``tuple(jax.sharding.PartitionSpec(...))``."""

    def __new__(cls, *entries):
        def norm(e):
            if isinstance(e, (tuple, list)):
                e = tuple(e)
                return e[0] if len(e) == 1 else e
            return e
        return super().__new__(cls, (norm(e) for e in entries))

    def __repr__(self):
        return f"P{tuple.__repr__(self)}" if len(self) != 1 else \
            f"P({self[0]!r})"


def axes_of(entry) -> tuple:
    """The mesh axis names of one spec entry (``()`` for ``None``)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def shard_factor(entry, mesh) -> int:
    """How many ways one spec entry splits its dim on ``mesh``."""
    return math.prod(mesh.shape[a] for a in axes_of(entry))


# --- activation-sharding context (set while tracing a step on a mesh) ------
_ACTIVE: list = []


@contextlib.contextmanager
def activation_sharding(mesh, rules):
    """Enable :func:`constrain` while tracing a step on ``mesh``.  Yields
    the list that each ``constrain`` call appends ``(shape, axes, spec)``
    to: the activation's shape, its logical axes, and its spec on
    ``mesh``."""
    records: list = []
    _ACTIVE.append((mesh, rules, records))
    try:
        yield records
    finally:
        _ACTIVE.pop()


def constraint_spec(shape, axes, mesh, rules) -> P:
    """The spec that ``constrain`` gives a tensor of ``shape`` with logical
    ``axes`` on ``mesh``.  Dims that don't divide evenly are left
    unsharded (e.g. batch=1 for long_500k), as in the reference."""
    entries = []
    for dim, a in enumerate(axes):
        phys = rules.get(a) if a is not None else None
        if phys is None:
            entries.append(None)
            continue
        entries.append(phys if shape[dim] % shard_factor(phys, mesh) == 0
                       else None)
    return P(*entries)


def constrain(x, *axes):
    """Record ``x``'s activation spec by logical axes in the active plan
    and return ``x`` unchanged; a no-op outside :func:`activation_sharding`.
    (The reference's ``with_sharding_constraint``: on one card nothing is
    laid out.)"""
    if not _ACTIVE:
        return x
    mesh, rules, records = _ACTIVE[-1]
    shape = tuple(x.shape)
    records.append((shape, axes, constraint_spec(shape, axes, mesh, rules)))
    return x


def data_axes(mesh) -> tuple:
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def make_rules(cfg, tp: int, dp_axes: tuple) -> dict:
    ep_ok = cfg.n_experts > 0 and cfg.n_experts % tp == 0
    return {
        "fsdp": dp_axes,
        "tensor": "model",
        "tensor_q": "model" if (cfg.n_heads and cfg.n_heads % tp == 0)
        else None,
        "tensor_kv": "model" if (cfg.n_kv_heads and cfg.n_kv_heads % tp == 0)
        else None,
        "expert": "model" if ep_ok else None,
        "expert_ff": None if ep_ok else (
            "model" if (cfg.expert_d_ff and cfg.expert_d_ff % tp == 0)
            else None),
        # tensor-mode MoE (grok: 8 experts < tp): the capacity rows shard
        # over DP only when the config opts in (the reference's trade)
        "moe_cap": dp_axes if (not ep_ok and getattr(
            cfg, "moe_cap_shard", False)) else None,
    }


def make_rules_for_mesh(cfg, mesh) -> dict:
    return make_rules(cfg, mesh.shape["model"], data_axes(mesh))


def batch_pspec(mesh, global_batch: int) -> P:
    """Batch sharding: over (pod, data) when divisible, else data, else
    replicated (long_500k batch=1)."""
    axes = data_axes(mesh)
    if global_batch % math.prod(mesh.shape[a] for a in axes) == 0:
        return P(axes)
    if global_batch % mesh.shape["data"] == 0:
        return P("data")
    return P(None)


def seq_pspec(mesh, cfg, seq_len: int, batch_sharded: bool) -> P | None:
    """Sequence-parallel spec for long sequences when batch can't shard."""
    if batch_sharded:
        return None
    if seq_len % mesh.shape["data"] == 0:
        return P(None, "data")
    return None


def shard_shape(shape, spec, mesh) -> tuple:
    """The per-device shape of a tensor of ``shape`` laid out by ``spec``
    (missing trailing entries are unsharded); a dim that does not divide
    takes the padded shard, ceil(dim / ways), as XLA pads it."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(-(-d // shard_factor(e, mesh)) for d, e in zip(shape, spec))
