"""Roofline analysis of a planned step (no card needed).  Counterpart of
``repro.launch.roofline``.

Terms per (arch x shape x mesh), in seconds:

  compute    = matmul FLOPs per device / PEAK_FLOPS
  memory     = 2 x result bytes per device / HBM_BW
  collective = ring-model bytes on the wire per device / LINK_BW

The reference reads FLOPs and bytes from the compiled, partitioned HLO.
PyTorch has no such compiler, so the port *plans* a step instead
(``repro_torch.launch.dryrun``): it traces the step once on the ``meta``
device under :class:`TraceCounter`, which counts every matrix product's
``2*M*N*K`` (as the reference's ``_DOT_RE`` counts each ``dot``) and every
op's result bytes (views and aliases move nothing, as the reference's
``_FREE_OPS``; an indexed in-place update counts its update's bytes, as a
``dynamic-update-slice`` does), and splits both evenly over the mesh's
devices.  Each result is counted once written and once read (the
reference's factor 2).

The collective model of a planned step (:func:`record_step_collectives`),
recorded through :meth:`TraceCounter.record_collective` with the
reference's ring formulas (``_parse_collectives_split``) verbatim:

* each fsdp-sharded parameter leaf: an all-gather over its fsdp axes in
  the forward and again in the backward (the gathered leaf is the
  result), and a reduce-scatter of its gradient (the shard is the result);
  prefill and decode gather once;
* each tensor-parallel attention and MLP block output (heads or d_ff over
  'model'; a tensor-mode MoE's experts and the shared experts too): an
  all-reduce of the per-device activation ``[B/dp, S, d]`` over 'model',
  in the forward and again in the backward;
* expert-parallel dispatch (experts over 'model'): an all-to-all of the
  per-device dispatch buffer ``[E/tp, C, d]`` in and one out, forward and
  backward.

Hardware constants: one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates): 989e12 bf16 FLOP/s, 3.35e12 B/s of HBM3, 80 GB a device, and
NVLink 4 at 450e9 B/s a direction a GPU for the collective term.  An
NVLink domain holds 8 GPUs, so a model axis of 16 spans two domains and
crosses the slower network between them: the collective term is a lower
bound.
"""
from __future__ import annotations

import dataclasses
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.models.moe import capacity_of
from repro_torch.parallel.sharding import (axes_of, batch_pspec, data_axes,
                                           make_rules_for_mesh, shard_factor,
                                           shard_shape)

PEAK_FLOPS = 989e12      # H100 SXM, bf16 dense
HBM_BW = 3.35e12         # H100 SXM, HBM3
HBM_BYTES = 80e9         # H100 SXM, a device
LINK_BW = 450e9          # NVLink 4, a direction a GPU

_COLL = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
         "collective-permute")

_aten = torch.ops.aten
# (index of the left operand, index of the right operand)
_MATMUL = {_aten.mm.default: (0, 1), _aten.bmm.default: (0, 1),
           _aten.addmm.default: (1, 2), _aten.baddbmm.default: (1, 2)}
# indexed in-place updates: only the update (argument 2) is written
_INDEX_PUT = {_aten.index_put_.default, _aten._index_put_impl_.default}
# results that are reinterpretations or fresh uninitialised buffers
_FREE_OPS = {_aten._unsafe_view.default, _aten.lift_fresh.default,
             _aten.empty.memory_format, _aten.empty_strided.default,
             _aten.empty_like.default}


@dataclasses.dataclass
class CollectiveStats:
    bytes_by_op: dict
    total_bytes: float                 # per-device wire bytes (ring model)
    count: int


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


class TraceCounter(TorchDispatchMode):
    """Counts a traced step: matmul FLOPs (``dot_flops``), result bytes
    (``result_bytes``), collectives (:meth:`record_collective`) and the
    peak of live bytes of the tensors the trace creates.

    Live bytes are tracked by storage (a view keeps its base alive) and
    weighed per plan: ``divisors`` is a list of ``(batch_ways, all_ways)``
    pairs, and ``peaks[i]`` the peak of the live bytes with every tensor
    whose leading dim is one of ``batch_dims`` (the batch, or its tokens
    flattened) counted over ``batch_ways`` and every other one (gradients,
    new optimizer moments, expert buffers, caches) over ``all_ways``.
    """

    def __init__(self, divisors=((1, 1),), batch_dims=()):
        super().__init__()
        self.dot_flops = 0.0
        self.result_bytes = 0.0
        self.by_op: dict[str, float] = {}
        self.coll_count = 0
        self.divisors = list(divisors)
        self.batch_dims = set(batch_dims)
        self.live = [0.0] * len(self.divisors)
        self.peaks = [0.0] * len(self.divisors)
        self._storages: dict[int, list] = {}

    # -- tracing ------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        ops = _MATMUL.get(func)
        if ops is not None:
            a = args[ops[0]]
            self.dot_flops += 2.0 * out.numel() * a.shape[-1]
        rets = func._schema.returns
        aliased = any(r.alias_info is not None for r in rets)
        if func in _INDEX_PUT:
            self.result_bytes += _nbytes(args[2])
        elif aliased:
            if any(r.alias_info is not None and r.alias_info.is_write
                   for r in rets):                 # a whole-tensor update
                self.result_bytes += sum(
                    _nbytes(t) for t in tree_leaves(out)
                    if isinstance(t, torch.Tensor))
        elif func not in _FREE_OPS:
            for t in tree_leaves(out):
                if isinstance(t, torch.Tensor):
                    self.result_bytes += _nbytes(t)
        if not aliased:
            for t in tree_leaves(out):
                if isinstance(t, torch.Tensor):
                    self._track(t)
        return out

    def _track(self, t):
        st = t.untyped_storage()
        key = id(st)
        if key in self._storages:
            return
        batch = t.dim() > 0 and t.shape[0] in self.batch_dims
        w = [st.nbytes() / (bw if batch else aw)
             for bw, aw in self.divisors]
        self._storages[key] = w
        for i, x in enumerate(w):
            self.live[i] += x
            self.peaks[i] = max(self.peaks[i], self.live[i])
        weakref.finalize(st, self._release, key)

    def _release(self, key):
        for i, x in enumerate(self._storages.pop(key)):
            self.live[i] -= x

    # -- collectives --------------------------------------------------
    def record_collective(self, op: str, nbytes: float, group: int,
                          times: int = 1):
        """One collective whose result is ``nbytes`` a device over a group
        of ``group`` devices, ``times`` over: the reference's ring
        formulas (a group of one moves nothing).  The result also counts
        as a result, as the reference's HLO op does."""
        if op not in _COLL:
            raise ValueError(f"unknown collective {op!r}; known: {_COLL}")
        g = group
        if g <= 1:
            return
        b = nbytes
        ring = (g - 1) / g
        if op == "all-reduce":
            wire = 2 * b * ring
        elif op == "reduce-scatter":
            wire = b * (g - 1)          # result is the 1/g piece
        elif op == "all-gather":
            wire = b * ring
        elif op == "all-to-all":
            wire = b * ring
        else:                           # collective-permute
            wire = b
        self.by_op[op] = self.by_op.get(op, 0.0) + wire * times
        self.coll_count += times
        self.result_bytes += b * times

    @property
    def collectives(self) -> CollectiveStats:
        return CollectiveStats(dict(self.by_op), sum(self.by_op.values()),
                               self.coll_count)


def _ways(spec, mesh, axes) -> int:
    """How many ways ``spec`` splits a tensor over the mesh axes in
    ``axes``."""
    n = 1
    for e in spec:
        for a in axes_of(e):
            if a in axes:
                n *= mesh.shape[a]
    return n


def shard_bytes(t, spec, mesh) -> int:
    """Bytes of one device's shard of ``t`` laid out by ``spec``."""
    n = 1
    for d in shard_shape(tuple(t.shape), spec, mesh):
        n *= d
    return n * t.element_size()


def record_step_collectives(counter, cfg, mesh, shape, param_leaves,
                            train: bool):
    """Record the module docstring's collective model of one step on
    ``mesh``: ``param_leaves`` is ``[(meta tensor, spec), ...]`` for
    every parameter leaf."""
    passes = 2 if train else 1
    fsdp = set(data_axes(mesh))
    for t, spec in param_leaves:
        g = _ways(spec, mesh, fsdp)
        own = shard_bytes(t, spec, mesh)
        counter.record_collective("all-gather", own * g, g, passes)
        if train:
            counter.record_collective("reduce-scatter", own, g)

    rules = make_rules_for_mesh(cfg, mesh)
    tp = mesh.shape["model"]
    bp = batch_pspec(mesh, shape.global_batch)
    b_loc = shape.global_batch // shard_factor(bp[0], mesh)
    s_tok = 1 if shape.kind == "decode" else shape.seq_len
    item = param_leaves[0][0].element_size()
    act = b_loc * s_tok * cfg.d_model * item
    for li in range(cfg.n_layers):
        dense = li == 0 and cfg.first_dense_d_ff
        if cfg.has_attn and rules["tensor_q"] is not None:
            counter.record_collective("all-reduce", act, tp, passes)
        if cfg.n_experts and not dense:
            if rules["expert"] is not None:
                G, _, C = capacity_of(cfg, shape.global_batch * s_tok)
                buf = (cfg.n_experts // tp) * G * C * cfg.d_model * item
                counter.record_collective("all-to-all", buf, tp, 2 * passes)
            elif rules["expert_ff"] is not None:
                counter.record_collective("all-reduce", act, tp, passes)
            if cfg.n_shared_experts:
                counter.record_collective("all-reduce", act, tp, passes)
        elif dense or cfg.d_ff:
            counter.record_collective("all-reduce", act, tp, passes)


@dataclasses.dataclass
class Plan:
    """One step planned on one mesh, every number per device."""
    flops: float                       # matmul FLOPs
    result_bytes: float                # op results, collectives' included
    collectives: CollectiveStats
    argument_bytes: int                # exact, from the PartitionSpecs
    output_bytes: int                  # exact, from the PartitionSpecs
    temp_bytes: int                    # an estimate (TraceCounter.peaks)


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS: 6·N·D train, 2·N·D forward (N = active params)."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        d = shape.global_batch * shape.seq_len
        return 6.0 * n * d
    if shape.kind == "prefill":
        d = shape.global_batch * shape.seq_len
        return 2.0 * n * d
    return 2.0 * n * shape.global_batch      # decode: 1 token per sequence


def analyze(plan: Plan, cfg, shape, n_devices: int) -> dict:
    """The reference's record keys from a plan (the ``hlo_*`` names are
    kept so the two packages' records read alike)."""
    flops = plan.flops
    hbm_bytes = 2.0 * plan.result_bytes
    coll = plan.collectives
    terms = {
        "compute_s": flops / PEAK_FLOPS,
        "memory_s": hbm_bytes / HBM_BW,
        "collective_s": coll.total_bytes / LINK_BW,
    }
    dominant = max(terms, key=terms.get)
    mf = model_flops(cfg, shape)
    bound = max(max(terms.values()), 1e-12)
    if shape.kind == "decode":
        # decode is memory-bound by construction: the ideal step reads
        # every argument byte (params + caches) exactly once
        ideal = plan.argument_bytes / HBM_BW
    else:
        ideal = (mf / n_devices) / PEAK_FLOPS
    return {
        "hlo_flops_per_chip": flops,
        "hlo_bytes_per_chip": hbm_bytes,
        "collective_bytes_per_chip": coll.total_bytes,
        "collective_by_op": coll.bytes_by_op,
        "collective_op_count": coll.count,
        **terms,
        "dominant": dominant.replace("_s", ""),
        "model_flops_total": mf,
        "model_flops_per_chip": mf / n_devices,
        "useful_flops_ratio": (mf / n_devices) / flops if flops else 0.0,
        "step_lower_bound_s": max(terms.values()),
        "ideal_step_s": ideal,
        "roofline_fraction": min(1.0, ideal / bound),
        "memory_per_device": {
            "argument_bytes": plan.argument_bytes,
            "output_bytes": plan.output_bytes,
            "temp_bytes": plan.temp_bytes,
            "total_bytes": plan.argument_bytes + plan.temp_bytes,
        },
    }
