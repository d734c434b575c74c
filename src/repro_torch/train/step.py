"""train_step factory: loss -> grads (accumulated over micro-batches) ->
clip -> AdamW.  Counterpart of ``repro.train.step``.

The model's forward launches the hand-written kernels on the card (their
autograd Functions carry the gradient through them); the step itself is
plain PyTorch.  Each step opens three tasks on a wall-clock
:class:`~repro_torch.core.tracing.TracingDomain` (``forward``: the loss;
``backward``: its gradients, micro-batches accumulated; ``update``: clip
and AdamW, the parameters copied back), mirrored as ``torch.profiler``
ranges while a profiler records.  The same factory serves real training
and the dry run (``repro_torch.launch.dryrun``): :func:`assemble_train` gives the step
with ``meta`` arguments (nothing allocated) and the PartitionSpecs of
every leaf on a mesh (:func:`opt_pspecs`, :func:`batch_pspecs`).
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses

import torch

from repro_torch.core.engine import ref_leaves, ref_map
from repro_torch.core.tracers import profiler_ranges
from repro_torch.core.tracing import TracingDomain
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import abstract_params, make_pspecs
from repro_torch.optim import (adamw_init, adamw_update,
                               clip_by_global_norm, sum_squares)
from repro_torch.parallel.sharding import (P, batch_pspec,
                                           make_rules_for_mesh)


@dataclasses.dataclass(frozen=True)
class TrainHParams:
    lr: float = 3e-4
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    micro_batches: int = 1
    moments_dtype: str = "float32"     # "int8" => 8-bit optimizer states
    donate: bool = False               # signature parity only: no effect


# The domain of the train step running in this context, if any.  It
# reaches value_and_grad this way, not as an argument, because callers
# (the benchmark's fault checks among them) replace value_and_grad with
# functions of its three arguments.
_step_domain: contextvars.ContextVar = contextvars.ContextVar(
    "train_step_domain", default=None)


def value_and_grad(cfg, model, batch):
    """-> (loss, grads shaped like ``param_tree(model)``).  A parameter
    that the loss does not reach gets a zero gradient of its own dtype, as
    JAX gives it (torch would give ``None``), so AdamW still moves its
    moments and decays it.  Inside a train step, the loss is a ``forward``
    task and its gradients a ``backward`` one, on the step's domain."""
    dom = _step_domain.get()
    span = dom.task if dom is not None else _no_span
    ptree = tfm.param_tree(model)
    leaves = ref_leaves(ptree)
    with span("forward", "loss", "model"):
        loss = tfm.train_loss(model, cfg, batch)
    with span("backward", "grad", "model"):
        gs = torch.autograd.grad(loss, leaves, allow_unused=True)
        it = iter(torch.zeros_like(p) if g is None else g
                  for p, g in zip(leaves, gs))
        grads = ref_map(lambda p: next(it), ptree)
    return loss.detach(), grads


def _no_span(*args):
    return contextlib.nullcontext()


def make_train_step(cfg, hp: TrainHParams,
                    domain: TracingDomain | None = None):
    """Returns ``train_step(model, opt_state, batch) -> (loss, gnorm,
    model, opt_state)``.  ``batch`` holds tensors on the model's device.
    The model's parameters are overwritten with the updated ones (the
    reference returns new arrays; here the same model comes back), and the
    state is a new tree.  Each step's ``forward``, ``backward`` and
    ``update`` tasks go to ``domain`` (a ``TracingDomain("train")`` of the
    step's own if none is given); they nest under the caller's task."""
    dom = domain or TracingDomain("train")
    profiler_ranges(dom)

    def train_step(model, opt_state, batch):
        token = _step_domain.set(dom)
        try:
            return _train_step(model, opt_state, batch)
        finally:
            _step_domain.reset(token)

    def _train_step(model, opt_state, batch):
        if hp.micro_batches > 1:
            n = hp.micro_batches
            gsum = ref_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                  device=p.device),
                            tfm.param_tree(model))
            lsum = torch.zeros((), dtype=torch.float32, device=model.device)
            for i in range(n):
                mb = {k: v.reshape((n, v.shape[0] // n) + v.shape[1:])[i]
                      for k, v in batch.items()}
                l, g = value_and_grad(cfg, model, mb)
                with dom.task("backward", "accumulate", "model"):
                    gsum = ref_map(torch.add, gsum, g)
                    lsum = lsum + l
            with dom.task("backward", "accumulate", "model"):
                grads = ref_map(lambda g: g / n, gsum)
                loss = lsum / n
        else:
            loss, grads = value_and_grad(cfg, model, batch)
        with dom.task("update", "clip+adamw", "optimizer"):
            gnorm, opt_state = _update(model, opt_state, grads)
        return loss, gnorm, model, opt_state

    def _update(model, opt_state, grads):
        """Clip and AdamW, a parameter group at a time (each its own
        ``update`` task: a profiler range holds a few hundred ops, not
        every leaf's), in the reference's leaf order.  -> (the global
        norm, the new state); the parameters are updated in place."""
        ptree = tfm.param_tree(model)
        groups = _groups(ptree)
        sq = 0
        for g in groups:
            with dom.task("update", "norm " + "/".join(g), "optimizer"):
                sq = sum_squares(_at(grads, g), sq)
        gnorm = torch.sqrt(sq)
        m, v = _shell(opt_state["m"]), _shell(opt_state["v"])
        for g in groups:
            with dom.task("update", "/".join(g), "optimizer"):
                clipped, _ = clip_by_global_norm(_at(grads, g), hp.grad_clip,
                                                 norm=gnorm)
                new_p, st = adamw_update(
                    clipped, {"m": _at(m, g), "v": _at(v, g),
                              "count": opt_state["count"]},
                    _at(ptree, g), lr=hp.lr, weight_decay=hp.weight_decay,
                    moments_dtype=hp.moments_dtype)
                with torch.no_grad():
                    ref_map(lambda p, q: p.copy_(q), _at(ptree, g), new_p)
                _set(m, g, st["m"])
                _set(v, g, st["v"])
        return gnorm, {"m": m, "v": v, "count": st["count"]}

    return train_step


def _groups(tree) -> list[tuple]:
    """Key paths of a parameter tree's groups in :func:`ref_leaves` order:
    each top-level entry, and each layer of ``"layers"`` apart."""
    return [(k, i) if k == "layers" else (k,) for k in sorted(tree)
            for i in (sorted(tree[k]) if k == "layers" else (None,))]


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _shell(tree):
    """A copy of a parameter tree down to its groups, to put new groups
    in (the order of its keys kept)."""
    return {k: dict(v) if k == "layers" else v for k, v in tree.items()}


def _set(shell, path, sub):
    _at(shell, path[:-1])[path[-1]] = sub


# ---------------------------------------------------------------------------
# PartitionSpecs and meta arguments for a mesh (the dry run)
# ---------------------------------------------------------------------------
def opt_pspecs(param_pspecs, moments_dtype="float32"):
    """Optimizer-state PartitionSpecs mirror the parameter sharding (ZeRO-3:
    moments fully sharded the same way as their parameters).

    int8 moments are blocks of the flattened tensor: their block axis
    takes the first parameter axis's assignment, as in the reference.  A
    leaf under ``"layers"`` is one layer of the reference's stacked leaf,
    whose first axis is the unsharded scan axis, so its blocks are
    replicated there and here."""
    def mom(ps, stacked):
        if moments_dtype == "int8":
            lead = None if stacked or not len(ps) else ps[0]
            return {"q": P(lead), "s": P(lead)}
        return ps

    def walk(t, stacked):
        if isinstance(t, P):
            return mom(t, stacked)
        return {k: walk(v, stacked or k == "layers") for k, v in t.items()}

    return {"m": walk(param_pspecs, False), "v": walk(param_pspecs, False),
            "count": P()}


def batch_pspecs(cfg, mesh, shape):
    """PartitionSpecs for the input batch of a given assigned shape."""
    bp = batch_pspec(mesh, shape.global_batch)
    specs = {}
    if cfg.frontend == "audio":
        specs["features"] = P(*bp, None, None)
        specs["labels"] = P(*bp, None)
        specs["mask"] = P(*bp, None)
    elif cfg.frontend == "vision":
        specs["tokens"] = P(*bp, None)
        specs["vision"] = P(*bp, None, None)
    else:
        specs["tokens"] = P(*bp, None)
    return specs


def abstract_batch(cfg, shape):
    """``meta`` stand-ins for every model input (the reference's
    ShapeDtypeStructs, same shapes and dtypes)."""
    B, S = shape.global_batch, shape.seq_len

    def f(shp, dtype):
        return torch.empty(shp, dtype=dtype, device="meta")
    if shape.kind == "decode":
        return {"tokens": f((B, 1), torch.int32)}
    if cfg.frontend == "audio":
        return {"features": f((B, S, cfg.frontend_dim), torch.float32),
                "labels": f((B, S), torch.int32),
                "mask": f((B, S), torch.float32)}
    if cfg.frontend == "vision":
        nv = cfg.n_vision_tokens
        return {"tokens": f((B, S - nv), torch.int32),
                "vision": f((B, nv, cfg.d_model), torch.float32)}
    return {"tokens": f((B, S), torch.int32)}


@dataclasses.dataclass
class Assembled:
    """A step ready to plan: the function, its ``meta`` arguments, and the
    PartitionSpecs of its arguments and results on the mesh (trees shaped
    like them; a model's entry is shaped like ``param_tree``)."""
    step: object
    args: tuple
    in_specs: tuple
    out_specs: tuple


def assemble_train(cfg, mesh, shape, hp: TrainHParams | None = None):
    """The train step with ``meta`` (model, optimizer state, batch) and
    their specs on ``mesh``: the reference's ``assemble_train`` with
    PartitionSpecs in place of in/out shardings.  The step returns
    (loss, gnorm, model, state)."""
    hp = hp or TrainHParams()
    rules = make_rules_for_mesh(cfg, mesh)
    specs = tfm.model_specs(cfg)
    p_pspecs = make_pspecs(specs, rules)
    model = tfm.Model(cfg, abstract_params(specs), requires_grad=True)
    opt_state = adamw_init(tfm.param_tree(model),
                           moments_dtype=hp.moments_dtype)
    o_pspecs = opt_pspecs(p_pspecs, hp.moments_dtype)
    b_pspecs = batch_pspecs(cfg, mesh, shape)
    batch = abstract_batch(cfg, shape)
    return Assembled(make_train_step(cfg, hp), (model, opt_state, batch),
                     (p_pspecs, o_pspecs, b_pspecs),
                     (P(), P(), p_pspecs, o_pspecs))
