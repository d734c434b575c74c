"""Fault-tolerant training loop.  Counterpart of ``repro.train.loop``.

* deterministic resume — the data pipeline is a pure function of step,
  so kill/restart reproduces the uninterrupted run bit-exactly (asserted
  in tests/test_torch_train.py, and on the card by chip_smoke.py);
* periodic checkpoints, one at the last step, and one when SIGTERM
  arrives: the loop drains the step in flight, saves and exits
  (preemption-safe);
* per-step watchdog: steps exceeding ``watchdog_factor``× the EWMA step
  time are flagged;
* every step, data fetch, save and restore is a task of the paper's task
  tracing (``repro_torch.core.tracing``), and the step's ``forward``,
  ``backward`` and ``update`` tasks nest under its ``train`` task on the
  same domain.

Parameters come from ``init_model(cfg, seed)`` (a seeded
``torch.Generator`` on the loop's device) unless the caller passes a
model; JAX's ``jax.random`` init cannot be reproduced, so the parity
tests pass the reference's parameters in.  Checkpoints are the port's
``ckpt`` format with the port's per-layer tree (``{"p": param_tree,
"o": opt_state}``), which the JAX package's layout does not match.
"""
from __future__ import annotations

import dataclasses
import signal
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.ckpt import CheckpointManager
from repro_torch.core.engine import ref_map
from repro_torch.core.tracing import TracingDomain
from repro_torch.models import transformer as tfm
from repro_torch.optim import adamw_init

from .step import TrainHParams, make_train_step


@dataclasses.dataclass
class LoopConfig:
    steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: str = "runs/ckpt"
    keep: int = 3
    log_every: int = 10
    watchdog_factor: float = 4.0
    seed: int = 0


def train(cfg, data_fn, loop: LoopConfig, hp: TrainHParams | None = None,
          domain: TracingDomain | None = None, resume: bool = True,
          params=None, opt_state=None, device=None):
    """Returns (model, opt_state, history).  ``params`` is a model
    (``repro_torch.models.transformer.Model``) whose parameters require
    grad; it is trained in place.  ``device`` is the card unless the
    caller asks for the CPU; a model passed in stays on its own."""
    hp = hp or TrainHParams()
    dom = domain or TracingDomain("train")
    mgr = CheckpointManager(loop.ckpt_dir, keep=loop.keep)
    step_fn = make_train_step(cfg, hp, domain=dom)

    if params is None:
        params = tfm.init_model(cfg, loop.seed, device=resolve_device(device),
                                requires_grad=True)
    if opt_state is None:
        opt_state = adamw_init(tfm.param_tree(params),
                               moments_dtype=hp.moments_dtype)
    dev = params.device
    start = 0
    if resume and mgr.latest_step() is not None:
        with dom.task("checkpoint", "restore", "ckpt"):
            ptree = tfm.param_tree(params)
            state, manifest = mgr.restore({"p": ptree, "o": opt_state})
            with torch.no_grad():
                ref_map(lambda p, q: p.copy_(q), ptree, state["p"])
            opt_state = state["o"]
        start = manifest["step"] + 1
        print(f"[resume] restored step {manifest['step']}")

    stop = {"flag": False}
    prev = signal.getsignal(signal.SIGTERM)

    def on_term(sig, frame):
        stop["flag"] = True

    signal.signal(signal.SIGTERM, on_term)

    history = []
    ewma = None
    try:
        for step in range(start, loop.steps):
            with dom.task("train", "step", "loop", step=step):
                with dom.task("data", "fetch", "pipeline"):
                    batch = {k: torch.as_tensor(v, device=dev)
                             for k, v in data_fn(step).items()}
                t0 = time.perf_counter()
                loss, gnorm, params, opt_state = step_fn(params, opt_state,
                                                         batch)
                loss = float(loss)
                dt = time.perf_counter() - t0
            if not np.isfinite(loss):
                raise FloatingPointError(f"loss diverged at step {step}")
            ewma = dt if ewma is None else 0.9 * ewma + 0.1 * dt
            straggler = dt > loop.watchdog_factor * ewma
            if straggler:
                dom.tag_task("straggler-step")
                print(f"[watchdog] step {step} took {dt:.2f}s "
                      f"(ewma {ewma:.2f}s) — straggler flagged")
            history.append({"step": step, "loss": loss,
                            "gnorm": float(gnorm), "dt": dt})
            if step % loop.log_every == 0:
                print(f"step {step:5d} loss {loss:.4f} "
                      f"gnorm {float(gnorm):.3f} {dt*1e3:.0f}ms")
            if (step + 1) % loop.ckpt_every == 0 or stop["flag"] or \
                    step + 1 == loop.steps:
                with dom.task("checkpoint", "save", "ckpt", step=step):
                    mgr.save({"p": tfm.param_tree(params), "o": opt_state},
                             step)
            if stop["flag"]:
                print(f"[signal] SIGTERM: drained and checkpointed at "
                      f"step {step}")
                break
        mgr.wait()
    finally:
        signal.signal(signal.SIGTERM, prev)
    return params, opt_state, history
