"""The training driver: ``repro_torch.train.step.make_train_step`` on the
seeded bf16 model, fed a fresh batch of uniform token ids every step.

Set-up builds the model, the optimizer state and the step once, drives
them through the first ``check_steps`` steps (which warm every shape the
window uses), reads what the comparison needs, and hands the same objects
to the window.  The window runs whole steps, each ended by reading its
loss as a training loop logs it, until ``seconds`` have passed; its rate
is the tokens of those steps over their time.  Once it has closed and the
program's state is freed, the plain reference follows the first steps
from the same seed and batches.
"""
from __future__ import annotations

import gc
import importlib
import time

import torch

from . import check, counting, spec, traffic, weights


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(cell, seed, seconds, trace, device, log):
    from repro_torch.models import transformer as tfm
    from repro_torch.optim import adamw_init
    from repro_torch.train.step import TrainHParams, make_train_step

    cfg, mix = cell.config, cell.mix
    B, S, V = mix["batch"], mix["seq"], cfg["vocab"]
    hp = mix["optimizer"]
    n_check = cell.cell["check"]["steps"]
    mcfg = spec.model_config(cfg)
    W = weights.make(cfg, seed, device)
    check.same_layout(W, tfm.model_specs(mcfg))
    model = tfm.Model(mcfg, W, requires_grad=True)
    del W
    opt = adamw_init(tfm.param_tree(model), moments_dtype=hp["moments_dtype"])
    step = make_train_step(mcfg, TrainHParams(
        lr=hp["lr"], weight_decay=hp["weight_decay"],
        grad_clip=hp["grad_clip"], moments_dtype=hp["moments_dtype"]))
    names = weights.paths(cfg)
    got = {"losses": []}
    state = {"model": model, "opt": opt, "i": 0}

    def one():
        tokens = traffic.batch_tokens(seed, state["i"], B, S, V, device)
        loss, _, state["model"], state["opt"] = step(
            state["model"], state["opt"], {"tokens": tokens})
        state["i"] += 1
        return float(loss)          # the loop reads each step's loss

    for i in range(n_check):
        got["losses"].append(one())
        if i == 0:   # the first gradient, as AdamW's first moment holds it
            g = weights.leaf_norms(state["opt"]["m"], names)
            got["grad"] = dict(zip(names, [x / (1 - 0.9) for x in g]))
    p = tfm.param_tree(state["model"])
    W0 = weights.make(cfg, seed, device)
    with torch.no_grad():
        got["change"] = dict(zip(names, torch.stack([
            (weights.get(p, n).float() - weights.get(W0, n).float()).norm()
            for n in names]).tolist()))
    del W0, p
    log(f"set-up steps: losses {got['losses']}")

    # -- the window -------------------------------------------------------
    _sync(device)
    t0 = time.perf_counter()
    steps, losses = 0, []
    while True:
        losses.append(one())
        steps += 1
        if time.perf_counter() - t0 >= seconds:
            break
    _sync(device)
    t1 = time.perf_counter()
    win = t1 - t0
    failed = sum(1 for x in losses if not x == x or abs(x) == float("inf"))
    out = dict(
        t_window=t0, attempted=steps, failed=failed,
        window=dict(seconds=win, steps=steps, tokens=steps * B * S,
                    flops=steps * counting.train_flops(cfg, B, S)),
        e2e={"train_tokens_per_s": steps * B * S / win})
    log(f"window: {steps} steps in {win:.3f} s, last loss {losses[-1]:.5f}")

    if trace:
        from . import trace as tr_mod
        n = mix["trace_steps"]
        out["trace"], _ = tr_mod.capture(lambda: [one() for _ in range(n)],
                                         device)
        out["trace_info"] = dict(steps=n)
    out["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(device)
                                if device.type == "cuda" else 0)

    # -- the comparison, with the program's state freed ---------------------
    del model, opt, state, step
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    ref_mod = importlib.import_module(
        f"perfbench.reference.{cfg['reference']}")
    ref = ref_mod.train(
        cfg, weights.make(cfg, seed, device),
        (traffic.batch_tokens(seed, i, B, S, V, device)
         for i in range(n_check)), hp)
    out["reference_s"] = time.perf_counter() - t
    out["checks"] = check.train_numbers(got, ref, cell.cell["limits"])
    out["readings"] = {"got": got, "ref": ref}
    log("compared and not: " + ", ".join(
        f"{k} {v!r}" for k, v in check.train_values(got, ref).items()))
    for k in ("grad", "change"):
        g = check.leaf_gaps(got[k], ref[k], list(ref[k]))
        worst = sorted(g, key=g.get)[-3:]
        log(f"worst {k} leaves: " + ", ".join(
            f"{'/'.join(n)} {g[n]:.4g}" for n in worst))
    return out
