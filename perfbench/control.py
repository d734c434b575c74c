"""Readings from which the correctness limits are set (PERF.md gives
them): the program on many seeds, and on a few seeds the control (the
plain reference computed in float8 e4m3, the precision below the
configurations' bf16) and, for training, the fault of a half batch.

    python3 perfbench/control.py --workload <cell> --seeds 1,2,3 \\
        --control-seeds 1,2,3 [--seconds 8]

One JSON line a reading on standard output.  The benchmark's own runs do
not run this; ``tests/test_perfbench_control.py`` holds it at a size a
CPU test run can take.
"""
from __future__ import annotations

import argparse
import gc
import importlib
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings(name, seeds, control_seeds, seconds, device, bench_json=None,
             root=None, log=lambda m: None, emit=print):
    """Emit one dict a reading; returns them all."""
    import torch

    from perfbench.harness import check, serve, spec, traffic, train, weights
    kw = {} if root is None else {"root": root}
    cell = spec.load(name, bench_json, **kw)
    cfg, mix = cell.config, cell.mix
    ref_mod = importlib.import_module(f"perfbench.reference.{cfg['reference']}")
    out = []

    def put(d):
        out.append(d)
        emit(d)
    for seed in seeds:
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        if mix["kind"] == "train":
            res = train.run(cell, seed, 0, False, device, log)
            r = res["readings"]
            put({"seed": seed, "side": "program",
                 **check.train_values(r["got"], r["ref"])})
            if seed not in control_seeds:
                continue
            B, S, V = mix["batch"], mix["seq"], cfg["vocab"]
            ref = r["ref"]
            n = cell.cell["check"]["steps"]
            for side, kw2 in (("control", {"fp8": True}),
                              ("half_batch", {"half": True})):
                got = ref_mod.train(
                    cfg, weights.make(cfg, seed, device),
                    (traffic.batch_tokens(seed, i, B, S, V, device)
                     for i in range(n)), mix["optimizer"], **kw2)
                put({"seed": seed, "side": side,
                     **check.train_values(got, ref)})
        else:
            res = serve.run(cell, seed, seconds, False, device, log)
            put({"seed": seed, "side": "program",
                 "tokens": res["checked_tokens"],
                 "logit_gap": res["checks"]["logit_gap"]["value"]})
            if seed in control_seeds:
                gaps = serve.served_gaps(cfg, weights.make(cfg, seed, device),
                                         res["jobs"], device, fp8=True)
                put({"seed": seed, "side": "control", "tokens": len(gaps),
                     "logit_gap": max(gaps)})
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=8.0)
    a = ap.parse_args()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    if not torch.cuda.is_available():
        sys.exit("control readings are taken on the card")
    dev = torch.device("cuda", 0)
    seeds = [int(s) for s in a.seeds.split(",")]
    ctrl = {int(s) for s in a.control_seeds.split(",") if s}
    readings(a.workload, seeds, ctrl, a.seconds, dev,
             log=lambda m: print(f"[control] {m}", file=sys.stderr,
                                 flush=True),
             emit=lambda d: print(json.dumps(d), flush=True))


if __name__ == "__main__":
    main()
