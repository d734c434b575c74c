"""Run one cell of ``BENCHMARK.json`` once and print one JSON result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

It measures ``repro_torch`` (``src/repro_torch`` of the checkout) on the
card it is started on and imports no JAX and nothing of the JAX package.
``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` also
profiles a few whole steps after the window and reports its per-layer
metrics.  The last lines of standard error, and the result's last key,
give each number the correctness check compared beside its limit.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()     # the process's start, near enough

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def log(msg):
    print(f"[perfbench] {msg}", file=sys.stderr, flush=True)


def forbidden_modules():
    """Top-level module names of JAX or the JAX package in this process."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


class Context:
    """What a per-layer reader (``metrics/<name>.py``) reads: the cell's
    files, the window's counts, and the traced sub-window (``trace``,
    ``trace_info``), any of which may be missing; ``log`` says on standard
    error why a reader that found something left its metric out."""

    def __init__(self, cell, res):
        self.log = log
        from perfbench.harness import counting
        self.cell, self.config, self.mix = cell, cell.config, cell.mix
        self.kind = cell.mix["kind"]
        self.window = res["window"]
        self.trace = res.get("trace")
        self.trace_info = res.get("trace_info", {})
        self.count = counting


def execute(name, seed, seconds, trace, device, bench_json=None,
            root=HERE, t_start=T_START):
    """Run the cell on ``device`` -> the result line as a dict."""
    import torch

    from perfbench.harness import check, serve, spec, train
    cell = spec.load(name, bench_json, root)
    driver = {"train": train, "serve": serve}[cell.mix["kind"]]
    res = driver.run(cell, seed, seconds, bool(trace), device, log)
    setup_s = res["t_window"] - t_start
    e2e = dict(res["e2e"], setup_s=setup_s)
    if trace:
        ctx = Context(cell, res)
        metrics = {}
        for m in cell.per_layer:
            v = spec.reader(m["name"], root)(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    if device.type == "cuda":
        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
               "count": 1}
    else:
        dev = {"platform": "cpu", "kind": "cpu", "count": 1}
    dev["memory_peak_bytes"] = res["memory_peak_bytes"]
    out = {"correct": check.verdict(res["checks"]) and not res["failed"],
           "attempted": res["attempted"], "failed": res["failed"],
           "metrics": metrics, "device": dev}
    tr = res.get("trace")
    if tr is not None:
        dev["busy_s"], dev["window_s"] = tr.busy_s, tr.window_s
        out["breakdown"] = {"device_ops": tr.device_ops(),
                            "idle_gaps": tr.idle_gaps()}
        log(f"trace: {len(tr.device)} device events, reduced in "
            f"{tr.reduce_s:.1f} s")
    log(f"set-up {setup_s:.2f} s, reference {res['reference_s']:.2f} s")
    out["checks"] = res["checks"]
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    spec_entry = json.loads((ROOT / "BENCHMARK.json").read_text())
    chips = next((w["chips"] for w in spec_entry["workloads"]
                  if w["name"] == a.workload), 1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"needs {chips} CUDA device(s): available "
            f"{torch.cuda.is_available()}, count "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 3
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    out = execute(a.workload, a.seed, a.seconds, a.trace, device)
    bad = forbidden_modules()
    if bad:
        log(f"modules of JAX or the JAX package were loaded: {bad}")
        return 4
    for k, c in out["checks"].items():
        log(f"check {k} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
