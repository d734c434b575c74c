"""A copy of the benchmark's data files at a size the CPU tests can run:
the same configurations, traffic and cells with every size cut."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]

SMALL_CONFIG = {
    "hymba-1.5b": dict(n_layers=4, d_model=64, n_heads=4, n_kv_heads=2,
                       head_dim=16, d_ff=128, vocab=128, window=8,
                       ssm_state=8, ssm_headdim=16, ssm_chunk=8),
    "phi3-medium-14b": dict(n_layers=3, d_model=64, n_heads=4, n_kv_heads=2,
                            head_dim=16, d_ff=128, vocab=128),
}
SMALL_TRAFFIC = {
    "train": dict(batch=2, seq=32),
    "serve": dict(clients=4, max_batch=4, max_len=64, block=4, trace_steps=3,
                  prompt={"median": 20, "sigma": 0.35, "min": 8, "max": 40},
                  max_new={"median": 4, "sigma": 0.7, "min": 2, "max": 8}),
}


def _rw(src, dst, **update):
    d = json.loads(src.read_text())
    d.update(update)
    dst.write_text(json.dumps(d))


def tree(dst: Path) -> Path:
    """The benchmark's files under ``dst`` (a stand-in for ``perfbench/``
    with its ``BENCHMARK.json`` beside it), cut to the small sizes."""
    dst = Path(dst)
    shutil.copytree(BENCH / "metrics", dst / "metrics")
    for sub in ("configs", "traffic", "workloads"):
        (dst / sub).mkdir(parents=True)
    for f in (BENCH / "configs").glob("*.json"):
        _rw(f, dst / "configs" / f.name, **SMALL_CONFIG[f.stem])
    for f in (BENCH / "traffic").glob("*.json"):
        kind = json.loads(f.read_text())["kind"]
        _rw(f, dst / "traffic" / f.name, **SMALL_TRAFFIC[kind])
    for f in (BENCH / "workloads").glob("*.json"):
        shutil.copy(f, dst / "workloads" / f.name)
    shutil.copy(BENCH.parent / "BENCHMARK.json", dst / "BENCHMARK.json")
    return dst
