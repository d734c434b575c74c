"""What a run reads: the cell's entry in ``BENCHMARK.json`` and the files
found by its names: ``configs/<config>.json``, ``traffic/<traffic>.json``,
``workloads/<cell>.json`` and ``metrics/<metric>.py``."""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]      # perfbench/
ROOT = BENCH.parent                              # the checkout


@dataclasses.dataclass
class Cell:
    name: str
    config: dict          # configs/<config>.json
    mix: dict             # traffic/<traffic>.json
    cell: dict            # workloads/<cell>.json: limits, check sizes, why
    end_to_end: list      # BENCHMARK.json entries this cell reports
    per_layer: list


def _load(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load(name: str, bench_json: Path | None = None,
         root: Path = BENCH) -> Cell:
    spec = _load(bench_json or root.parent / "BENCHMARK.json")
    entry = next((w for w in spec["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    return Cell(
        name=name,
        config=_load(root / "configs" / f"{entry['config']}.json"),
        mix=_load(root / "traffic" / f"{entry['traffic']}.json"),
        cell=_load(root / "workloads" / f"{name}.json"),
        end_to_end=[m for m in spec["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in spec["per_layer"] if _reports(m, name)])


def reader(metric: str, root: Path = BENCH):
    """The ``read(ctx)`` function of ``metrics/<metric>.py``."""
    path = root / "metrics" / f"{metric}.py"
    s = importlib.util.spec_from_file_location(
        "perfbench_metric_" + metric.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(s)
    s.loader.exec_module(mod)
    return mod.read


def model_config(config: dict):
    """The program's ``ModelConfig`` from a config file's model keys."""
    from repro_torch.models.config import ModelConfig
    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    return ModelConfig(**{k: v for k, v in config.items() if k in fields})
