"""The benchmark's data files: every one parses, names what exists, and
fits the contract's shape."""
import dataclasses
import json
import re
from pathlib import Path

import pytest

from perfbench.harness import spec, weights

BENCH = Path(__file__).resolve().parents[1]
SPEC = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["perfbench"]
    assert 1 <= SPEC["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in SPEC[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


@pytest.mark.parametrize("c", SPEC["configs"], ids=lambda c: c["name"])
def test_config_file(c):
    assert set(c) == {"name", "source", "file", "reduced", "why"}
    d = json.loads((BENCH.parent / c["file"]).read_text())
    assert d["name"] == c["name"] and d["source"] == c["source"]
    assert d["reduced"] == c["reduced"]
    assert (BENCH / "reference" / f"{d['reference']}.py").exists()
    from repro_torch.models import transformer as tfm
    from repro_torch.models.config import ModelConfig
    cfg = spec.model_config(d)
    known = {f.name for f in dataclasses.fields(ModelConfig)}
    assert d["n_layers"] == cfg.n_layers and set(d) & known
    # the benchmark's weights have the program's names and shapes
    assert _shapes(weights.layout(d)) == _shapes(tfm.model_specs(cfg))


def _shapes(t):
    if isinstance(t, dict):
        return {k: _shapes(v) for k, v in t.items()}
    return tuple(t[0]) if isinstance(t, tuple) else tuple(t.shape)


@pytest.mark.parametrize("w", SPEC["workloads"], ids=lambda w: w["name"])
def test_workload_files(w):
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert w["chips"] == 1 and len(w["why"]) <= 200
    cell = spec.load(w["name"])
    assert cell.mix["kind"] in ("train", "serve")
    assert set(cell.cell["limits"]) and "check" in cell.cell
    e2e = [m["name"] for m in cell.end_to_end]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer
    for m in cell.per_layer:    # each moves a metric this cell reports
        assert m["moves"] in e2e


@pytest.mark.parametrize("m", SPEC["per_layer"], ids=lambda m: m["name"])
def test_metric_readers(m):
    assert set(m) <= {"name", "unit", "better", "source", "layer", "moves",
                      "workloads"}
    assert callable(spec.reader(m["name"]))
