"""A whole run on the CPU at a small size: the result line's keys, the
refusal without a card, no JAX in the process, and a new cell found by
its files alone."""
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from perfbench import run
from perfbench.tests import _smoke

ROOT = Path(__file__).resolve().parents[2]
KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    return _smoke.tree(tmp_path_factory.mktemp("bench") / "perfbench")


def _execute(small, cell, trace, seed=2 ** 31 + 99):
    torch.manual_seed(0)
    return run.execute(cell, seed, 0.5, trace, torch.device("cpu"),
                       bench_json=small / "BENCHMARK.json", root=small,
                       t_start=time.perf_counter())


@pytest.mark.parametrize("cell", ["hymba-train-2k", "phi3-serve-docs"])
@pytest.mark.parametrize("trace", [0, 1])
def test_result_line(small, cell, trace):
    out = _execute(small, cell, trace)
    assert list(out)[-1] == "checks"
    assert set(out) == KEYS | ({"breakdown"} if trace else set())
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] > 0
    assert set(out["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    spec = json.loads((small / "BENCHMARK.json").read_text())
    side = spec["per_layer" if trace else "end_to_end"]
    want = {m["name"] for m in side
            if cell in m.get("workloads", [cell])}
    if trace:    # no device on the CPU: only the host-side readers read
        assert set(out["metrics"]) <= want and out["metrics"]
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(out["metrics"]) == want
    for k, c in out["checks"].items():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]
    json.dumps(out)


def test_refuses_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert run.main(["--workload", "hymba-train-2k", "--seed", "1",
                     "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""


def test_no_jax_in_the_process(small):
    code = (
        "import sys, time, torch; sys.path[:0] = [%r, %r];"
        "from perfbench import run;"
        "run.execute('phi3-serve-docs', 3, 0.3, 0, torch.device('cpu'),"
        " bench_json=__import__('pathlib').Path(%r) / 'BENCHMARK.json',"
        " root=__import__('pathlib').Path(%r), t_start=time.perf_counter());"
        "print(run.forbidden_modules())"
    ) % (str(ROOT), str(ROOT / "src"), str(small), str(small))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1] == "[]"


def test_empty_checkout_refuses(tmp_path):
    """A directory that holds only BENCHMARK.json and perfbench/ has no
    program to measure: the run exits non-zero and prints no result."""
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                        "hymba-train-2k", "--seed", "1", "--seconds", "1"],
                       cwd=tmp_path, capture_output=True, text=True,
                       env=env, timeout=300)
    assert p.returncode != 0 and p.stdout == ""


def test_new_cell_found_by_its_files(small, tmp_path):
    """A configuration, a traffic mix, a cell and a per-layer metric added
    as files and entries, no code edited: the run finds each by name."""
    t = tmp_path / "perfbench"
    shutil.copytree(small, t)
    cfg = json.loads((t / "configs" / "phi3-medium-14b.json").read_text())
    cfg.update(name="phi3-other", n_layers=2)
    (t / "configs" / "phi3-other.json").write_text(json.dumps(cfg))
    mix = json.loads((t / "traffic" / "docs-closed-32.json").read_text())
    mix["clients"] = 2
    (t / "traffic" / "docs-closed-2.json").write_text(json.dumps(mix))
    (t / "workloads" / "phi3-other-few.json").write_text(json.dumps(
        {"why": "two clients", "check": {"served_tokens": 16},
         "limits": {"logit_gap": 0.5}}))
    (t / "metrics" / "requests.serve.py").write_text(
        "def read(ctx):\n    return ctx.window['requests']\n")
    spec = json.loads((t / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "phi3-other-few",
                              "config": "phi3-other",
                              "traffic": "docs-closed-2", "chips": 1,
                              "why": "two clients"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "phi3-serve-docs" in m.get("workloads", []):
            m["workloads"].append("phi3-other-few")
    spec["per_layer"].append({"name": "requests.serve", "unit": "requests",
                              "better": "higher", "source": "host_clock",
                              "layer": "serve engine",
                              "moves": "serve_tokens_per_s",
                              "workloads": ["phi3-other-few"]})
    (t / "BENCHMARK.json").write_text(json.dumps(spec))
    for trace, want in ((0, {"serve_tokens_per_s", "ttft_p95_ms",
                             "setup_s"}), (1, {"requests.serve"})):
        out = run.execute("phi3-other-few", 5, 0.5, trace,
                          torch.device("cpu"),
                          bench_json=t / "BENCHMARK.json", root=t,
                          t_start=time.perf_counter())
        assert out["correct"] and want <= set(out["metrics"])


@pytest.mark.card
def test_cells_run_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for w in spec["workloads"]:
        p = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                            w["name"], "--seed", "11", "--seconds", "2"],
                           cwd=ROOT, capture_output=True, text=True,
                           timeout=900)
        assert p.returncode == 0, p.stderr[-3000:]
        assert json.loads(p.stdout.strip().splitlines()[-1])["correct"]
