"""The port imports torch, numpy and the standard library only: never
``jax`` and nothing of the JAX package ``repro``.  Also pins how the kernel
build names its libraries."""
import os
import re
import subprocess
import sys
from pathlib import Path

import torch

from repro_torch.kernels import _build

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _modules():
    return sorted("repro_torch." + ".".join(
        p.relative_to(PORT).with_suffix("").parts).replace(".__init__", "")
        for p in PORT.rglob("*.py"))


def test_importing_every_module_loads_no_jax_or_repro():
    mods = _modules()
    assert "repro_torch.serve.engine" in mods
    assert "repro_torch.core.engine" in mods
    assert "repro_torch.sims.memsys" in mods
    for m in ("dse.runner", "dse.sweep", "dse.schedule", "dse.report",
              "obs.bus", "models.moe", "models.mla", "configs.shapes",
              "configs.deepseek_v2_236b", "configs.gemma2_27b",
              "configs.grok_1_314b", "configs.deepseek_67b",
              "configs.phi3_medium_14b", "configs.internvl2_26b",
              "configs.hubert_xlarge", "sims.onira", "sims.opgraph",
              "sims.triosim", "sims.xlat", "core.tracers", "core.daisen",
              "core.monitor", "obs.sinks", "obs.bridge", "obs.perfetto",
              "obs.dashboard", "ckpt", "ckpt.checkpoint", "dse.mux",
              "dse.search", "dse.search.driver", "dse.search.halving",
              "dse.search.bo", "dse.search.warm", "optim", "optim.adamw",
              "optim.compress", "data.pipeline", "train", "train.step",
              "train.loop", "launch.train",
              "kernels.flash_attention.autograd", "kernels.ssd.autograd",
              "core.pdes", "launch.mesh", "dse.cache", "parallel",
              "parallel.sharding", "launch.dryrun", "launch.roofline",
              "launch.report", "serve.step"):
        assert f"repro_torch.{m}" in mods
    code = (
        "import importlib, json, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m.removesuffix('.__init__'))\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.')]\n"
        "print(json.dumps(bad))\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-B", "-c", code], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_sources_have_no_jax_or_repro_imports():
    pat = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)", re.M)
    files = list(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    hits = [f"{f}: {m.group(0).strip()}" for f in files
            for m in pat.finditer(f.read_text())]
    assert hits == []


def test_kernel_libraries_are_keyed_by_source_hash(monkeypatch):
    a = _build.lib_path("ssd")
    assert a.parent == _build.BUILD_DIR and a.name.startswith("ssd-")
    assert a == _build.lib_path("ssd")
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ["-G"])
    assert _build.lib_path("ssd") != a
    assert all((_build.CSRC / f"{k}.cu").exists() for k in _build.KERNELS)
    # the build directory is git-ignored
    assert "build/" in (ROOT / ".gitignore").read_text().split()


def test_entry_points_refuse_cuda_when_absent(monkeypatch):
    from repro_torch import resolve_device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    try:
        resolve_device()
    except RuntimeError as e:
        assert "device='cpu'" in str(e)
    else:
        raise AssertionError("resolve_device() fell back silently")
    assert resolve_device("cpu").type == "cpu"
