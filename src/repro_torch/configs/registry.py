"""Architecture registry: --arch <id> resolution.

The port serves the architectures whose blocks it has: attention + MLP
(stablelm-1.6b), SSD (mamba2-130m) and the hybrid of both (hymba-1.5b).
The other ids of ``repro.configs`` need MoE, MLA or a modality frontend,
which come with later slices of the port (ROADMAP.md, queue 1).
"""
from __future__ import annotations

import dataclasses
import importlib

ARCH_IDS = ["stablelm-1.6b", "hymba-1.5b", "mamba2-130m"]

NOT_PORTED = ["deepseek-67b", "gemma2-27b", "phi3-medium-14b",
              "hubert-xlarge", "deepseek-v2-236b", "grok-1-314b",
              "internvl2-26b"]

_MODULES = {a: "repro_torch.configs." + a.replace("-", "_").replace(".", "_")
            for a in ARCH_IDS}


def _mod(arch: str):
    if arch in NOT_PORTED:
        raise NotImplementedError(
            f"arch {arch!r} is not ported to repro_torch yet; see "
            f"ROADMAP.md queue 1 (model path: MoE, MLA, frontends)")
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    return importlib.import_module(_MODULES[arch])


def get_config(arch: str, **overrides):
    cfg = _mod(arch).CONFIG
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def get_smoke_config(arch: str):
    return _mod(arch).smoke_config()
