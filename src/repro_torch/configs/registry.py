"""Architecture registry: --arch <id> resolution.  Counterpart of
``repro.configs.registry``: the same ten ids, each config a copy of the
JAX package's file of the same name."""
from __future__ import annotations

import dataclasses
import importlib

ARCH_IDS = [
    "deepseek-67b", "gemma2-27b", "phi3-medium-14b", "stablelm-1.6b",
    "hubert-xlarge", "deepseek-v2-236b", "grok-1-314b", "hymba-1.5b",
    "mamba2-130m", "internvl2-26b",
]

_MODULES = {a: "repro_torch.configs." + a.replace("-", "_").replace(".", "_")
            for a in ARCH_IDS}


def _mod(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    return importlib.import_module(_MODULES[arch])


def get_config(arch: str, **overrides):
    cfg = _mod(arch).CONFIG
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def get_smoke_config(arch: str):
    return _mod(arch).smoke_config()
