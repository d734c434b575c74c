"""Assigned input shapes × applicability matrix.  A copy of
``repro.configs.shapes`` (pure data), so both packages skip the same
cells for the same reasons."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Shape:
    name: str
    seq_len: int
    global_batch: int
    kind: str        # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": Shape("train_4k", 4096, 256, "train"),
    "prefill_32k": Shape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": Shape("decode_32k", 32768, 128, "decode"),
    "long_500k": Shape("long_500k", 524288, 1, "decode"),
}


def applicable(cfg, shape_name: str) -> tuple[bool, str]:
    """(runs?, reason-if-skipped)."""
    sh = SHAPES[shape_name]
    if sh.kind == "decode" and not cfg.causal:
        return False, "encoder-only arch has no autoregressive decode"
    if shape_name == "long_500k" and not cfg.sub_quadratic:
        return False, ("full-attention arch: O(S) per decoded token at "
                       "S=524288 with no sub-quadratic path (DESIGN.md)")
    return True, ""


def cell_list(arch_ids, get_config):
    """All (arch, shape) cells with status."""
    cells = []
    for a in arch_ids:
        cfg = get_config(a)
        for s in SHAPES:
            ok, why = applicable(cfg, s)
            cells.append((a, s, ok, why))
    return cells
