"""95th percentile (numpy, linear), in ms, of the serve engine's
``queue`` task spans in the window (its TracingDomain): a request's wait
from ``submit`` until a step's admission takes it, just before its
prefill.  Only spans that start and end within the window, whose edges
the window's ``step`` spans mark, count."""

import numpy as np


def read(ctx):
    if ctx.kind != "serve":
        return None
    spans = ctx.window["spans"]
    steps = [(s, e) for cat, s, e in spans if cat == "step"]
    if not steps:
        return None
    lo, hi = min(s for s, _ in steps), max(e for _, e in steps)
    d = [(e - s) * 1e3 for cat, s, e in spans
         if cat == "queue" and lo <= s and e <= hi]
    return float(np.percentile(d, 95)) if d else None
