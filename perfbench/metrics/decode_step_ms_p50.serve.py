"""Median host time, in ms, of the serve engine's ``decode`` task spans in
the window (its TracingDomain): each batched decode step over the slots (its tokens read back).  Each ends at a host sync."""

import statistics


def read(ctx):
    if ctx.kind != "serve":
        return None
    d = [(e - s) * 1e3 for cat, s, e in ctx.window["spans"] if cat == "decode"]
    return statistics.median(d) if d else None
