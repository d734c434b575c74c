"""Median host time, in ms, of the serve engine's ``prefill`` task spans in
the window (its TracingDomain): each admitted prompt's prefill (its K/V written into the slot's cache, the first token read back).  Each ends at a host sync."""

import statistics


def read(ctx):
    if ctx.kind != "serve":
        return None
    d = [(e - s) * 1e3 for cat, s, e in ctx.window["spans"] if cat == "prefill"]
    return statistics.median(d) if d else None
