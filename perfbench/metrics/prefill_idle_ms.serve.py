"""Device idle ms a traced engine step inside the program's
``serve.prefill`` ranges: the device's gaps (``Trace.gaps``, between its
kernels, copies and sets) cut to each range's interval.  Host ops and
device events share the profiler's clock."""

NAME = "serve.prefill"


def read(ctx):
    if ctx.kind != "serve" or ctx.trace is None or not ctx.trace.device:
        return None
    us = idle_us(ctx.trace, NAME)
    return None if us is None else us / 1e3 / ctx.trace_info["steps"]


def idle_us(trace, name):
    """Device idle us inside the outermost host ranges named ``name``
    (None where there is none)."""
    spans = [(r.time_range.start, r.time_range.end)
             for e in trace.host for r in _outermost(e, name)]
    if not spans:
        return None
    return sum(max(0.0, min(hi, g1) - max(lo, g0))
               for lo, hi in spans for g0, g1 in trace.gaps)


def _outermost(e, name):
    if e.name == name:
        return [e]
    return [r for c in e.cpu_children for r in _outermost(c, name)]
