"""Share of the traced sub-window of whole train steps in which no
device operation ran (the union of the profiler's kernel, copy and set
intervals against the host's window), in percent."""


def read(ctx):
    if ctx.kind != "train" or ctx.trace is None or not ctx.trace.device:
        return None
    tr = ctx.trace
    return 100 * max(0.0, 1 - tr.busy_s / tr.window_s)
