"""Device ms a traced training step of the kernels, copies and sets
launched inside the program's ``train.backward`` ranges: the gradients'
``torch.autograd.grad``, the remat layers' recompute within it, and the
micro-batches' accumulation.  The backward runs on autograd's device
thread, so the host ops of every other thread that start inside a range
count with it (the profiler's launch correlation ties each device event
to the host op that launched it, and each is counted once)."""

NAME = "train.backward"


def read(ctx):
    if ctx.kind != "train" or ctx.trace is None or not ctx.trace.device:
        return None
    us = range_us(ctx.trace, NAME)
    return None if us is None else us / 1e3 / ctx.trace_info["steps"]


def range_us(trace, name):
    """Device us launched inside the outermost host ranges named ``name``
    (None where there is none): each range's own ops, and the top-level
    host ops of other threads that start inside it."""
    ranges = [r for e in trace.host for r in outermost(e, name)]
    if not ranges:
        return None
    us = 0.0
    for r in ranges:
        lo, hi = r.time_range.start, r.time_range.end
        us += launched_us(r) + sum(
            launched_us(e) for e in trace.host
            if e.thread != r.thread and lo <= e.time_range.start <= hi)
    return us


def outermost(e, name):
    """``e`` or its outermost descendants named ``name``."""
    if e.name == name:
        return [e]
    return [r for c in e.cpu_children for r in outermost(c, name)]


def launched_us(e):
    """Device us of the events ``e`` and its descendants launched.  A
    range launches nothing itself: the device's mirror of the range (a
    ``gpu_user_annotation``) is not work."""
    own = 0.0 if getattr(e, "is_user_annotation", False) else \
        sum(k.duration for k in e.kernels)
    return own + sum(launched_us(c) for c in e.cpu_children)
