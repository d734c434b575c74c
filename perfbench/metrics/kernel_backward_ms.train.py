"""Device ms a training step of the kernels launched under the backward
nodes of the two kernels' autograd Functions (``FlashAttentionFn``,
``SSDFn``), attributed by the profiler's launch correlation."""

NODES = ("FlashAttentionFnBackward", "SSDFnBackward")


def read(ctx):
    if ctx.kind != "train" or ctx.trace is None:
        return None
    us = ctx.trace.under(*NODES)
    if not us:
        return None
    return us / 1e3 / ctx.trace_info["steps"]
