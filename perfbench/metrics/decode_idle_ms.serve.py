"""Device idle ms a traced engine step inside the program's
``serve.decode`` ranges (each step's batched decode over the slots, its
tokens read back).  Cut as ``prefill_idle_ms.serve`` cuts its own."""

import importlib.util
from pathlib import Path

NAME = "serve.decode"


def _idle_us():
    path = Path(__file__).with_name("prefill_idle_ms.serve.py")
    s = importlib.util.spec_from_file_location(
        "perfbench_metric_prefill_idle_ms_serve", path)
    mod = importlib.util.module_from_spec(s)
    s.loader.exec_module(mod)
    return mod.idle_us


def read(ctx):
    if ctx.kind != "serve" or ctx.trace is None or not ctx.trace.device:
        return None
    us = _idle_us()(ctx.trace, NAME)
    return None if us is None else us / 1e3 / ctx.trace_info["steps"]
