"""Device ms a traced training step of the kernels, copies and sets
launched inside the program's ``train.update`` ranges: the global-norm
clip, AdamW and the copy of the new parameters into the model.  Counted
as ``backward_ms.train`` counts its own range."""

import importlib.util
from pathlib import Path

NAME = "train.update"


def _range_us():
    path = Path(__file__).with_name("backward_ms.train.py")
    s = importlib.util.spec_from_file_location(
        "perfbench_metric_backward_ms_train", path)
    mod = importlib.util.module_from_spec(s)
    s.loader.exec_module(mod)
    return mod.range_us


def read(ctx):
    if ctx.kind != "train" or ctx.trace is None or not ctx.trace.device:
        return None
    us = _range_us()(ctx.trace, NAME)
    return None if us is None else us / 1e3 / ctx.trace_info["steps"]
