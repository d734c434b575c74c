"""The serving flash roofline's reader on made-up traces: it counts the
work of every launch layout it knows, prefills alone or with decode on
the kernel, and leaves any other count unread with a line saying why."""
import importlib.util
import json
from pathlib import Path

import pytest

from perfbench.harness import counting

BENCH = Path(__file__).resolve().parents[1]
CFG = json.loads((BENCH / "configs" / "phi3-medium-14b.json").read_text())
HEADS = CFG["n_heads"], CFG["n_kv_heads"], CFG["head_dim"]
WINS = counting.layer_windows(CFG)
L = len(WINS)
LENS = [2500, 1024]
STEPS = [[2600, 1100, 3000], [], [2601, 1101]]
TOKS = [k for s in STEPS for k in s]


def _read():
    s = importlib.util.spec_from_file_location(
        "flash_serve", BENCH / "metrics" / "flash_roofline.serve.py")
    mod = importlib.util.module_from_spec(s)
    s.loader.exec_module(mod)
    return mod.read


class _Trace:
    def __init__(self, us):
        self.us = us

    def kernel_us(self, *patterns):
        return list(self.us)


class _Ctx:
    kind, config, count = "serve", CFG, counting

    def __init__(self, us):
        self.trace = _Trace(us)
        self.trace_info = {"prefill_lens": LENS, "decode_ctx": STEPS}
        self.logged = []

    def log(self, msg):
        self.logged.append(msg)


def _ms(call):
    return counting.bound(*call, "bfloat16")[0]


def _prefill_us():
    return [1e3 * _ms(counting.flash_call(1, S, *HEADS, w))
            for S in LENS for w in WINS]


def _decode_us():
    return [1e3 * _ms(counting.decode_attn(k, *HEADS, w))
            for k in TOKS for w in WINS]


@pytest.mark.parametrize("layout", ["prefill", "decode_per_step",
                                    "decode_per_slot"])
def test_counts_each_launch_layout(layout):
    """Launches that take exactly their bound read 100%."""
    us = _prefill_us()
    dec = sum(_decode_us())
    n_dec = {"prefill": 0, "decode_per_step": L * 2,
             "decode_per_slot": L * len(TOKS)}[layout]
    us += [dec / n_dec] * n_dec if n_dec else []
    ctx = _Ctx(us)
    assert _read()(ctx) == pytest.approx(100.0, rel=1e-9)
    assert not ctx.logged


def test_other_counts_are_said_and_unread():
    ctx = _Ctx(_prefill_us() + [1.0])
    assert _read()(ctx) is None
    assert len(ctx.logged) == 1 and "not read" in ctx.logged[0]


def test_no_launch_reads_nothing():
    ctx = _Ctx([])
    assert _read()(ctx) is None and not ctx.logged


def test_decode_attention_is_bound_by_bytes():
    for k in (1, 1024, 4096):
        for w in (0, 2047):
            assert counting.bound(*counting.decode_attn(k, *HEADS, w),
                                  "bfloat16")[1] == "bytes"
