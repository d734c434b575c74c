"""The flash backward roofline's reader on made-up traces: it counts
hymba's 29 windowed and 3 global layers at both training shapes to its
frozen rule, leaves a launch count that is not whole passes over the
layers unread with a line saying why, and reads only ``fa_tc_bwd``
kernels, as the forward's reader reads only the forward's."""
import importlib.util
import json
from pathlib import Path

import pytest

from perfbench.harness import counting
from perfbench.harness.trace import Trace

BENCH = Path(__file__).resolve().parents[1]
CFG = json.loads((BENCH / "configs" / "hymba-1.5b.json").read_text())
MIXES = {name: json.loads((BENCH / "traffic" / f"{name}.json").read_text())
         for name in ("train-4x2048", "train-1x8192")}
BWD = "void (anonymous namespace)::fa_tc_bwd<64, false>(BwdParams)"
BWD_PRE = "(anonymous namespace)::fa_tc_bwd_pre(bf16 const*, ...)"
FWD = "void (anonymous namespace)::fa_tc_fwd_lse<64, false>(FaParams, float*)"
FWD32 = "void (anonymous namespace)::fa_fwd<64, true>(FaParams)"


def _reader(name):
    s = importlib.util.spec_from_file_location(
        name.replace(".", "_"), BENCH / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(s)
    s.loader.exec_module(mod)
    return mod.read


class _Trace:
    """The benchmark's own ``kernel_us`` over made-up device events."""

    def __init__(self, events):
        self.device = []
        t = 0.0
        for us, name in events:
            self.device.append((t, t + us, name))
            t += us + 1.0

    kernel_us = Trace.kernel_us


class _Ctx:
    kind, config, count = "train", CFG, counting

    def __init__(self, mix, events, steps=2):
        self.mix = MIXES[mix]
        self.trace = _Trace(events)
        self.trace_info = {"steps": steps}
        self.logged = []

    def log(self, msg):
        self.logged.append(msg)


def _bound_ms(B, S, H, KV, hd, w):
    """The rule, written out once more: 10 operations a kept pair, head
    dim and query head at 989 TFLOP/s, or q, out, dout, dq, k, v, dk, dv
    at 2 bytes and the log-sum-exp at 4, at 3.35 TB/s."""
    pairs = sum(min(q + 1, w) if w else q + 1 for q in range(S))
    ops = 10 * B * H * hd * pairs
    nbytes = 2 * (4 * B * S * H * hd + 4 * B * S * KV * hd) + 4 * B * H * S
    return max(ops / 989e12, nbytes / 3.35e12) * 1e3


def _step_ms(mix):
    m = MIXES[mix]
    wins = counting.layer_windows(CFG)
    assert sum(1 for w in wins if w == 0) == 3 and len(wins) == 32
    return sum(_bound_ms(m["batch"], m["seq"], CFG["n_heads"],
                         CFG["n_kv_heads"], CFG["head_dim"], w) for w in wins)


@pytest.mark.parametrize("mix", sorted(MIXES))
@pytest.mark.parametrize("per_layer", [1, 3])
def test_counts_hymba_layers_to_the_rule(mix, per_layer):
    """Launches that take exactly the bound of two steps read 100%,
    whether a layer's backward is one launch or three (a pre-pass, the
    kernel, a post-pass)."""
    steps, L = 2, CFG["n_layers"]
    n = steps * L * per_layer
    each = 1e3 * steps * _step_ms(mix) / n
    ctx = _Ctx(mix, [(each, BWD)] * n, steps)
    assert _reader("flash_bwd_roofline.train")(ctx) == \
        pytest.approx(100.0, rel=1e-9)
    assert not ctx.logged


def test_the_bound_is_the_tensor_cores_at_hymba_shapes():
    """At both shapes the operations bound every layer, windowed or
    global, so the step's bound is ops over the bf16 peak."""
    for mix, m in MIXES.items():
        for w in (0, 1024):
            nb, ops = _reader_module().backward_call(
                m["batch"], m["seq"], 25, 5, 64, w, counting.attn_pairs)
            assert counting.bound(nb, ops, "bfloat16")[1] == "operations"
    assert _step_ms("train-4x2048") == pytest.approx(3.4, abs=0.1)
    assert _step_ms("train-1x8192") == pytest.approx(5.3, abs=0.1)


def _reader_module():
    s = importlib.util.spec_from_file_location(
        "flash_bwd_roofline_train_mod",
        BENCH / "metrics" / "flash_bwd_roofline.train.py")
    mod = importlib.util.module_from_spec(s)
    s.loader.exec_module(mod)
    return mod


def test_other_counts_are_said_and_unread():
    L = CFG["n_layers"]
    for n in (2 * L + 1, L, 3 * L):       # 2 steps traced
        ctx = _Ctx("train-4x2048", [(10.0, BWD)] * n, steps=2)
        assert _reader("flash_bwd_roofline.train")(ctx) is None
        assert len(ctx.logged) == 1 and "not whole passes" in ctx.logged[0]


def test_no_launch_reads_nothing():
    """The parent, which has no backward kernel, leaves it out quietly."""
    ctx = _Ctx("train-4x2048", [(10.0, FWD)] * 64)
    assert _reader("flash_bwd_roofline.train")(ctx) is None
    assert not ctx.logged


def test_forward_and_backward_readers_keep_to_their_kernels():
    """The forward reader counts fa_tc_fwd (with or without the saved
    log-sum-exp) and fa_fwd and ignores fa_tc_bwd; the backward reader
    the reverse: the same reading with the other's launches added."""
    L, steps = CFG["n_layers"], 2
    fwd = [(50.0, FWD)] * (2 * L * steps)
    bwd = [(200.0, BWD), (5.0, BWD_PRE)] * (L * steps)
    fwd_read = _reader("flash_roofline.train")
    bwd_read = _reader("flash_bwd_roofline.train")
    assert fwd_read(_Ctx("train-4x2048", fwd + bwd)) == \
        fwd_read(_Ctx("train-4x2048", fwd))
    assert bwd_read(_Ctx("train-4x2048", bwd + fwd)) == \
        bwd_read(_Ctx("train-4x2048", bwd))
    f32 = [(50.0, FWD32)] * (2 * L * steps)
    assert bwd_read(_Ctx("train-4x2048", bwd + f32)) == \
        bwd_read(_Ctx("train-4x2048", bwd))
