"""The readers of the program's spans on made-up traces: profiler events
built by hand and reduced by the harness's own ``Trace``, and made-up
engine spans."""
from types import SimpleNamespace

import numpy as np
import pytest
from torch.autograd import DeviceType

from perfbench.harness import spec
from perfbench.harness.trace import Trace

TRAIN = ("forward_ms.train", "backward_ms.train", "update_ms.train")
SERVE_TRACE = ("prefill_idle_ms.serve", "decode_idle_ms.serve")


class _Ev:
    """What ``Trace`` and the readers use of a profiler event."""

    def __init__(self, name, start, end, thread=1, device=False, kernels=(),
                 annotation=False, children=()):
        self.name = name
        self.time_range = SimpleNamespace(start=start, end=end)
        self.thread = thread
        self.device_type = DeviceType.CUDA if device else DeviceType.CPU
        self.kernels = [SimpleNamespace(duration=d) for d in kernels]
        self.is_user_annotation = annotation
        self.cpu_parent = None
        self.cpu_children = list(children)
        for c in children:
            c.cpu_parent = self


def _flat(events):
    out = []
    for e in events:
        out += [e] + _flat(e.cpu_children)
    return out


def _dev(start, end, name="k", annotation=False):
    return _Ev(name, start, end, device=True, annotation=annotation)


class _Ctx:
    def __init__(self, kind, trace=None, steps=1, spans=()):
        self.kind, self.trace = kind, trace
        self.trace_info = {"steps": steps}
        self.window = {"spans": list(spans)}
        self.logged = []

    def log(self, msg):
        self.logged.append(msg)


def _read(name, ctx):
    return spec.reader(name)(ctx)


# -- training ---------------------------------------------------------------
def _train_trace(steps=1):
    """One step: the forward and the update launch from the main thread
    (1); the backward's range waits there while autograd's device thread
    (2) launches its kernels.  The forward range also carries its device
    mirror, linked as if it were a kernel of its own."""
    host = [
        _Ev("train.forward", 0, 100, annotation=True, kernels=[30],
            children=[_Ev("aten::mm", 10, 40, kernels=[30])]),
        _Ev("train.backward", 100, 300, annotation=True,
            children=[_Ev("aten::ones_like", 105, 110, kernels=[5])]),
        _Ev("autograd::engine::evaluate_function: MmBackward0", 120, 200,
            thread=2, children=[_Ev("aten::mm", 130, 190, thread=2,
                                    kernels=[60])]),
        _Ev("train.update", 300, 400, annotation=True,
            children=[_Ev("aten::_foreach_add_", 305, 330, kernels=[40])]),
        _Ev("aten::item", 400, 420),
    ]
    dev = [_dev(20, 50), _dev(110, 115), _dev(140, 200), _dev(310, 350),
           _dev(20, 50, "train.forward", annotation=True)]
    return Trace(_flat(host) + dev, 420e-6)


def test_backward_on_another_thread_counts_in_backward_alone():
    tr = _train_trace()
    got = {n: _read(n, _Ctx("train", tr)) for n in TRAIN}
    assert got == pytest.approx({"forward_ms.train": 0.030,
                                 "backward_ms.train": 0.065,
                                 "update_ms.train": 0.040})
    # every device event is counted once, the range's mirror never
    assert sum(got.values()) * 1e3 == pytest.approx(tr.busy_us)


def test_train_readers_count_a_step():
    tr = _train_trace()
    for n in TRAIN:
        assert _read(n, _Ctx("train", tr, steps=2)) == pytest.approx(
            _read(n, _Ctx("train", tr)) / 2)


# -- serving ----------------------------------------------------------------
def _serve_trace(prefill, decode=(50, 100)):
    """Device busy 0-10, 30-40, 60-100: gaps 10-30 and 40-60."""
    step = _Ev("serve.step", 0, 100, annotation=True, children=[
        _Ev("serve.prefill", *prefill, annotation=True),
        _Ev("serve.decode", *decode, annotation=True)])
    return Trace(_flat([step]) + [_dev(0, 10), _dev(30, 40), _dev(60, 100)],
                 100e-6)


@pytest.mark.parametrize("prefill,idle_us", [
    ((20, 50), 20.0),     # across busy time, into both gaps
    ((10, 30), 20.0),     # exactly one gap
    ((0, 10), 0.0),       # exactly busy time
    ((35, 45), 5.0),      # busy, then a gap's start
    ((45, 55), 10.0),     # inside a gap
    ((0, 100), 40.0),     # everything
])
def test_idle_is_cut_at_the_range_edges(prefill, idle_us):
    tr = _serve_trace(prefill)
    assert _read("prefill_idle_ms.serve", _Ctx("serve", tr)) == \
        pytest.approx(idle_us / 1e3)
    assert _read("decode_idle_ms.serve", _Ctx("serve", tr, steps=2)) == \
        pytest.approx(10.0 / 1e3 / 2)


def test_queue_wait_leaves_out_spans_across_the_window_edges():
    steps = [("step", 10.0 + i, 11.0 + i) for i in range(10)]
    inside = [("queue", 10.5 + i, 10.6 + 0.1 * i + i) for i in range(9)]
    across = [("queue", 9.0, 10.5), ("queue", 19.5, 21.0)]
    other = [("prefill", 11.0, 12.0), ("request", 10.5, 15.0)]
    ctx = _Ctx("serve", spans=steps + inside + across + other)
    want = np.percentile([(e - s) * 1e3 for _, s, e in inside], 95)
    assert _read("queue_wait_ms_p95.serve", ctx) == pytest.approx(want)


# -- nothing to read --------------------------------------------------------
@pytest.mark.parametrize("name", TRAIN + SERVE_TRACE)
def test_trace_readers_none_without_device_events(name):
    kind = name.rsplit(".", 1)[1]
    host = [_Ev(f"{kind}.{n}", 0, 10, annotation=True)
            for n in ("forward", "backward", "update", "prefill", "decode")]
    assert _read(name, _Ctx(kind, Trace(host, 1e-5))) is None
    assert _read(name, _Ctx(kind, None)) is None


@pytest.mark.parametrize("name", TRAIN + SERVE_TRACE)
def test_trace_readers_none_without_their_range(name):
    kind = name.rsplit(".", 1)[1]
    tr = Trace([_Ev("aten::mm", 0, 10, kernels=[5]), _dev(2, 7)], 1e-5)
    assert _read(name, _Ctx(kind, tr)) is None
    other = "serve" if kind == "train" else "train"
    full = _train_trace() if kind == "train" else _serve_trace((20, 50))
    assert _read(name, _Ctx(other, full)) is None


def test_queue_wait_none_without_its_spans():
    steps = [("step", 10.0, 11.0)]
    for spans in ([], steps, [("queue", 10.2, 10.4)],
                  steps + [("queue", 9.0, 10.5)]):
        assert _read("queue_wait_ms_p95.serve",
                     _Ctx("serve", spans=spans)) is None
    assert _read("queue_wait_ms_p95.serve", _Ctx(
        "train", spans=steps + [("queue", 10.2, 10.4)])) is None
