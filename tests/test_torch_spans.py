"""The port's spans inside the train step and the serve engine, on the
CPU at the smoke configs' size: the task tree a run leaves (parents,
nesting, an empty task stack between calls) and its mirror as
``torch.profiler`` ranges."""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_smoke_config
from repro_torch.core.tracers import ProfilerRangeTracer, profiler_ranges
from repro_torch.core.tracing import TracingDomain, current_task
from repro_torch.models import transformer as tfm
from repro_torch.optim import adamw_init
from repro_torch.serve.engine import ServeEngine
from repro_torch.train.step import TrainHParams, make_train_step


class _Log:
    """A tracer that keeps every start and end in order."""

    def __init__(self):
        self.events = []

    def on_start(self, t):
        self.events.append(("start", t))

    def on_end(self, t):
        self.events.append(("end", t))

    def on_tag(self, t, tag):
        pass


def _ranges(prof, prefix):
    return [e for e in prof.events() if e.name.startswith(prefix)]


# -- serving ----------------------------------------------------------------
@pytest.fixture(scope="module")
def stablelm():
    cfg = get_smoke_config("stablelm-1.6b")
    return cfg, tfm.init_model(cfg, 0, device="cpu", dtype=torch.float32)


def _serve(cfg, model, dom, lens=(5, 9, 7, 11, 6)):
    """Five requests through two slots, the task stack checked after every
    call; the third is submitted under a caller's task.  -> the requests,
    in order, and the caller's task."""
    eng = ServeEngine(cfg, model, max_batch=2, max_len=32, domain=dom)
    rng = np.random.default_rng(0)
    reqs, caller = [], None
    for i, n in enumerate(lens):
        if i == 2:
            with dom.task("client", "send", "test") as caller:
                eng.submit(rng.integers(0, cfg.vocab, n), max_new=3)
        else:
            eng.submit(rng.integers(0, cfg.vocab, n), max_new=3)
        reqs.append(eng.queue[-1])
        assert current_task() is None
        if i % 2:
            eng.step()
            assert current_task() is None
    while eng.queue or any(r is not None for r in eng.active):
        eng.step()
        assert current_task() is None
    assert all(r.done for r in reqs)
    return reqs, caller


def test_serve_task_tree(stablelm):
    cfg, model = stablelm
    dom = TracingDomain("serve")
    log = dom.attach(_Log())
    reqs, caller = _serve(cfg, model, dom)
    for r in reqs:
        assert r.task.end is not None and r.queued.end is not None
        assert r.queued.parent_id == r.task.id
        assert r.task.parent_id == (caller.id if r is reqs[2] else "")
    # each prefill belongs to the request whose queue task ended just
    # before it opened
    prefills = 0
    for (k0, q), (k1, p) in zip(log.events, log.events[1:]):
        if k1 == "start" and p.category == "prefill":
            prefills += 1
            assert k0 == "end" and q.category == "queue"
            assert p.parent_id == q.parent_id
    assert prefills == len(reqs)
    # prefill and decode open and close inside a step; decode is its child
    step, seen = None, {"prefill": 0, "decode": 0}
    for k, t in log.events:
        if t.category == "step":
            step = t if k == "start" else None
        elif t.category in seen:
            assert step is not None and step.start <= t.start
            seen[t.category] += k == "start"
            if t.category == "decode":
                assert t.parent_id == step.id
    assert seen["prefill"] == len(reqs) and seen["decode"] > 0
    assert {t.category for _, t in log.events} == {
        "request", "queue", "prefill", "decode", "step", "client", "layer"}
    # each model layer is a task under the prefill or decode that ran it
    outer = {t.id: t.category for _, t in log.events
             if t.category in ("prefill", "decode")}
    layers = [t for k, t in log.events if k == "start" and t.category == "layer"]
    assert len(layers) == cfg.n_layers * len(outer)
    assert all(outer.get(t.parent_id) for t in layers)


def test_serve_ranges_mirror_stack_tasks_only(stablelm):
    cfg, model = stablelm
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _serve(cfg, model, TracingDomain("serve"), lens=(5, 9, 7))
    names = {e.name for e in _ranges(prof, "serve.")}
    assert names == {"serve.step", "serve.prefill", "serve.decode",
                     "serve.client", "serve.layer"}
    for e in _ranges(prof, "serve.prefill") + _ranges(prof, "serve.decode"):
        assert e.cpu_parent is not None and e.cpu_parent.name == "serve.step"
        kids = [c.name for c in e.cpu_children]
        assert kids.count("serve.layer") == cfg.n_layers


# -- training ---------------------------------------------------------------
@pytest.fixture(scope="module")
def small_train():
    cfg = get_smoke_config("stablelm-1.6b")
    model = tfm.init_model(cfg, 0, device="cpu", dtype=torch.float32,
                           requires_grad=True)
    toks = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab, (2, 16)), dtype=torch.int32)
    return cfg, model, {"tokens": toks}


def test_train_step_tasks_nest_under_the_caller(small_train):
    cfg, model, batch = small_train
    dom = TracingDomain("train")
    log = dom.attach(_Log())
    step = make_train_step(cfg, TrainHParams(), domain=dom)
    opt = adamw_init(tfm.param_tree(model))
    with dom.task("train", "step", "loop") as outer:
        step(model, opt, batch)
    assert current_task() is None
    starts = [t for k, t in log.events if k == "start"]
    top = [t for t in starts if t.parent_id == outer.id]
    assert [t.category for t in top] == ["forward", "backward", "update"]
    fwd, _, upd = top
    ends = [t.category for k, t in log.events if k == "end"
            and t.parent_id in ("", outer.id)]
    assert ends == ["forward", "backward", "update", "train"]
    # under them: each model layer, and each parameter group's norm and
    # update (the embedding, the final norm, each layer)
    under = {}
    for t in starts:
        under.setdefault(t.parent_id, []).append(t.category)
    assert under[fwd.id] == ["layer"] * cfg.n_layers
    groups = 2 + cfg.n_layers
    assert under[upd.id] == ["update"] * (2 * groups)
    assert len(starts) == 1 + 3 + cfg.n_layers + 2 * groups
    # the step's domain gets one range tracer, however often it is asked
    make_train_step(cfg, TrainHParams(), domain=dom)
    assert sum(isinstance(tr, ProfilerRangeTracer)
               for tr, _ in dom._tracers) == 1


def test_train_step_ranges_under_the_profiler(small_train):
    cfg, model, batch = small_train
    step = make_train_step(cfg, TrainHParams())
    opt = adamw_init(tfm.param_tree(model))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(model, opt, batch)
    outer = sorted((e for e in _ranges(prof, "train.")
                    if e.cpu_parent is None),
                   key=lambda e: e.time_range.start)
    assert [e.name for e in outer] == ["train.forward", "train.backward",
                                       "train.update"]
    fwd, bwd, upd = outer
    assert any(c.name.startswith("aten::") for c in fwd.cpu_children)
    assert any("Backward" in c.name for c in bwd.cpu_children)
    # no range holds every op of its phase: the layers' ops sit in
    # ``train.layer`` ranges, the optimizer's in a range a parameter group
    kids = [c.name for c in fwd.cpu_children]
    assert kids.count("train.layer") == cfg.n_layers
    layer_ops = sum(len(c.cpu_children) for c in fwd.cpu_children
                    if c.name == "train.layer")
    assert len(kids) < layer_ops
    kids = [c.name for c in upd.cpu_children]
    assert kids.count("train.update") == 2 * (2 + cfg.n_layers)
    assert len(kids) <= 2 * (2 + cfg.n_layers) + 1      # and the sqrt


def test_range_tracer_idle_without_a_profiler(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.autograd.profiler, "record_function",
                        lambda name: calls.append(name))
    dom = TracingDomain("quiet")
    tr = profiler_ranges(dom)
    with dom.task("a", "b", "c"):
        with dom.task("d", "e", "f"):
            assert not tr._open
    assert calls == [] and current_task() is None
