"""The comparison that decides ``correct`` fails what it must: the
control (the reference in float8, below the configurations' bf16) stands
apart from the program, and each fault a cell can have, planted under a
whole run on the CPU at a small size, makes ``correct`` false with the
cells' own limits."""
import time

import pytest
import torch

from perfbench import control, run
from perfbench.harness import check, spec
from perfbench.tests import _smoke

SEEDS = [2 ** 31 + 5, 17]


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    return _smoke.tree(tmp_path_factory.mktemp("bench") / "perfbench")


def _run(small, cell, seed=SEEDS[0]):
    return run.execute(cell, seed, 0.5, 0, torch.device("cpu"),
                       bench_json=small / "BENCHMARK.json", root=small,
                       t_start=time.perf_counter())


@pytest.mark.parametrize("cell", ["hymba-train-2k", "phi3-serve-docs"])
def test_control_separates(small, cell):
    """The limits are set from the readings at the cells' own sizes on
    the card (PERF.md).  At this size the program stays within them, and
    on every seed the control reads three times the program's largest
    reading or more on some number, the half-batch fault ten times."""
    rows = control.readings(cell, SEEDS, set(SEEDS), 0.5,
                            torch.device("cpu"),
                            bench_json=small / "BENCHMARK.json", root=small,
                            emit=lambda d: None)
    limits = spec.load(cell, small / "BENCHMARK.json", small).cell["limits"]
    prog = [r for r in rows if r["side"] == "program"]
    assert len(prog) == len(SEEDS)
    for r in prog:
        assert check.verdict({k: {"value": r[k], "limit": v}
                              for k, v in limits.items()})
    lower = {k: max(r[k] for r in prog) for k in limits}
    for side, times in (("control", 3), ("half_batch", 10)):
        for r in (r for r in rows if r["side"] == side):
            assert any(r[k] >= times * max(lower[k], 1e-3) for k in limits)


def test_fault_train_state_unchanged(small, monkeypatch):
    import repro_torch.train.step as st
    monkeypatch.setattr(st, "adamw_update",
                        lambda grads, state, params, **kw: (params, state))
    assert _run(small, "hymba-train-2k")["correct"] is False


def test_fault_train_half_batch(small, monkeypatch):
    import repro_torch.train.step as st
    vg = st.value_and_grad

    def half(cfg, model, batch):
        return vg(cfg, model, {k: v[:v.shape[0] // 2]
                               for k, v in batch.items()})
    monkeypatch.setattr(st, "value_and_grad", half)
    assert _run(small, "hymba-train-2k")["correct"] is False


def test_fault_serve_token_altered(small, monkeypatch):
    from repro_torch.serve.engine import ServeEngine
    dec = ServeEngine._decode

    def altered(self, tokens, positions):
        return (dec(self, tokens, positions) + 1) % self.cfg.vocab
    monkeypatch.setattr(ServeEngine, "_decode", altered)
    assert _run(small, "phi3-serve-docs")["correct"] is False


def test_fault_serve_state_unchanged(small, monkeypatch):
    from repro_torch.serve.engine import ServeEngine
    dec = ServeEngine._decode

    def unchanged(self, tokens, positions):
        kept = {k: v.clone() for k, v in self.cache.items()}
        out = dec(self, tokens, positions)
        self.cache = kept
        return out
    monkeypatch.setattr(ServeEngine, "_decode", unchanged)
    assert _run(small, "phi3-serve-docs")["correct"] is False
