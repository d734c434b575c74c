"""The port's memsys simulator against the JAX package's, by the
procedure of benchmarks/smart_ticking.py at 4 cores and 12 requests: Smart
Ticking to completion, then Smart Ticking and the naive engine to the
horizon ceil(virtual time) + 2.  All five patterns; every run's whole
final state equals the JAX run's, bits and dtypes; stat_err is 0.  Also
checks ``chip_smoke.MEMSYS_REF``'s idle_half Smart-Ticking entry against
the JAX package at 16 cores and 96 requests."""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

import repro.sims.memsys as jm
import repro_torch.sims.memsys as tm
from _torch_sim_parity import as_np, assert_same_state

PATTERNS = ["compute", "stream", "pointer", "idle_half", "mixed"]
ROOT = Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("pattern", PATTERNS)
def test_memsys_smart_and_naive_match_jax(pattern):
    kw = dict(n_cores=4, pattern=pattern, n_reqs=12)
    out, until = {}, 100000.0
    for naive in (False, True):
        tsim, tst = tm.build(naive=naive, device="cpu", **kw)
        jsim, jst = jm.build(naive=naive, **kw)
        port = tsim.run(tst, until=until)
        assert_same_state(port, jsim.run(jst, until=until))
        out[naive] = tm.finish_stats(tsim, port)
        if not naive:
            # the naive engine runs to the Smart-Ticking run's horizon
            horizon = float(np.ceil(out[naive]["virtual_time"])) + 2
            until = horizon
    smart, naive = out[False], out[True]
    assert smart["remaining"] == 0 and smart["outstanding"] == 0
    assert smart["reads_done"] == (2 if pattern == "idle_half" else 4) * 12
    for k in ("reads_done", "hits", "misses", "delivered"):
        assert smart[k] == naive[k], k                  # stat_err == 0
    assert smart["epochs"] < naive["epochs"] == horizon + 1


def test_memsys_dtypes_and_initial_state_match_jax():
    for pattern in PATTERNS:
        tsim, tst = tm.build(n_cores=5, pattern=pattern, n_reqs=7, seed=3,
                             device="cpu")
        jsim, jst = jm.build(n_cores=5, pattern=pattern, n_reqs=7, seed=3)
        assert_same_state(tst, jst)
        assert_same_state(tsim.default_params(), jsim.default_params())


def test_memsys_ref_idle_half_smart_matches_jax():
    ref = _chip_smoke().MEMSYS_REF["idle_half"]
    sim, st = jm.build(n_cores=16, pattern="idle_half", n_reqs=96)
    out = sim.run(st, until=ref["horizon"])
    got = {**jm.finish_stats(sim, out),
           "progress_ticks": int(out.stats.progress_ticks),
           "busy": np.asarray(out.stats.busy).tolist()}
    assert got == ref["smart"]
    assert got["epochs"] == 1737


def test_memsys_entry_points_default_to_cuda(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tm.build(n_cores=2, n_reqs=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tm.build_family(n_cores=2, n_reqs=2)
    sim, st = tm.build(n_cores=2, n_reqs=2, device="cpu")
    assert sim.device.type == "cpu" and st.time.device.type == "cpu"
    assert as_np(st.comp_state["core"]["tag"]).tolist() == [0, 1]
