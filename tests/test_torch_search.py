"""The port's closed-loop search (``repro_torch.dse.search``) against the
JAX package's, trial for trial: the cases of tests/dse/test_search.py,
each run by both packages on the same small memsys (3 cores x 6
requests, the 12-point grid, MAX_H 2000).

For every search the rows, best, front, simulated-cycle budget, rounds
and the ``SearchState`` JSON *as text* equal the JAX package's.  The
port also keeps the reference's invariants: the optimum for less budget,
resume from any round boundary (its own snapshots and the JAX
package's), a repeat search making no new block, ``tell`` without
``ask`` raising; and the dashboard's search panels read the same from
both packages' event streams."""
import json
import math

import numpy as np
import pytest

import repro.dse as J
import repro.obs.bus as jbus
import repro.obs.dashboard as jdash
import repro_torch.dse as T
import repro_torch.obs.bus as tbus
import repro_torch.obs.dashboard as tdash
import repro.sims.memsys as jm
import repro_torch.sims.memsys as tm
from _torch_sim_parity import (assert_same_search, assert_same_state,  # noqa
                               one_torch_thread, search_ctx)

MAX_H = 2000.0


@pytest.fixture(scope="module")
def ctx():
    return {"jax": search_ctx("jax"), "torch": search_ctx("torch")}


def _sh(c, **kw):
    args = dict(max_horizon=MAX_H, min_horizon=60.0, eta=3, seed=0)
    args.update(kw)
    return c.dse.SuccessiveHalving(c.pool, "est_finish", **args)


def _both(ctx, make, **run_kw):
    """The same search in both packages; asserts trial-for-trial equality
    and returns (jax result, port result)."""
    out = {}
    for pkg in ("jax", "torch"):
        c = ctx[pkg]
        out[pkg] = c.dse.run_search(c.bf, make(c), extract=c.extract,
                                    **run_kw)
    assert_same_search(out["torch"], out["jax"])
    return out["jax"], out["torch"]


@pytest.fixture(scope="module")
def plain(ctx):
    """The plain warm search in both packages, under each bus's capture
    (the dashboard test reads the events), then a repeat port search with
    its builds and blocks counted."""
    res, events = {}, {}
    for pkg, bus in (("jax", jbus), ("torch", tbus)):
        c = ctx[pkg]
        with bus.capture() as sink:
            res[pkg] = c.dse.run_search(c.bf, _sh(c), extract=c.extract)
        events[pkg] = list(sink.events)
    c = ctx["torch"]
    runner = T.runner_for(c.sim)
    builds0, traces0 = len(c.built), runner.trace_count
    again = T.run_search(c.bf, _sh(c), extract=c.extract)
    repeat = dict(builds=len(c.built) - builds0,
                  traces=runner.trace_count - traces0, result=again)
    return res, events, repeat


@pytest.fixture(scope="module")
def cold(ctx):
    """Replay promotion (warm=False) in both packages, with the state JSON
    snapshotted at every round boundary."""
    out = {}
    for pkg in ("jax", "torch"):
        c = ctx[pkg]
        snaps = []
        res = c.dse.run_search(
            c.bf, _sh(c, warm=False), extract=c.extract,
            callback=lambda d: snaps.append(d.state.to_json()))
        out[pkg] = (res, snaps)
    return out


# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kw", [
    dict(max_horizon=2000.0, rungs=1),
    dict(max_horizon=2700.0, min_horizon=100.0, eta=3),
    dict(max_horizon=2000.0, min_horizon=2000.0, eta=3),
    dict(max_horizon=800.0, rungs=3, eta=2),
    dict(max_horizon=5600.0, min_horizon=5600.0 / 81, eta=3)])
def test_horizon_ladder_equals_jax(kw):
    assert T.horizon_ladder(**kw) == J.horizon_ladder(**kw)


def test_successive_halving_equals_jax_and_finds_the_optimum(ctx, plain):
    res, _, _ = plain
    assert_same_search(res["torch"], res["jax"])
    c = ctx["torch"]
    r = res["torch"]
    rows = T.run_sweep(c.bf, c.pool, until=MAX_H, extract=c.extract)
    jc = ctx["jax"]
    assert rows == J.run_sweep(jc.bf, jc.pool, until=MAX_H,
                               extract=jc.extract)
    assert r.best["est_finish"] == min(x["est_finish"] for x in rows)
    assert r.best["until"] == MAX_H
    assert r.budget < sum(x["virtual_time"] for x in rows)
    assert len(r.rows) < 3 * len(c.pool)
    assert r.budget == pytest.approx(sum(t["cycles"] for t in r.rows))
    assert r.budget < sum(t["virtual_time"] for t in r.rows)
    per_round = {}
    for t in r.rows:
        per_round[t["round"]] = per_round.get(t["round"], 0) + 1
    sizes = [per_round[k] for k in sorted(per_round)]
    assert sizes[0] == len(c.pool) and sizes == sorted(sizes, reverse=True)
    assert sizes[1] == math.ceil(sizes[0] / 3)


def test_repeat_search_reuses_the_build_and_makes_no_new_block(plain):
    res, _, repeat = plain
    assert repeat["builds"] == 0
    assert repeat["traces"] == 0, f"{repeat['traces']} new blocks"
    assert_same_search(repeat["result"], res["torch"])


def test_bracketed_halving_equals_jax_with_mixed_horizons(ctx):
    drv = _sh(ctx["torch"], brackets=2)
    pts, us = drv.ask()
    assert len(pts) == len(ctx["torch"].pool) and len(set(us)) == 2
    assert set(us) == {drv.horizons[0], drv.horizons[1]}
    _, r = _both(ctx, lambda c: _sh(c, brackets=2))
    assert r.best["until"] == MAX_H
    assert r.front and r.front[0]["until"] == MAX_H


def test_multi_objective_halving_equals_jax(ctx):
    spec = {"est_finish": "min", "kind.l1.extra_hit_rate": "min"}
    _, r = _both(ctx, lambda c: c.dse.SuccessiveHalving(
        c.pool, c.dse.Objective(spec), max_horizon=MAX_H,
        min_horizon=60.0, eta=3, seed=0))
    assert r.front and T.Objective(spec).front(r.front) == r.front
    assert all(t["until"] == MAX_H for t in r.front)


def test_cycle_budget_stops_the_search_as_jax_does(ctx, plain):
    free = plain[0]["torch"]
    cap = free.budget * 0.4
    _, r = _both(ctx, lambda c: _sh(c, cycle_budget=cap))
    assert r.rounds < free.rounds
    assert r.budget >= cap and r.best is not None


def test_cold_promotion_equals_jax(cold):
    (jr, jsnaps), (tr, tsnaps) = cold["jax"], cold["torch"]
    assert_same_search(tr, jr)
    assert tsnaps == jsnaps


@pytest.mark.parametrize("k", [1, 2, 3])
def test_state_resumes_the_identical_trajectory(ctx, cold, k):
    """JSON-only resume from round boundary ``k`` of the port's own
    search and of the JAX package's: both finish on the full
    trajectory."""
    full, snaps = cold["torch"]
    jfull, jsnaps = cold["jax"]
    c = ctx["torch"]
    for snap in {snaps[k - 1], jsnaps[k - 1]}:
        state = T.SearchState.from_json(snap)
        assert state.round == k
        resumed = T.run_search(c.bf, _sh(c, warm=False, state=state),
                               extract=c.extract)
        assert resumed.rows == full.rows == jfull.rows
        assert resumed.best == full.best
        assert resumed.budget == full.budget
        assert resumed.rounds == full.rounds - k


def test_shape_axes_search_equals_jax():
    out, built = {}, {}
    for pkg, dse, mod, kw in (
            ("jax", J, "repro.sims.memsys", {}),
            ("torch", T, "repro_torch.sims.memsys", {"device": "cpu"})):
        memsys = __import__(mod, fromlist=["build_family"])
        built[pkg] = []

        def build_fn(shape=None, memsys=memsys, kw=kw, b=built[pkg]):
            b.append(dict(shape))
            return memsys.build_family(shape=shape, pattern="mixed",
                                       n_reqs=6, donate=True, **kw)

        bf = dse.memoize_build(build_fn)
        pool = dse.SweepSpec.grid({"shape.core": [1, 2, 4],
                                   "conn_latency[-1]": [10.0, 30.0]})
        out[pkg] = dse.run_search(bf, dse.SuccessiveHalving(
            pool, "virtual_time", max_horizon=MAX_H, min_horizon=200.0,
            eta=2, seed=0))
    assert_same_search(out["torch"], out["jax"])
    assert built["torch"] == [{"core": 4}]
    assert out["torch"].best["until"] == MAX_H


@pytest.mark.parametrize("acq", ["ts", "qei", "ucb", "random"])
def test_bo_and_random_search_on_memsys_equal_jax(ctx, acq):
    axes = {"conn_latency[-1]": (10.0, 40.0),
            "kind.l1.extra_hit_rate": (0.0, 0.8)}

    def make(c):
        kw = dict(horizon=MAX_H, batch=4, rounds=2, seed=1)
        if acq == "random":
            return c.dse.RandomSearch(axes, "est_finish", **kw)
        return c.dse.BatchBO(axes, "est_finish", pool=64, acquisition=acq,
                             **kw)

    _, r = _both(ctx, make)
    assert len(r.rows) == 8 and r.budget > 0


# a point of chip_smoke.py's first BO axes, whose DRAM period is fractional
STALL = {"conn_latency[-1]": 47.31177787380013,
         "kind.l1.extra_hit_rate": 0.4597823200935121,
         "period.dram": 3.041574596819093}


def test_a_fractional_dram_period_stalls_both_engines_alike():
    """Reference limit 2 (ROADMAP queue 3): at this point virtual time
    stops at 754.3104858398438 before epoch 500, the DRAM ticking every
    epoch without progress, so a run ends only at ``max_epochs``.  The
    port's engine copies it bit for bit."""
    jsim, jst = jm.build(n_cores=8, pattern="mixed", n_reqs=24,
                         donate=False)
    tsim, tst = tm.build(n_cores=8, pattern="mixed", n_reqs=24,
                         donate=False, device="cpu")
    jp = J.apply_point(jsim.default_params(), STALL)
    tp = T.apply_point(tsim.default_params(), STALL)
    for me in (500, 600):
        mine = tsim.run(tsim.copy_state(tst), 5600.0, max_epochs=me,
                        params=tp)
        assert_same_state(mine, jsim.run(jsim.copy_state(jst), 5600.0,
                                         max_epochs=me, params=jp))
        assert float(mine.time) == 754.3104858398438
        assert int(mine.stats.epochs) == me
        assert int(mine.comp_state["core"]["remaining"].sum()) == 82


# ---------------------------------------------------------------------------
# Objective, budget accounting and the drivers' host-side contract
# ---------------------------------------------------------------------------
ROWS = [{"t": 2.0, "q": 1.0}, {"t": 5.0, "q": 9.0}, {"t": 1.0, "q": 1.0},
        {"t": 9.0, "q": 0.5}]
FAILED = [{"a": 2.0, "b": 2.0}, {"a": 1.0, "b": 1.0},
          {"a": float("nan"), "b": 3.0}, {"a": 0.5}]


@pytest.mark.parametrize("spec, weights, rows", [
    ({"t": "min", "q": "max"}, {"q": 2.0}, ROWS),
    ("t", None, ROWS),
    ({"t": "min", "q": "max"}, None, ROWS[:3]),
    ({"a": "min", "b": "min"}, None, FAILED)])
def test_objective_scalar_order_front_equal_jax(spec, weights, rows):
    mine, ref = T.Objective(spec, weights), J.Objective(spec, weights)
    assert [mine.scalar(r) for r in rows] == [ref.scalar(r) for r in rows]
    assert mine.order(rows) == ref.order(rows)

    def front(obj):
        try:
            return obj.front(rows)
        except KeyError as e:          # a row lacks an objective column
            return ("KeyError", str(e))
    assert front(mine) == front(ref)
    if spec == {"a": "min", "b": "min"}:        # failed trials rank last
        assert mine.order(rows)[:2] == [1, 0]


AXES_SYN = {"x": (0.0, 1.0), "y": (0.0, 1.0)}


def _quad(p):
    return (p["x"] - 0.31) ** 2 + (p["y"] - 0.68) ** 2


def _drive(driver, fn):
    while True:
        asked = driver.ask()
        if asked is None:
            return driver
        pts, us = asked
        driver.tell([{**p, "f": fn(p), "virtual_time": u}
                     for p, u in zip(pts, us)])


def test_trial_cycles_nan_falls_back_to_the_horizon_as_jax():
    states = []
    for dse in (J, T):
        drv = dse.RandomSearch(AXES_SYN, "f", horizon=50.0, batch=2,
                               rounds=2, seed=0, cycle_budget=150.0)
        pts, _ = drv.ask()
        drv.tell([{**p, "f": 1.0, "virtual_time": float("nan")}
                  for p in pts])
        assert drv.state.budget == pytest.approx(100.0)
        pts, _ = drv.ask()
        drv.tell([{**p, "f": 1.0, "virtual_time": 40.0} for p in pts])
        assert drv.state.budget == pytest.approx(180.0) and drv.done
        states.append(drv.state.to_json())
    assert states[0] == states[1]


@pytest.mark.parametrize("acq", ["ts", "ucb", "qei"])
def test_batch_bo_on_a_small_choice_space_equals_jax(acq):
    """Distinct points in every batch, never re-proposed, the whole
    12-point space covered; the port proposes the JAX package's points in
    the JAX package's order."""
    axes = {"a": [1, 2, 3, 4], "b": [1, 2, 3]}
    proposed = {}
    for name, dse in (("jax", J), ("torch", T)):
        bo = dse.BatchBO(axes, "f", horizon=1.0, batch=5, rounds=5, pool=64,
                         seed=0, acquisition=acq)
        keys = []
        while True:
            asked = bo.ask()
            if asked is None:
                break
            pts, _ = asked
            batch = [(p["a"], p["b"]) for p in pts]
            assert len(set(batch)) == len(batch)
            keys += batch
            bo.tell([{**p, "f": float(p["a"] + p["b"]),
                      "virtual_time": 1.0} for p in pts])
        proposed[name] = (keys, bo.state.to_json())
    assert proposed["torch"] == proposed["jax"]
    assert len(set(proposed["torch"][0])) == 12


@pytest.mark.parametrize("acq, axes, fn, seed", [
    ("ts", AXES_SYN, _quad, 3),
    ("qei", AXES_SYN, _quad, 3),
    ("ucb", {"x": (0.1, 10.0, "log"), "k": [1, 2, 4, 8], "y": (0.0, 1.0)},
     lambda p: (math.log10(p["x"]) - 0.5) ** 2 + (p["k"] - 4) ** 2 / 16.0
     + (p["y"] - 0.5) ** 2, 7)])
def test_batch_bo_converges_as_jax(acq, axes, fn, seed):
    mine, ref = (_drive(dse.BatchBO(axes, "f", horizon=1.0, batch=6,
                                    rounds=5, pool=96, seed=seed,
                                    acquisition=acq), fn)
                 for dse in (T, J))
    assert mine.state.to_json() == ref.state.to_json()
    assert mine.best() == ref.best()
    assert mine.best()["f"] < 0.15
    if "k" in axes:
        assert type(mine.best()["k"]) is int


def test_batch_bo_beats_random_and_resumes():
    bo = _drive(T.BatchBO(AXES_SYN, "f", horizon=1.0, batch=8, rounds=6,
                          pool=128, seed=3), _quad)
    rs = _drive(T.RandomSearch(AXES_SYN, "f", horizon=1.0, batch=8,
                               rounds=6, seed=3), _quad)
    assert len(bo.state.history) == len(rs.state.history) == 48
    assert bo.best()["f"] < 0.02 and bo.best()["f"] < rs.best()["f"]
    seen = [(t["x"], t["y"]) for t in bo.state.history]
    assert len(seen) == len(set(seen))           # never re-proposed
    part = T.BatchBO(AXES_SYN, "f", horizon=1.0, batch=8, rounds=6,
                     pool=128, seed=3)
    for _ in range(2):
        pts, us = part.ask()
        part.tell([{**p, "f": _quad(p), "virtual_time": u}
                   for p, u in zip(pts, us)])
    state = T.SearchState.from_json(part.state.to_json())
    resumed = _drive(T.BatchBO(AXES_SYN, "f", horizon=1.0, batch=8,
                               rounds=6, pool=128, seed=3, state=state),
                     _quad)
    assert resumed.state.history == bo.state.history


def test_random_search_determinism_and_budget_cap_equal_jax():
    runs = {}
    for name, dse in (("jax", J), ("torch", T)):
        r = _drive(dse.RandomSearch(AXES_SYN, "f", horizon=100.0, batch=8,
                                    rounds=4, seed=2), _quad)
        capped = _drive(dse.RandomSearch(AXES_SYN, "f", horizon=100.0,
                                         batch=8, rounds=4, seed=2,
                                         cycle_budget=1500.0), _quad)
        assert r.state.budget == pytest.approx(3200.0)
        assert capped.state.round == 2
        assert capped.state.history == r.state.history[:16]
        runs[name] = (r.state.to_json(), capped.state.to_json())
    assert runs["torch"] == runs["jax"]


def test_search_state_json_roundtrip_equals_jax():
    kw = dict(round=3, budget=123.5,
              history=[{"a": 1.0, "until": 10.0, "round": 0}],
              driver={"brackets": [{"rung": 1, "alive": [{"a": 1}]}]},
              rng=np.random.default_rng(9).bit_generator.state)
    s = T.SearchState(**kw)
    assert s.to_json() == J.SearchState(**kw).to_json()
    back = T.SearchState.from_json(s.to_json())
    assert back == s and json.loads(s.to_json())["budget"] == 123.5
    g = np.random.default_rng(0)
    g.bit_generator.state = back.rng
    assert g.integers(0, 1 << 30) == \
        np.random.default_rng(9).integers(0, 1 << 30)


def test_tell_without_ask_raises():
    drv = T.RandomSearch(AXES_SYN, "f", horizon=1.0, batch=2, rounds=1)
    with pytest.raises(AssertionError, match="pending ask"):
        drv.tell([])


# ---------------------------------------------------------------------------
def _panels(events, stats_cls):
    """The dashboard's search panels after ``events``, clocks aside."""
    stats = stats_cls()
    for ev in events:
        stats.on_event(ev)
    snap = stats.snapshot()
    cycles = {k: v for k, v in snap["cycles"].items() if k != "per_sec"}
    return dict(search=snap["search"], promotions=snap["promotions"],
                cycles=cycles, sweeps=snap["sweeps"])


def test_dashboard_search_panels_equal_jax(plain):
    _, events, _ = plain
    kinds = {e["kind"] for e in events["torch"]}
    assert {"search.start", "search.ask", "trial", "search.tell",
            "rung.promote", "search.end"} <= kinds
    mine = _panels(events["torch"], tdash.CampaignStats)
    assert mine == _panels(events["jax"], jdash.CampaignStats)
    assert mine["search"]["done"] and mine["search"]["trials"] == 19
    assert len(mine["promotions"]) == 4
    for kind in ("search.ask", "trial", "search.tell", "rung.promote"):
        drop = ("ts", "seq", "dur")
        assert [{k: v for k, v in e.items() if k not in drop}
                for e in events["torch"] if e["kind"] == kind] == \
            [{k: v for k, v in e.items() if k not in drop}
             for e in events["jax"] if e["kind"] == kind]
