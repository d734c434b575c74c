"""Warm-state resume in the port (tests/dse/test_warm_resume.py's cases),
and rung checkpoints across the two packages.

* a lane resumed from its frozen state equals a cold run at the longer
  horizon, row and whole final state, on all five memsys patterns and on
  a masked family lane; a partial resume mixes warm and cold lanes; a
  length mismatch raises; the resumed path makes no new block;
* a warm ``SuccessiveHalving`` search equals the cold one's rows for
  less budget, and equals the JAX package's warm search trial for trial;
* ``save_search`` / ``load_search`` at every round boundary resume the
  identical search, and a checkpoint written by either package resumes
  in the other on the writer's full trajectory;
* the checkpoint numbers a state's leaves in ``jax.tree.leaves``' order
  whatever order a build inserted its dict keys in;
* per-bracket budget caps stop only the exhausted bracket, as in JAX."""
import dataclasses
import os

import jax
import numpy as np
import pytest

import repro.dse as J
import repro.sims.memsys as jm
import repro_torch.dse as T
import repro_torch.sims.memsys as tm
from _torch_sim_parity import (as_np, assert_same_search,  # noqa
                               assert_same_state, one_torch_thread)
from repro_torch.core.engine import tree_leaves
from repro_torch.dse.search import ref_leaves, ref_unflatten

PATTERNS = ["compute", "stream", "pointer", "idle_half", "mixed"]
PTS = [{"conn_latency[-1]": float(v)} for v in (10, 25, 40)]
U1, U2 = 250.0, 1000.0


def _bits(x):
    return np.ascontiguousarray(as_np(x)).reshape(-1).view(np.uint8)


def _same_tree(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert np.array_equal(_bits(x), _bits(y))


def _warm_and_cold(bf, spec, handles_of=None):
    _, mid = T.run_sweep(bf, spec, until=U1, return_states=True)
    handles = [mid.handle(i, U1) for i in range(len(spec))]
    if handles_of is not None:
        handles = handles_of(handles)
    warm, ws = T.run_sweep(bf, spec, until=U2, resume=handles,
                           return_states=True)
    cold, cs = T.run_sweep(bf, spec, until=U2, return_states=True)
    return (warm, ws), (cold, cs)


# ---------------------------------------------------------------------------
@pytest.mark.parametrize("pattern", PATTERNS)
def test_resumed_rows_bit_identical_all_patterns(pattern):
    bf = T.memoize_build(lambda: tm.build(n_cores=3, pattern=pattern,
                                          n_reqs=6, device="cpu"))
    spec = T.SweepSpec.explicit(PTS)
    (warm, ws), (cold, cs) = _warm_and_cold(bf, spec)
    assert warm == cold
    for i in range(len(PTS)):
        _same_tree(ws.state(i), cs.state(i))


def test_family_masked_lane_warm_resume_bit_identical():
    bf = T.memoize_build(lambda shape=None: tm.build_family(
        shape=shape, pattern="mixed", n_reqs=6, device="cpu"))
    spec = T.SweepSpec.explicit(
        [{"shape.core": c, "conn_latency[-1]": u}
         for c, u in ((1, 10.0), (2, 25.0), (3, 40.0), (2, 40.0))])
    (warm, ws), (cold, cs) = _warm_and_cold(bf, spec)
    assert warm == cold
    for i in range(len(spec)):
        _same_tree(ws.state(i), cs.state(i))


def test_partial_resume_mixes_warm_and_cold_lanes_and_makes_no_block():
    bf = T.memoize_build(lambda: tm.build(n_cores=3, pattern="mixed",
                                          n_reqs=6, device="cpu"))
    sim, _ = bf()
    spec = T.SweepSpec.explicit(PTS)
    T.run_sweep(bf, spec, until=U2)               # the blocks exist
    t0 = T.runner_for(sim).trace_count
    (warm, _), (cold, _) = _warm_and_cold(
        bf, spec, lambda h: [h[0], None, h[2]])
    assert warm == cold
    assert T.runner_for(sim).trace_count == t0
    jbf = J.memoize_build(lambda: jm.build(n_cores=3, pattern="mixed",
                                           n_reqs=6, donate=True))
    assert cold == J.run_sweep(jbf, J.SweepSpec.explicit(PTS), until=U2)


def test_resume_handle_length_mismatch_raises():
    bf = T.memoize_build(lambda: tm.build(n_cores=2, pattern="mixed",
                                          n_reqs=4, device="cpu"))
    spec = T.SweepSpec.explicit([{"conn_latency[-1]": 10.0}] * 2)
    with pytest.raises(ValueError, match="one handle"):
        T.run_sweep(bf, spec, until=100.0, resume=[None])


# ---------------------------------------------------------------------------
# search level
# ---------------------------------------------------------------------------
POOL = [{"conn_latency[-1]": float(v)} for v in range(6, 42, 4)]
LADDER = dict(max_horizon=2000.0, min_horizon=2000.0 / 9, eta=3, seed=0)


def _bf(dse=T):
    if dse is J:
        return J.memoize_build(lambda: jm.build(n_cores=3, pattern="mixed",
                                                n_reqs=8, donate=True))
    return T.memoize_build(lambda: tm.build(n_cores=3, pattern="mixed",
                                            n_reqs=8, device="cpu"))


@pytest.fixture(scope="module")
def searches(tmp_path_factory):
    """Each package's warm search with a rung checkpoint after every
    round, and the port's cold search."""
    root = tmp_path_factory.mktemp("rungs")
    out = {}
    for name, dse in (("jax", J), ("torch", T)):
        bf = _bf(dse)
        snaps = []

        def cb(drv, name=name, dse=dse, snaps=snaps):
            snaps.append(dse.save_search(
                str(root / f"{name}{drv.state.round}"), drv))

        res = dse.run_search(bf, dse.SuccessiveHalving(
            POOL, "virtual_time", **LADDER), callback=cb)
        out[name] = dict(bf=bf, res=res, snaps=snaps, root=root)
    out["cold"] = T.run_search(out["torch"]["bf"], T.SuccessiveHalving(
        POOL, "virtual_time", warm=False, **LADDER))
    return out


def test_warm_search_equals_jax_and_cold_rows_for_less_budget(searches):
    warm, cold = searches["torch"]["res"], searches["cold"]
    assert_same_search(warm, searches["jax"]["res"])
    strip = lambda rows: [{k: v for k, v in r.items() if k != "cycles"}
                          for r in rows]
    assert strip(warm.rows) == strip(cold.rows)
    assert warm.best == {**cold.best, "cycles": warm.best["cycles"]}
    assert warm.budget < cold.budget
    assert cold.budget == pytest.approx(
        sum(t["virtual_time"] for t in cold.rows))
    assert warm.budget == pytest.approx(sum(t["cycles"] for t in warm.rows))


def _resume(pkg, path, template, bf):
    dse = J if pkg == "jax" else T
    state, handles = dse.load_search(path, template)
    drv = dse.SuccessiveHalving(POOL, "virtual_time", **LADDER, state=state)
    drv.adopt_handles(handles)
    assert all(isinstance(h, dse.ResumeHandle) for h in handles.values())
    return dse.run_search(bf, drv)


def test_ckpt_resume_at_every_round_boundary_bit_identical(searches):
    s = searches["torch"]
    full = s["res"]
    _, st = s["bf"]()
    assert len(s["snaps"]) == full.rounds
    for k in range(full.rounds - 1):
        resumed = _resume("torch", str(s["root"] / f"torch{k + 1}"), st,
                          s["bf"])
        assert resumed.rows == full.rows
        assert resumed.best == full.best
        assert resumed.budget == full.budget
        assert resumed.rounds == full.rounds - (k + 1)
    assert os.path.isfile(os.path.join(s["snaps"][0], "arrays.npz"))
    assert os.path.isfile(os.path.join(s["snaps"][0], "manifest.json"))


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_rung_checkpoint_resumes_in_the_other_package(searches, writer):
    """A checkpoint taken after round 1 by one package, loaded by the
    other: the reader's search finishes on the writer's full trajectory
    (rows, best, budget), its handles' states equal to the writer's."""
    reader = "torch" if writer == "jax" else "jax"
    w, r = searches[writer], searches[reader]
    _, st = r["bf"]()
    path = str(w["root"] / f"{writer}1")
    if reader == "torch":
        _, handles = T.load_search(path, st)
        _, mine = T.load_search(str(r["root"] / "torch1"), st)
        assert handles.keys() == mine.keys() and handles
        for k in handles:
            assert_same_state(handles[k].state, jax.tree.map(
                np.asarray, J.load_search(path, _bf(J)()[1])[1][k].state))
            _same_tree(handles[k].state, mine[k].state)
    resumed = _resume(reader, path, st, r["bf"])
    full = w["res"]
    assert resumed.rows == full.rows
    assert resumed.best == full.best
    assert resumed.budget == full.budget
    assert resumed.rounds == full.rounds - 1


def test_load_search_restores_onto_the_template_in_its_dtypes(searches):
    s = searches["torch"]
    _, st = s["bf"]()
    _, handles = T.load_search(str(s["root"] / "torch1"), st)
    want = [(x.device, x.dtype, x.shape) for x in ref_leaves(st)]
    assert handles
    for h in handles.values():
        assert [(x.device, x.dtype, x.shape)
                for x in ref_leaves(h.state)] == want


# ---------------------------------------------------------------------------
# leaf order
# ---------------------------------------------------------------------------
def _reinserted(tree):
    """``tree`` with every dict's keys inserted in reverse order."""
    if isinstance(tree, dict):
        return {k: _reinserted(tree[k]) for k in reversed(list(tree))}
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _reinserted(getattr(tree, f.name))
            for f in dataclasses.fields(tree)})
    return tree


def test_ref_leaves_follow_jax_tree_leaves_on_a_memsys_state():
    sim, st = tm.build(n_cores=3, pattern="mixed", n_reqs=6, device="cpu")
    out = sim.run(st, 400.0)
    jsim, jst = jm.build(n_cores=3, pattern="mixed", n_reqs=6)
    ref = jax.tree.leaves(jsim.run(jst, 400.0))
    for state in (out, _reinserted(out)):
        mine = ref_leaves(state)
        assert len(mine) == len(ref)
        for x, y in zip(mine, ref):
            assert as_np(x).dtype == np.asarray(y).dtype
            assert x.shape == y.shape
            assert np.array_equal(_bits(x), _bits(y))
    # the engine's own order follows insertion, which is why the
    # checkpoint does not use it
    flip = _reinserted(out)
    assert [x.shape for x in tree_leaves(flip)] != \
        [x.shape for x in tree_leaves(out)]
    back = ref_unflatten(flip, ref_leaves(out))
    assert_same_state(back, out)
    assert list(back.comp_state) == list(flip.comp_state)
    with pytest.raises(ValueError, match="leaves"):
        ref_unflatten(out, ref_leaves(out)[:-1])


# ---------------------------------------------------------------------------
# Hyperband per-bracket budget caps
# ---------------------------------------------------------------------------
def test_bracket_budget_caps_stop_only_the_exhausted_bracket():
    runs = {}
    for name, dse in (("jax", J), ("torch", T)):
        bf = _bf(dse)
        free = dse.run_search(bf, dse.SuccessiveHalving(
            POOL, "virtual_time", brackets=2, **LADDER))
        spent = [br["spent"] for br in free.state.driver["brackets"]]
        caps = [spent[0] * 0.5, float("inf")]
        capped = dse.run_search(bf, dse.SuccessiveHalving(
            POOL, "virtual_time", brackets=2, bracket_budgets=caps,
            **LADDER))
        runs[name] = (free, capped, spent)
    free, capped, spent = runs["torch"]
    assert_same_search(free, runs["jax"][0])
    assert_same_search(capped, runs["jax"][1])
    assert all(x > 0 for x in spent)
    assert sum(spent) == pytest.approx(free.budget)
    brs = capped.state.driver["brackets"]
    assert brs[0]["spent"] < spent[0] and brs[0]["alive"]
    assert brs[1]["spent"] == pytest.approx(spent[1])


def test_bracket_budgets_equal_split_and_validation():
    drv = T.SuccessiveHalving(POOL, "virtual_time", brackets=2,
                              cycle_budget=1000.0, bracket_budgets="equal",
                              **LADDER)
    assert [br["budget"] for br in drv.state.driver["brackets"]] == \
        [500.0, 500.0]
    with pytest.raises(AssertionError, match="bracket budgets"):
        T.SuccessiveHalving(POOL, "virtual_time", brackets=2,
                            bracket_budgets=[1.0], **LADDER)
    with pytest.raises(AssertionError, match="cycle_budget"):
        T.SuccessiveHalving(POOL, "virtual_time", brackets=2,
                            bracket_budgets="equal", **LADDER)
