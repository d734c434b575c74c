"""The port's batched lanes against the JAX package's, on memsys: whole
batched final states, f32 by bits, and sweep rows in spec order.

* a singleton batch equals the unbatched ``Simulation.run``;
* ``run_batch`` at mixed per-lane horizons equals the JAX ``run_batch``;
  ``run_rounds`` (pipelined and not) and ``run_chunked`` (padded tail)
  equal both;
* zero-horizon lanes freeze on entry; lane order does not matter; no new
  block is made after ``warm_ladder``; a consumed template raises;
* masked topology-family lanes at mixed horizons;
* ``run_sweep`` over traced, ``static.*`` and ``shape.*`` axes gives the
  JAX rows; a warm resume equals a cold run; ``round.end`` events carry
  the reference's keys.

Rows and states are compared, never round counts where the schedule times
itself.  The port runs eagerly on the CPU under two vmap levels, so the
sizes are small."""
import jax
import numpy as np
import pytest

import repro.dse as J
import repro.obs.bus as jbus
import repro.sims.memsys as jm
import repro_torch.dse as T
import repro_torch.obs.bus as tbus
import repro_torch.sims.memsys as tm
from _torch_sim_parity import assert_same_state

B = 6
POINTS = [{"conn_latency[-1]": float(v)} for v in (10, 15, 20, 25, 30, 35)]
# mixed per-lane horizons, ~8x apart, one lane draining before its horizon
UNTILS = np.asarray([200.0, 400.0, 800.0, 1600.0, 300.0, 50.0], np.float32)
KW = dict(n_cores=4, pattern="mixed", n_reqs=8)


def _rounds():
    """A schedule that forces several rounds and real compaction."""
    return T.ChunkSchedule(T.make_ladder(B, top=3), quantum=32)


@pytest.fixture(scope="module")
def ref():
    """The JAX package's full batch at the mixed horizons."""
    sim, st = jm.build(**KW)
    pb = J.build_param_batch(sim, POINTS)
    return J.BatchRunner(sim).run_batch(J.stack_states(st, B), pb, UNTILS)


@pytest.fixture(scope="module")
def ctx():
    sim, st = tm.build(device="cpu", **KW)
    runner = T.BatchRunner(sim)
    pb = T.build_param_batch(sim, POINTS)
    full = runner.run_batch(T.stack_states(st, B), pb, UNTILS)
    return sim, st, runner, pb, full


# ---------------------------------------------------------------------------
def test_singleton_batch_equals_unbatched_run():
    sim, st = tm.build(device="cpu", donate=False, **KW)
    p = T.apply_point(sim.default_params(), POINTS[2])
    out = T.BatchRunner(sim).run_batch(
        T.stack_states(st, 1), T.stack_params([p]), 800.0)
    single = sim.run(st, 800.0, params=p)
    assert_same_state(T.lane(out, 0), single)
    jsim, jst = jm.build(**KW)
    assert_same_state(single, jsim.run(
        jst, 800.0, params=J.apply_point(jsim.default_params(), POINTS[2])))


def test_run_batch_mixed_horizons_equals_jax(ctx, ref):
    *_, full = ctx
    assert_same_state(full, ref)
    assert [int(e) for e in full.stats.epochs][-1] < \
        [int(e) for e in full.stats.epochs][3]


@pytest.mark.parametrize("pipeline", [False, None])
def test_run_rounds_equals_run_batch_and_jax(ctx, ref, pipeline):
    sim, st, runner, pb, full = ctx
    out = runner.run_rounds(st, pb, UNTILS, schedule=_rounds(),
                            pipeline=pipeline)
    assert runner.last_rounds["rounds"] > 2      # compaction ran
    assert runner.last_rounds["pipeline"] == (1 if pipeline is False else 2)
    assert_same_state(out, full)
    assert_same_state(out, ref)


def test_run_chunked_padded_tail_equals_jax(ctx, ref):
    sim, st, runner, pb, full = ctx
    out = runner.run_chunked(st, pb, UNTILS, chunk=4)   # 4 + 2 (+2 pad)
    assert_same_state(out, ref)


def test_zero_horizon_lanes_freeze_on_entry(ctx):
    sim, st, runner, pb, full = ctx
    u = UNTILS.copy()
    m = np.full(B, 2_000_000, np.int32)
    u[2], m[2] = 0.0, 0
    sb = T.stack_states(st, B)
    keep = sim.copy_state(sb)
    out = runner.run_batch(sb, pb, u, m)
    frozen = T.lane(out, 2)
    assert int(frozen.stats.epochs) == 0 and float(frozen.time) == 0.0
    assert_same_state(frozen, T.lane(keep, 2))
    for i in (0, 1, 3, 4, 5):                    # siblings unaffected
        assert_same_state(T.lane(out, i), T.lane(full, i))


def test_lane_permutation_invariance(ctx):
    sim, st, runner, pb, full = ctx
    perm = np.asarray([3, 1, 5, 0, 4, 2])
    pb_p = T.stack_params([T.lane(pb, i) for i in perm])
    out = runner.run_rounds(st, pb_p, UNTILS[perm], schedule=_rounds())
    for j, i in enumerate(perm):
        assert_same_state(T.lane(out, j), T.lane(full, i))


def test_no_new_block_after_warm_ladder():
    sim, st = tm.build(device="cpu", **KW)
    runner = T.BatchRunner(sim)
    pb = T.build_param_batch(sim, POINTS)
    sched = _rounds()
    runner.warm_ladder(st, pb, sched.ladder)
    assert runner.trace_count == len(sched.ladder)
    assert int(sim.copy_state(st).stats.epochs) == 0
    t0 = runner.trace_count
    out = runner.run_rounds(st, pb, UNTILS[:B], schedule=sched)
    assert runner.last_rounds["rounds"] > 2
    assert runner.trace_count == t0
    runner.run_rounds(st, pb, UNTILS, schedule=sched, pipeline=False)
    assert runner.trace_count == t0
    assert float(T.lane(out, 3).time) > 0.0


def test_consumed_template_or_batch_raises():
    sim, st = tm.build(device="cpu", n_cores=2, pattern="mixed", n_reqs=4)
    sim.run(st, 500.0)                           # consumes st
    runner = T.BatchRunner(sim)
    pb = T.build_param_batch(sim, [{}, {}])
    with pytest.raises(RuntimeError, match="copy_state"):
        runner.run_rounds(st, pb, 500.0)
    sim, st = tm.build(device="cpu", n_cores=2, pattern="mixed", n_reqs=4)
    sb = T.stack_states(st, 2)
    T.BatchRunner(sim).run_batch(sb, pb, 100.0)
    with pytest.raises(RuntimeError, match="donate=False"):
        T.BatchRunner(sim).run_batch(sb, pb, 100.0)
    with pytest.raises(NotImplementedError, match="queue 1 item 10"):
        T.BatchRunner(sim).run_batch(T.stack_states(st, 2), pb, 100.0,
                                     shard=2)


def test_family_masked_rounds_equal_jax():
    shapes = [{"core": c} for c in (1, 2, 3, 4, 2, 3)]
    untils = np.asarray([300.0, 900.0, 150.0, 1200.0, 600.0, 75.0],
                        np.float32)
    outs = []
    for P, kw in ((J, {}), (T, {"device": "cpu"})):
        fam = (jm if P is J else tm).build_family(
            n_cores=4, pattern="mixed", n_reqs=8, **kw)
        pb = P.stack_params([fam.params_for(s) for s in shapes])
        states = [fam.state_for(s) for s in shapes]
        runner = P.BatchRunner(fam.sim)
        if P is J:
            outs.append(runner.run_batch(P.stack_state_list(states), pb,
                                         untils))
            continue
        outs.append(runner.run_rounds(
            states, pb, untils,
            schedule=T.ChunkSchedule(T.make_ladder(6, top=2), quantum=24)))
        assert runner.last_rounds["rounds"] > 2
    assert_same_state(outs[1], outs[0])


# ---------------------------------------------------------------------------
# run_sweep: traced, static and shape axes
# ---------------------------------------------------------------------------
def _build(pkg, **kw):
    def build(n_reqs=6):
        return pkg.build(n_cores=3, pattern="mixed", n_reqs=n_reqs, **kw)
    return build


SWEEPS = {
    "traced": (lambda pkg, kw: _build(pkg, **kw),
               {"conn_latency[-1]": [10.0, 30.0],
                "kind.l1.extra_hit_rate": [0.0, 0.4]},
               [150.0, 600.0, 600.0, 1200.0]),
    "static": (lambda pkg, kw: _build(pkg, **kw),
               {"static.n_reqs": [4, 6], "conn_latency[-1]": [12.0, 24.0]},
               1000.0),
    "shape": (lambda pkg, kw: (lambda shape: pkg.build_family(
                  shape=shape, pattern="mixed", n_reqs=6, **kw)),
              {"shape.core": [1, 3], "kind.l1.extra_hit_rate": [0.0, 0.8]},
              1500.0),
}


@pytest.mark.parametrize("kind", sorted(SWEEPS))
def test_run_sweep_rows_equal_jax(kind):
    make, axes, until = SWEEPS[kind]
    spec_t, spec_j = T.SweepSpec.grid(axes), J.SweepSpec.grid(axes)
    got = T.run_sweep(make(tm, {"device": "cpu"}), spec_t, until=until)
    want = J.run_sweep(make(jm, {}), spec_j, until=until)
    assert got == want
    assert [{k: r[k] for k in axes} for r in got] == list(spec_t.points)


def test_extract_rows_and_index_aware_extractor():
    spec = T.SweepSpec.explicit(POINTS[:3])
    seen = []

    def ex(sim, s, i):
        seen.append(i)
        return {"t": float(s.time), "i": i}

    build = _build(tm, device="cpu")
    rows = T.run_sweep(build, spec, until=300.0, extract=ex)
    assert [r["i"] for r in rows] == [0, 1, 2] and sorted(seen) == [0, 1, 2]
    sim, st = build()
    out = T.BatchRunner(sim).run_batch(
        T.stack_states(st, 3), T.build_param_batch(sim, POINTS[:3]), 300.0)
    assert [r["virtual_time"] for r in T.extract_rows(sim, out, 3)] == \
        [r["t"] for r in rows]


def test_resume_from_lane_states_equals_cold_run():
    spec = T.SweepSpec.explicit(POINTS[:4])
    build = T.memoize_build(_build(tm, device="cpu"))
    short, states = T.run_sweep(build, spec, until=300.0, return_states=True)
    assert len(states) == 4 and 2 in states
    handles = [states.handle(i, 300.0) for i in range(3)] + [None]
    assert handles[1].epochs == short[1]["epochs"]
    warm = T.run_sweep(build, spec, until=900.0, resume=handles)
    cold = T.run_sweep(build, spec, until=900.0)
    assert warm == cold
    assert cold == J.run_sweep(_build(jm), J.SweepSpec.explicit(POINTS[:4]),
                               until=900.0)


def test_round_end_events_carry_the_reference_keys():
    axes = {"conn_latency[-1]": [10.0, 20.0, 30.0]}
    events = []
    for P, bus, kw, mod in ((T, tbus, {"device": "cpu"}, tm),
                            (J, jbus, {}, jm)):
        with bus.capture() as sink:
            rows = P.run_sweep(_build(mod, **kw), P.SweepSpec.grid(axes),
                               until=400.0,
                               schedule=P.ChunkSchedule((2, 1), quantum=16))
        events.append((rows, sink))
    (t_rows, t_sink), (j_rows, j_sink) = events
    assert t_rows == j_rows
    timed = {"quantum.grow"}         # depends on the host's clock
    assert set(t_sink.kinds()) - timed == set(j_sink.kinds()) - timed
    t_keys = {k for e in t_sink.of("round.end") for k in e}
    j_keys = {k for e in j_sink.of("round.end") for k in e}
    assert t_keys == j_keys
    for kind in ("rounds.start", "rounds.end", "sweep.start", "sweep.end"):
        assert set(t_sink.of(kind)[0]) == set(j_sink.of(kind)[0])
    assert jax.default_backend() == "cpu"
