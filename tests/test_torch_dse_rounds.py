"""The port's batched lanes against the JAX package's, on memsys: whole
batched final states, f32 by bits, and sweep rows in spec order.

* a singleton batch equals the unbatched ``Simulation.run``;
* ``run_batch`` at mixed per-lane horizons equals the JAX ``run_batch``;
  ``run_rounds`` (pipelined and not) and ``run_chunked`` (padded tail)
  equal both;
* zero-horizon lanes freeze on entry; lane order does not matter; no new
  block is made after ``warm_ladder``; a consumed template raises.

The family lanes, ``run_sweep`` and its events are in
``tests/test_torch_dse_rounds_sweep.py`` (split so that the two halves
run on two workers).

Rows and states are compared, never round counts where the schedule times
itself.  The port runs eagerly on the CPU under two vmap levels, so the
sizes are small."""
import numpy as np
import pytest
import torch

import repro.dse as J
import repro.sims.memsys as jm
import repro_torch.dse as T
import repro_torch.sims.memsys as tm
from repro_torch.core.engine import tree_leaves
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
    # shard= above 1 runs (clamped to the one CPU placement here): the
    # same state as the plain path
    a = T.BatchRunner(sim).run_batch(T.stack_states(st, 2), pb, 100.0)
    b = T.BatchRunner(sim).run_batch(T.stack_states(st, 2), pb, 100.0,
                                     shard=2)
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert torch.equal(x, y)
