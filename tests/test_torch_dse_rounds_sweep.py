"""The port's batched lanes against the JAX package's, on memsys, at the
sweep level (split from ``tests/test_torch_dse_rounds.py`` so that the
two halves run on two workers):

* masked topology-family lanes at mixed horizons, whole states f32 by
  bits;
* ``run_sweep`` over traced, ``static.*`` and ``shape.*`` axes gives the
  JAX rows; an index-aware extractor; a warm resume equals a cold run;
  ``round.end`` events carry the reference's keys.

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

POINTS = [{"conn_latency[-1]": float(v)} for v in (10, 15, 20, 25, 30, 35)]


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
