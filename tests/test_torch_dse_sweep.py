"""The port's sweep specification, report and schedule against the JAX
package: the same points from ``SweepSpec.grid``/``random``/``explicit``,
the same param trees (f32 by bits) and the same errors from
``apply_point``, ``valid_axes``, ``axis_error``, ``validate``,
``build_param_batch`` and ``stack_params``; the same Pareto fronts,
dominance and tidy rows; the same ladders, rung choices and quantum
growth fed fixed timings; the same bus bookkeeping."""
import numpy as np
import pytest

import repro.dse as J
import repro.obs.bus as jbus
import repro.sims.memsys as jm
import repro_torch.dse as T
import repro_torch.obs.bus as tbus
import repro_torch.sims.memsys as tm
from _torch_sim_parity import assert_same_state


@pytest.fixture(scope="module")
def sims():
    kw = dict(n_cores=2, pattern="mixed", n_reqs=4, donate=False)
    jsim, _ = jm.build(**kw)
    tsim, _ = tm.build(device="cpu", **kw)
    return jsim, tsim


@pytest.fixture(scope="module")
def fams():
    kw = dict(n_cores=3, pattern="mixed", n_reqs=4)
    return jm.build_family(**kw), tm.build_family(device="cpu", **kw)


def _raises(fn, exc):
    with pytest.raises(exc) as info:
        fn()
    return str(info.value)


# ---------------------------------------------------------------------------
# points
# ---------------------------------------------------------------------------
GRIDS = [
    {"a": [1, 2], "b": [10, 20, 30]},
    {"conn_latency[-1]": [10.0, 20.0], "kind.l1.extra_hit_rate": [0.0, 0.4],
     "static.n_reqs": [4, 6]},
    {"shape.core": [1, 2, 3], "period.dram": [1.0, 2.0]},
]


@pytest.mark.parametrize("axes", GRIDS)
def test_grid_gives_the_reference_points(axes):
    assert T.SweepSpec.grid(axes).points == J.SweepSpec.grid(axes).points


RANDOM = [
    ({"u": (2.0, 8.0), "l": (1.0, 100.0, "log"), "c": [4, 8, 16, "x"]}, 7),
    ({"r": (2, 8), "c": [1, 2, 4, 8],
      "n": [np.int32(3), np.int32(5), np.int32(9)], "f": (2.0, 8.0)}, 11),
    ({"conn_latency[-1]": (10.0, 40.0),
      "kind.l1.extra_hit_rate": (0.0, 0.8), "period.dram": [1.0, 2.0]}, 0),
]


@pytest.mark.parametrize("axes,seed", RANDOM)
def test_random_gives_the_reference_points(axes, seed):
    a = T.SweepSpec.random(axes, n=32, seed=seed).points
    b = J.SweepSpec.random(axes, n=32, seed=seed).points
    assert a == b
    assert [[type(v) for v in p.values()] for p in a] == \
        [[type(v) for v in p.values()] for p in b]


@pytest.mark.parametrize("spec", [(2.0, 8.0), (1, 5), (1.0, 9.0, "log"),
                                  [1, 2, 3], (True, False), ("a", "b")])
def test_parse_axis_spec_matches(spec):
    from repro.dse.sweep import parse_axis_spec as jp
    from repro_torch.dse.sweep import parse_axis_spec as tp
    assert tp(spec) == jp(spec)


def test_explicit_points_and_ragged_error_match():
    pts = [{"a": 1, "b": 2}, {"a": 3, "b": 4}]
    assert T.SweepSpec.explicit(pts).points == J.SweepSpec.explicit(pts).points
    bad = [{"a": 1, "b": 2}, {"a": 3}, {"static.s": 1, "c": 0}]
    msg = _raises(lambda: T.SweepSpec.explicit(bad), ValueError)
    assert msg == _raises(lambda: J.SweepSpec.explicit(bad), ValueError)
    assert T.SweepSpec.explicit(bad, ragged=True).points == tuple(bad)


def test_split_static_summary_and_split_shape_match():
    pts = [{"static.n": 2, "conn_latency": 3.0, "shape.core": 1},
           {"static.n": 4, "conn_latency": 5.0, "shape.core": 2},
           {"static.n": 2, "conn_latency": 7.0, "shape.core": 3}]
    a, b = T.SweepSpec.explicit(pts), J.SweepSpec.explicit(pts)
    assert a.split_static() == b.split_static()
    assert a.summary() == b.summary()
    assert a.axes == b.axes and a.has_shape_axes() == b.has_shape_axes()
    for p in pts:
        assert T.split_shape(p) == J.split_shape(p)


# ---------------------------------------------------------------------------
# param trees and their errors
# ---------------------------------------------------------------------------
APPLY = [
    {},
    {"conn_latency": 12.5},
    {"conn_latency[-1]": 17.3, "conn_latency[0]": 2.0},
    {"period.l1": 2.0, "period.dram[0]": 3.0},
    {"kind.l1.extra_hit_rate": 0.41, "kind.core.think_scale": 1.7},
    {"conn_latency[-1]": 10.0 + 30.0 * 7 / 255,
     "kind.l1.extra_hit_rate": 0.8 * 49 / 255},
]


@pytest.mark.parametrize("point", APPLY)
def test_apply_point_gives_the_reference_tree(sims, point):
    jsim, tsim = sims
    assert_same_state(T.apply_point(tsim.default_params(), point),
                      J.apply_point(jsim.default_params(), point))


@pytest.mark.parametrize("point", [
    {"static.n_cores": 4}, {"shape.core": 2}, {"bogus": 1.0},
    {"period.nope": 1.0}, {"kind.nope.x": 1.0}, {"kind.l1.nope": 1.0},
    {"kind.l1": 1.0}])
def test_apply_point_errors_match(sims, point):
    jsim, tsim = sims
    got = _raises(lambda: T.apply_point(tsim.default_params(), point),
                  KeyError)
    assert got == _raises(
        lambda: J.apply_point(jsim.default_params(), point), KeyError)


def test_apply_point_out_of_range_index_raises_in_both(sims):
    jsim, tsim = sims
    for mod, sim in ((T, tsim), (J, jsim)):
        with pytest.raises(AssertionError, match="out of range"):
            mod.apply_point(sim.default_params(), {"conn_latency[99]": 1.0})


@pytest.mark.parametrize("path", [
    "conn_latency", "conn_latency[-1]", "conn_latency[99]", "period.l1",
    "period.l1[5]", "period.zz", "kind.l1.extra_hit_rate", "kind.l1[0].x",
    "kind.dram.x", "kind.l1.nope", "what"])
def test_axis_error_matches(sims, path):
    jsim, tsim = sims
    assert T.valid_axes(tsim.default_params()) == \
        J.valid_axes(jsim.default_params())
    from repro.dse.sweep import axis_error as ja
    from repro_torch.dse.sweep import axis_error as ta
    assert ta(tsim.default_params(), path) == ja(jsim.default_params(), path)


def test_validate_errors_match_for_sims_and_families(sims, fams):
    jsim, tsim = sims
    jfam, tfam = fams
    pts = [{"period.l1x": 1.0, "static.zzz": 2, "shape.core": 1,
            "conn_latency[7]": 2.0}]
    for static_ok in (None, ["n_cores"]):
        got = _raises(lambda: T.SweepSpec(tuple(pts)).validate(
            tsim, static_ok), ValueError)
        assert got == _raises(lambda: J.SweepSpec(tuple(pts)).validate(
            jsim, static_ok), ValueError)
    fam_pts = [{"shape.core": 2, "shape.l2": 1, "kind.l1.extra_hit_rate": 0}]
    got = _raises(lambda: T.SweepSpec(tuple(fam_pts)).validate(tfam),
                  ValueError)
    assert got == _raises(lambda: J.SweepSpec(tuple(fam_pts)).validate(jfam),
                          ValueError)
    ok = [{"shape.core": 2, "kind.l1.extra_hit_rate": 0.4}]
    T.SweepSpec.explicit(ok, validate_for=tfam)


def test_build_param_batch_and_stack_params_match(sims, fams):
    jsim, tsim = sims
    pts = APPLY[1:]
    pts = [dict(APPLY[-1], **p) for p in pts]
    for p in pts:                  # one axis set for every point
        p.setdefault("period.l1", 1.0)
    assert_same_state(T.build_param_batch(tsim, pts),
                      J.build_param_batch(jsim, pts))
    jfam, tfam = fams
    shapes = [{"core": c} for c in (1, 3, 2)]
    assert_same_state(
        T.stack_params([tfam.params_for(s) for s in shapes]),
        J.stack_params([jfam.params_for(s) for s in shapes]))
    for s in shapes:
        assert_same_state(tfam.state_for(s), jfam.state_for(s))


def test_stack_trees_gives_every_lane_fresh_storage(sims):
    _, tsim = sims
    base = tsim.default_params()
    b = T.stack_params([base, base])
    b.conn_latency[0, 0] = 99.0
    assert float(b.conn_latency[1, 0]) != 99.0
    assert float(base.conn_latency[0]) != 99.0


# ---------------------------------------------------------------------------
# report
# ---------------------------------------------------------------------------
def _rows(n=60, seed=0):
    rng = np.random.default_rng(seed)
    rows = [{"t": float(rng.integers(0, 9)), "lat": int(rng.integers(0, 5)),
             "hit": float(rng.uniform()), "name": f"p{i}"} for i in range(n)]
    rows[3]["hit"] = float("nan")
    rows[7] = dict(rows[5])                      # a duplicate
    return rows


@pytest.mark.parametrize("objectives", [
    {"t": "min"}, {"t": "min", "lat": "max"},
    {"t": "min", "lat": "max", "hit": "min"}, {"hit": "max", "lat": "min"}])
def test_pareto_front_and_dominates_match(objectives):
    rows = _rows()
    assert T.pareto_front(rows, objectives) == \
        J.pareto_front(rows, objectives)
    for a in rows[:12]:
        for b in rows[:12]:
            assert T.dominates(a, b, objectives) == \
                J.dominates(a, b, objectives)
        assert repr(T.score_vector(a, objectives)) == \
            repr(J.score_vector(a, objectives))


def test_tidy_table_and_exports_match(tmp_path):
    rows = _rows(8) + [{"t": np.float32(2.5), "extra": np.int32(3)}]
    assert T.tidy(rows) == J.tidy(rows)
    assert T.format_table(rows) == J.format_table(rows)
    for fn in ("to_json", "to_csv"):
        getattr(T, fn)(rows, str(tmp_path / f"t_{fn}"))
        getattr(J, fn)(rows, str(tmp_path / f"j_{fn}"))
        assert (tmp_path / f"t_{fn}").read_text() == \
            (tmp_path / f"j_{fn}").read_text()


# ---------------------------------------------------------------------------
# schedule
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("b,top,min_rung,factor", [
    (256, None, 8, 2), (16, 0, 8, 2), (16, -3, 8, 2), (5, None, 8, 2),
    (16, 8, 4, 2), (300, 100, 3, 3), (1, None, 8, 2), (64, 64, 1, 4)])
def test_make_ladder_and_size_for_match(b, top, min_rung, factor):
    lad = T.make_ladder(b, top=top, min_rung=min_rung, factor=factor)
    assert lad == J.make_ladder(b, top=top, min_rung=min_rung,
                                factor=factor)
    ts, js = T.ChunkSchedule(lad), J.ChunkSchedule(lad)
    assert [ts.size_for(w) for w in range(0, b + 3)] == \
        [js.size_for(w) for w in range(0, b + 3)]
    for top in set(lad) | {b + 1}:
        a, r = ts.narrowed(top), js.narrowed(top)
        assert (a.ladder, a.autotune) == (r.ladder, r.autotune)


# (round s, host s, pipeline depth) fed to grow_quantum in turn
TIMINGS = [(0.01, 0.001, 1), (0.01, 0.001, 2), (0.2, 0.001, 1),
           (0.02, 0.5, 2), (0.03, 0.0, 3), (0.0001, 0.0, 8), (1.0, 2.0, 1)]


def test_grow_quantum_fed_fixed_timings_matches():
    ts = T.auto_schedule(256, quantum=16)
    js = J.auto_schedule(256, quantum=16)
    assert (ts.ladder, ts.quantum, ts.autotune) == \
        (js.ladder, js.quantum, js.autotune)
    for _ in range(3):
        for dt, host, steps in TIMINGS:
            ts.grow_quantum(dt, host, steps=steps)
            js.grow_quantum(dt, host, steps=steps)
            assert ts.quantum == js.quantum
    for b, chunk in ((10, None), (64, None), (64, 16), (300, 1000)):
        a, r = T.auto_schedule(b, chunk=chunk), J.auto_schedule(b, chunk=chunk)
        assert (a.ladder, a.quantum, a.autotune) == \
            (r.ladder, r.quantum, r.autotune)


def test_chunk_autotuner_fed_fixed_timings_matches():
    sched = (T.ChunkSchedule(T.make_ladder(256), autotune=True),
             J.ChunkSchedule(J.make_ladder(256), autotune=True))
    tuners = [T.ChunkAutotuner(sched[0], 200),
              J.ChunkAutotuner(sched[1], 200)]
    dts = {256: 0.5, 128: 0.2, 64: 0.15}
    picks = []
    for tuner in tuners:
        seq, fill = [], 200
        while (r := tuner.next_probe(fill)) is not None:
            seq.append(r)
            tuner.record(r, dts.get(r, 1.0), lanes=min(r, fill),
                         host_dt=0.01)
            fill -= 20
        picks.append((seq, tuner.best(256), dict(tuner.rates)))
    assert picks[0] == picks[1]


# ---------------------------------------------------------------------------
# bus
# ---------------------------------------------------------------------------
def test_bus_bookkeeping_matches():
    out = []
    for mod in (tbus, jbus):
        bus = mod.Bus()
        assert bus.emit("x", a=1) is None and bus.seq == 0
        with mod.capture(bus) as sink:
            bus.emit("round.end", round=0)
            with bus.span("compile", what="run") as extra:
                extra["b"] = 8
            bus.count("dse.rounds")
            bus.gauge("dse.lanes_live", 3)
            bus.observe("dse.round_s", 0.25)
            bus.observe("dse.round_s", 0.75)
        assert not bus.active
        out.append(([{k: v for k, v in e.items() if k not in ("ts", "dur")}
                     for e in sink.events], sink.kinds(),
                    bus.metrics.snapshot(), bus.seq))
    assert out[0] == out[1]
