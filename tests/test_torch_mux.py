"""The port's lane multiplexer (``repro_torch.dse.mux``): the seven cases
of tests/dse/test_mux.py, each job's rows also held against the JAX
package's ``LaneMux`` on the same jobs, and the dashboard's mux panel
read from both packages' event streams."""
import pytest

import repro.dse as J
import repro.obs.bus as jbus
import repro.obs.dashboard as jdash
import repro.sims.memsys as jm
import repro_torch.dse as T
import repro_torch.obs.bus as tbus
import repro_torch.obs.dashboard as tdash
import repro_torch.sims.memsys as tm
from _torch_sim_parity import one_torch_thread  # noqa
from repro_torch.dse.mux import MUX_AXIS, MuxJob


def _build_a():
    return tm.build(n_cores=3, pattern="mixed", n_reqs=6, device="cpu")


def _build_b():
    return tm.build(n_cores=2, pattern="stream", n_reqs=6, device="cpu")


def _jbuild_a():
    return jm.build(n_cores=3, pattern="mixed", n_reqs=6, donate=True)


def _jbuild_b():
    return jm.build(n_cores=2, pattern="stream", n_reqs=6, donate=True)


PTS_A = [{"conn_latency[-1]": float(v)} for v in (10, 25, 40)]
PTS_B = [{"conn_latency[-1]": float(v)} for v in (12, 30)]
SPEC_A, SPEC_B = T.SweepSpec.explicit(PTS_A), T.SweepSpec.explicit(PTS_B)


def _jax_mux(jobs, **run_kw):
    """The JAX package's LaneMux on the same jobs (build, points, until)."""
    mux = J.LaneMux()
    for job_id, build, pts, until in jobs:
        mux.submit(job_id, build, J.SweepSpec.explicit(pts), until)
    return mux.run(**run_kw)


# ---------------------------------------------------------------------------
def test_two_jobs_shared_build_rows_identical_to_solo_and_jax():
    u_a, u_b = [300.0, 1200.0, 600.0], [900.0, 150.0]
    bf = T.memoize_build(_build_a)
    solo_a = T.run_sweep(bf, SPEC_A, u_a, chunk=2)
    solo_b = T.run_sweep(bf, SPEC_B, u_b, chunk=2)
    mux = T.LaneMux()
    mux.submit("a", bf, SPEC_A, u_a)
    mux.submit("b", bf, SPEC_B, u_b)
    got = mux.run(chunk=2)
    assert set(got) == {"a", "b"}
    assert got["a"] == solo_a and got["b"] == solo_b
    assert got == _jax_mux([("a", _jbuild_a, PTS_A, u_a),
                            ("b", _jbuild_a, PTS_B, u_b)], chunk=2)


def test_two_jobs_different_builds_routed_and_identical():
    solo_a = T.run_sweep(_build_a, SPEC_A, 500.0)
    solo_b = T.run_sweep(_build_b, SPEC_B, [250.0, 800.0])
    mux = T.LaneMux()
    mux.submit("a", _build_a, SPEC_A, 500.0)
    mux.submit("b", _build_b, SPEC_B, [250.0, 800.0])
    got = mux.run()
    assert got["a"] == solo_a and got["b"] == solo_b
    for rows in got.values():
        assert all(MUX_AXIS not in r for r in rows)
    assert got == _jax_mux([("a", _jbuild_a, PTS_A, 500.0),
                            ("b", _jbuild_b, PTS_B, [250.0, 800.0])])


@pytest.fixture(scope="module")
def shared_events():
    """One shared-build mux run in each package, under its bus's
    capture."""
    out = {}
    for name, dse, bus, build in (("jax", J, jbus, _jbuild_a),
                                  ("torch", T, tbus, _build_a)):
        mux = dse.LaneMux()
        mux.submit("a", build, dse.SweepSpec.explicit(PTS_A), 400.0)
        mux.submit("b", build, dse.SweepSpec.explicit(PTS_B), 700.0)
        with bus.capture() as sink:
            rows = mux.run(chunk=2)
        out[name] = (rows, list(sink.events))
    return out


def test_jobs_share_one_group_and_rounds(shared_events):
    rows, events = shared_events["torch"]
    groups = [e for e in events if e["kind"] == "sweep.group"]
    assert len(groups) == 1
    assert groups[0]["n_points"] == len(SPEC_A) + len(SPEC_B)
    kinds = [e["kind"] for e in events]
    assert kinds[0] == "mux.start" and kinds[-1] == "mux.end"
    assert rows == shared_events["jax"][0]


def test_dashboard_mux_panel_equals_jax(shared_events):
    snaps = {}
    for name, dash in (("jax", jdash), ("torch", tdash)):
        stats = dash.CampaignStats()
        for ev in shared_events[name][1]:
            stats.on_event(ev)
        snap = stats.snapshot()
        snaps[name] = dict(mux=snap["mux"], sweeps=snap["sweeps"],
                           lanes=snap["lanes"], search=snap["search"])
    assert snaps["torch"] == snaps["jax"]
    assert snaps["torch"]["mux"] == {"runs": 1, "jobs": 2}
    drop = ("ts", "seq", "dur")
    mux_events = {name: [{k: v for k, v in e.items() if k not in drop}
                         for e in ev if e["kind"].startswith("mux.")]
                  for name, (_, ev) in shared_events.items()}
    assert mux_events["torch"] == mux_events["jax"]


def test_interleave_is_round_robin_fair():
    order = T.LaneMux._interleave([MuxJob("a", _build_a, SPEC_A, 1.0),
                                   MuxJob("b", _build_a, SPEC_B, 1.0)])
    assert order == [(0, 0), (1, 0), (0, 1), (1, 1), (0, 2)]
    assert order == J.LaneMux._interleave([
        J.MuxJob("a", _jbuild_a, J.SweepSpec.explicit(PTS_A), 1.0),
        J.MuxJob("b", _jbuild_a, J.SweepSpec.explicit(PTS_B), 1.0)])


def test_per_job_extractors_and_custom_rows():
    def ex_a(sim, lane_state):
        return {"t": float(lane_state.time)}

    bf = T.memoize_build(_build_a)
    mux = T.LaneMux()
    mux.submit("a", bf, SPEC_A, 400.0, extract=ex_a)
    mux.submit("b", bf, SPEC_B, 400.0)
    got = mux.run(chunk=2)
    assert all(set(r) == {"conn_latency[-1]", "t"} for r in got["a"])
    assert all("epochs" in r for r in got["b"])
    ref = J.LaneMux()
    ref.submit("a", _jbuild_a, J.SweepSpec.explicit(PTS_A), 400.0,
               extract=ex_a)
    ref.submit("b", _jbuild_a, J.SweepSpec.explicit(PTS_B), 400.0)
    assert got == ref.run(chunk=2)


def test_reserved_axis_and_duplicate_job_id_rejected():
    bad = T.SweepSpec.explicit([{MUX_AXIS: 0, "conn_latency[-1]": 5.0}],
                               ragged=True)
    mux = T.LaneMux()
    with pytest.raises(ValueError, match="reserved"):
        mux.submit("a", _build_a, bad, 100.0)
    mux.submit("a", _build_a, SPEC_A, 100.0)
    with pytest.raises(ValueError, match="duplicate"):
        mux.submit("a", _build_a, SPEC_B, 100.0)


def test_mux_adds_no_capture_over_solo():
    mb = T.memoize_build(_build_a)
    T.run_sweep(mb, SPEC_A, 400.0, chunk=2)
    T.run_sweep(mb, SPEC_B, 700.0, chunk=2)
    sim, _ = mb()
    warm = T.runner_for(sim).trace_count
    mux = T.LaneMux()
    mux.submit("a", mb, SPEC_A, 400.0)
    mux.submit("b", mb, SPEC_B, 700.0)
    mux.run(chunk=2)
    assert T.runner_for(sim).trace_count == warm
