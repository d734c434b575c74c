"""The port's tracers, Daisen export and monitor (``repro_torch.core.
tracers``, ``daisen``, ``monitor``): the reference's tests
(tests/core/test_tracing.py, test_tracers.py, test_monitor_http.py,
test_daisen_escape.py) on the port's sims, and the monitor's status
history, bottleneck reports, inspection, ``force_tick`` and hang detection
held against the JAX monitor on the same build."""
import csv
import json
import sqlite3
import threading
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
import repro.core.daisen as jdaisen
import repro.core.monitor as jmon
import repro.core.tracers as jtr
import repro.core.tracing as jtracing
import repro.sims.memsys as jm
import repro_torch.core as T
import repro_torch.sims.memsys as tm
from repro_torch.core import daisen
from repro_torch.core.monitor import HttpEndpoint, Monitor
from repro_torch.core.tracers import (AverageTimeTracer, BusyTimeTracer,
                                      DBTracer, TagCountTracer,
                                      TotalTimeTracer, flush_engine_trace)
from repro_torch.core.tracing import Task, TracingDomain, format_backtrace
from _torch_sim_parity import assert_same_state, chip_smoke


def _clock():
    t = {"v": 0.0}

    def fn():
        t["v"] += 1.0
        return t["v"]

    return fn


def _build(pkg, **kw):
    if pkg == "jax":
        return jm.build(**kw)
    return tm.build(device="cpu", **kw)


# ---------------------------------------------------------------------------
# tracers (tests/core/test_tracing.py, test_tracers.py)
# ---------------------------------------------------------------------------
def test_task_tree_and_tracers():
    dom = TracingDomain("t", time_fn=_clock())
    tot = dom.attach(TotalTimeTracer())
    avg = dom.attach(AverageTimeTracer(),
                     filter=lambda t: t.category == "mem")
    busy = dom.attach(BusyTimeTracer())
    tags = dom.attach(TagCountTracer())
    with dom.task("inst", "load", "core0") as t1:
        dom.tag_task("issued")
        with dom.task("mem", "read", "l1") as t2:
            dom.tag_task("cache-hit")
            assert t2.parent_id == t1.id
    assert tot.metrics() == {"total_time": 4.0, "count": 2}
    assert avg.metrics() == {"avg_time": 1.0, "count": 1}   # filter applied
    assert tags.metrics() == {"issued": 1, "cache-hit": 1}
    assert busy.metrics() == {"core0": 3.0, "l1": 1.0}


def test_sqlite_task_round_trip_preserves_every_field(tmp_path):
    dom = TracingDomain("t", time_fn=_clock())
    db = dom.attach(DBTracer(str(tmp_path / "t.db"), run_id="rt"))
    with dom.task("inst", "load $2,[$4]", "Core0") as t1:
        dom.tag_task("issued")
        with dom.task("mem", "read", "L1[0]") as t2:
            dom.tag_task("hit")
            t2.details["bank"] = 3
    db.flush()
    got = {t.id: t for t in db.fetch_tasks()}
    assert set(got) == {t1.id, t2.id}
    r1, r2 = got[t1.id], got[t2.id]
    assert (r1.category, r1.action, r1.location) == \
        ("inst", "load $2,[$4]", "Core0")
    assert r1.parent_id == "" and r2.parent_id == t1.id
    assert r1.start == t1.start and r1.end == t1.end
    assert r1.tags == ["issued"] and r2.tags == ["hit"]
    assert r2.details == {"bank": 3}
    open_task = Task(id="x", parent_id="", category="c", action="a",
                     location="l", start=9.0, end=None)
    db.on_end(open_task)
    db.flush()
    assert [t.end for t in db.fetch_tasks() if t.id == "x"] == [None]
    db.close()


def test_sqlite_metrics_round_trip_and_run_table(tmp_path):
    path = tmp_path / "m.db"
    db = DBTracer(str(path), run_id="runA")
    db.add_metric("buf_level", "l1.p0", 1.0, 3.0)
    db.add_metrics([("buf_level", "l1.p1", 2.0, 4.0),
                    ("busy_ticks", "core[0]", 2.0, 17.0)])
    db.flush()
    assert db.fetch_metrics("buf_level") == [
        ("buf_level", "l1.p0", 1.0, 3.0), ("buf_level", "l1.p1", 2.0, 4.0)]
    assert len(db.fetch_metrics()) == 3
    db.close()
    conn = sqlite3.connect(str(path))
    assert conn.execute("SELECT run_id FROM runs").fetchone() == ("runA",)
    assert conn.execute(
        "SELECT DISTINCT run_id FROM metrics").fetchall() == [("runA",)]
    conn.close()


def test_csv_backend_round_trip(tmp_path):
    path = tmp_path / "t.csv"
    dom = TracingDomain("t", time_fn=_clock())
    db = dom.attach(DBTracer(str(path), backend="csv"))
    with dom.task("a", "act", "loc"):
        pass
    db.close()
    with open(path, newline="") as fh:
        rows = list(csv.DictReader(fh))
    assert len(rows) == 1
    assert rows[0]["category"] == "a" and rows[0]["location"] == "loc"
    assert float(rows[0]["end"]) > float(rows[0]["start"])
    with pytest.raises(ValueError):
        DBTracer(str(tmp_path / "x"), backend="parquet")


def test_backtrace_renders_chain(capsys):
    dom = TracingDomain("t", time_fn=_clock())
    with pytest.raises(RuntimeError):
        with dom.task("inst", "load", "Core3"):
            with dom.task("translation", "vaddr", "MMU"):
                raise RuntimeError("boom")
    out = capsys.readouterr().out
    assert "@Core3, inst, load" in out
    assert "@MMU, translation, vaddr" in out
    assert format_backtrace(header="Panic: x", chain=[]).startswith("Panic")


def test_flush_engine_trace_rows_equal_jax(tmp_path):
    """flush_engine_trace on the same memsys run in both packages writes
    the same busy counters and sampled buffer levels."""
    kw = dict(n_cores=3, pattern="mixed", n_reqs=8, sample_period=8.0)
    rows = {}
    for pkg, DB, flush in (("jax", jtr.DBTracer, jtr.flush_engine_trace),
                           ("torch", DBTracer, flush_engine_trace)):
        sim, st = _build(pkg, **kw)
        final = sim.run(st, until=5000.0)
        db = DB(str(tmp_path / f"{pkg}.db"))
        flush(sim, final, db)
        rows[pkg] = (db.fetch_metrics("busy_ticks"),
                     db.fetch_metrics("buf_level"))
        db.close()
    assert rows["torch"] == rows["jax"]
    busy, levels = rows["torch"]
    assert len(busy) == 3 * 2 + 1 and any(v > 0 for *_, v in busy)
    assert levels and min(t for _, _, t, _ in levels) == 8.0


# ---------------------------------------------------------------------------
# Daisen (tests/core/test_daisen_escape.py)
# ---------------------------------------------------------------------------
def _task(**kw):
    base = dict(id="t1", parent_id="", category="c", action="a",
                location="loc", start=0.0, end=1.0)
    base.update(kw)
    return Task(**base)


def test_embed_json_neutralizes_markup():
    s = daisen._embed_json({"x": "</script><script>alert(1)</script>"})
    assert "</script>" not in s and "<" not in s and ">" not in s
    assert json.loads(s) == {"x": "</script><script>alert(1)</script>"}
    assert "&" not in daisen._embed_json({"x": "a&b"})
    assert json.loads(daisen._embed_json({"x": "a&b"})) == {"x": "a&b"}


def test_export_html_with_hostile_strings_equals_jax(tmp_path):
    evil = "</script><script>alert('xss')</script>"
    rows = [dict(id="t1", category=evil, action="a", location="core0"),
            dict(id="t2", category="c", action=evil, location="core0",
                 start=1.0, end=2.0),
            dict(id="t3", category="c", action="a", location=evil,
                 start=2.0, end=3.0, tags=[evil]),
            dict(id="t4", category="__TASKS__", action="__TITLE__",
                 start=3.0, end=None)]
    out = daisen.export_html([_task(**r) for r in rows],
                             str(tmp_path / "t.html"),
                             title="run " + evil + " __TASKS__")
    ref = jdaisen.export_html(
        [jtracing.Task(**dict(dict(id="t1", parent_id="", category="c",
                                   action="a", location="loc", start=0.0,
                                   end=1.0), **r)) for r in rows],
        str(tmp_path / "j.html"), title="run " + evil + " __TASKS__")
    doc = open(out).read()
    assert doc == open(ref).read()
    assert doc.count("</script>") == 1 and doc.count("<script>") == 1
    payload = doc.split("const TASKS = ", 1)[1].split(";\n", 1)[0]
    got = json.loads(payload)
    assert got[0]["category"] == evil and got[2]["tags"] == [evil]
    assert got[3]["category"] == "__TASKS__" and got[3]["end"] == 3.0
    assert "&lt;script&gt;" in doc


def test_db_tracer_and_daisen_export(tmp_path):
    dom = TracingDomain("t", time_fn=_clock())
    db = dom.attach(DBTracer(str(tmp_path / "trace.db"), run_id="r1"))
    with dom.task("step", "train", "loop"):
        with dom.task("mem", "read", "l1"):
            pass
    db.flush()
    tasks = db.fetch_tasks()
    assert len(tasks) == 2
    child = [t for t in tasks if t.category == "mem"][0]
    parent = [t for t in tasks if t.category == "step"][0]
    assert child.parent_id == parent.id
    html = open(daisen.export_db(db, str(tmp_path / "trace.html"))).read()
    assert "Daisen-lite" in html and "l1" in html
    db.close()


# ---------------------------------------------------------------------------
# the monitor against the JAX monitor
# ---------------------------------------------------------------------------
def test_run_monitored_history_and_state_equal_jax():
    kw = dict(n_cores=4, pattern="mixed", n_reqs=16, sample_period=16.0)
    mons = {}
    for pkg, M in (("jax", jmon.Monitor), ("torch", Monitor)):
        sim, st = _build(pkg, **kw)
        mons[pkg] = M(sim, st)
        final, hung = mons[pkg].run_monitored(until=5000.0, chunk=500.0,
                                              verbose=False)
        assert not hung
    assert mons["torch"].history == mons["jax"].history
    assert_same_state(mons["torch"].state, mons["jax"].state)
    sim = mons["torch"].sim
    assert tm.finish_stats(sim, mons["torch"].state)["remaining"] == 0
    assert mons["torch"].bottleneck_report() == []


def test_mid_run_reports_inspect_and_force_tick_equal_jax():
    out = {}
    for pkg, M in (("jax", jmon.Monitor), ("torch", Monitor)):
        sim, st = _build(pkg, n_cores=4, pattern="stream", n_reqs=8)
        mon = M(sim, st)
        mon.state = sim.run(st, until=45.0)
        rep = mon.bottleneck_report(top=50)
        ins = [mon.inspect(k.name, i) for k in sim.kinds
               for i in range(k.n_instances)]
        stat = mon.force_tick("core", 1)
        out[pkg] = (mon.status(), rep, ins, stat, mon.state)
    t, j = out["torch"], out["jax"]
    assert t[:4] == j[:4]
    assert t[1], "nothing was in flight at the mid-run horizon"
    assert "remaining" in t[2][0] and t[3]["epochs"] >= 1
    assert_same_state(t[4], j[4])


def _hang_kit(core):
    i32 = (lambda x: jnp.full(1, x, jnp.int32)) if core is J else \
        (lambda x: torch.full((1,), x, dtype=torch.int32))
    cast = (lambda b: b.astype(jnp.int32)) if core is J else \
        (lambda b: b.to(torch.int32))

    def stuck_tick(state, ports, t):
        return state, ports, core.TickResult.make(False)

    def spammer_tick(state, ports, t):
        ports, ok = ports.send(0, core.msg_new(1), when=state["n"] > 0)
        return {"n": state["n"] - cast(ok)}, ports, core.TickResult.make(ok)

    b = core.SimBuilder()
    sp = b.add_kind(core.ComponentKind("spam", spammer_tick, 1, 1,
                                       {"n": i32(8)}, cap=1))
    stk = b.add_kind(core.ComponentKind("stuck", stuck_tick, 1, 1,
                                        {"_": i32(0)}, cap=1))
    b.connect([sp.port(0, 0), stk.port(0, 0)], latency=1.0)
    return b.build(**({} if core is J else {"device": "cpu"}))


def test_monitor_detects_hang_like_jax(capsys):
    res = {}
    for core, M in ((J, jmon.Monitor), (T, Monitor)):
        sim = _hang_kit(core)
        mon = M(sim, sim.init_state())
        _, hung = mon.run_monitored(until=10000.0, chunk=100.0,
                                    hang_chunks=2, verbose=True)
        assert hung
        res[core] = (mon.history, mon.bottleneck_report(),
                     capsys.readouterr().out)
    assert res[T] == res[J]
    assert any("stuck" in r["port"] and r["stalled_consumer"]
               for r in res[T][1])
    assert "HANG detected" in res[T][2]


# ---------------------------------------------------------------------------
# HTTP endpoint (tests/core/test_monitor_http.py)
# ---------------------------------------------------------------------------
def _get(port, path):
    with urllib.request.urlopen(
            f"http://127.0.0.1:{port}{path}", timeout=5) as r:
        return json.loads(r.read().decode())


@pytest.fixture
def mon():
    sim, st = _build("torch", n_cores=2, pattern="mixed", n_reqs=4)
    m = Monitor(sim, st, http_port=0)
    yield m
    m.shutdown()


def test_http_status_and_bottlenecks(mon):
    assert mon.http_port and mon.http_port > 0
    stat = _get(mon.http_port, "/status")
    for key in ("virtual_time", "epochs", "ticks", "progress_ratio",
                "pending_messages"):
        assert key in stat, key
    assert _get(mon.http_port, "/bottlenecks") == []   # nothing ran yet
    mon.state = mon.sim.run(mon.state, until=5.0)
    stat = _get(mon.http_port, "/status")
    assert stat["epochs"] > 0 and stat == mon.status()
    assert _get(mon.http_port, "/bottlenecks") == mon.bottleneck_report()


def test_http_serves_snapshots_while_a_run_is_monitored(mon):
    """The endpoint answers from the snapshot taken on the main thread;
    a poller mid-run always gets well-formed JSON, and the last snapshot
    is the final status."""
    got, stop = [], threading.Event()

    def poll():
        while not stop.is_set():
            got.append((_get(mon.http_port, "/status"),
                        _get(mon.http_port, "/bottlenecks")))

    th = threading.Thread(target=poll)
    th.start()
    try:
        mon.run_monitored(until=2000.0, chunk=50.0, verbose=False)
    finally:
        stop.set()
        th.join(timeout=10)
    assert not th.is_alive() and got
    assert all("epochs" in s and isinstance(b, list) for s, b in got)
    assert _get(mon.http_port, "/status") == mon.history[-1]


def test_port_in_use_falls_back_to_ephemeral(mon):
    sim, st = _build("torch", n_cores=2, pattern="mixed", n_reqs=4)
    m2 = Monitor(sim, st, http_port=mon.http_port)
    try:
        assert m2.http_port is not None
        assert m2.http_port != mon.http_port
        assert m2._httpd.requested_port == mon.http_port
        assert "virtual_time" in _get(m2.http_port, "/status")
        assert "virtual_time" in _get(mon.http_port, "/status")
    finally:
        m2.shutdown()


def test_shutdown_releases_port_and_is_idempotent(mon):
    port = mon.http_port
    mon.shutdown()
    assert mon.http_port is None and mon._httpd is None
    with pytest.raises((urllib.error.URLError, OSError)):
        urllib.request.urlopen(f"http://127.0.0.1:{port}/status", timeout=1)
    mon.shutdown()
    mon.close()


def test_monitor_without_http_shutdown_is_safe():
    sim, st = _build("torch", n_cores=2, pattern="mixed", n_reqs=4)
    m = Monitor(sim, st)
    assert m.http_port is None
    m.shutdown()


def test_endpoint_ephemeral_rebind_reuses_handler():
    from http.server import BaseHTTPRequestHandler

    class H(BaseHTTPRequestHandler):
        def do_GET(self):
            body = b'{"ok": true}'
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):
            pass

    a = HttpEndpoint(H, port=0)
    try:
        b = HttpEndpoint(H, port=a.port)
        try:
            assert b.port != a.port and b.requested_port == a.port
            assert b.url.endswith(str(b.port))
            assert _get(b.port, "/")["ok"] is True
        finally:
            b.shutdown()
    finally:
        a.shutdown()


def test_monitor_ref_is_the_jax_package_result():
    """``chip_smoke.MONITOR_REF``, made again from the JAX monitor."""
    cs = chip_smoke()
    run = cs.MONITOR_RUN
    sim, st = jm.build(n_cores=run["n_cores"], pattern=run["pattern"],
                       n_reqs=run["n_reqs"],
                       sample_period=run["sample_period"])
    mon = jmon.Monitor(sim, st)
    final, hung = mon.run_monitored(until=run["until"], chunk=run["chunk"],
                                    verbose=False)
    got = dict(jm.finish_stats(sim, final),
               progress_ticks=int(final.stats.progress_ticks),
               sample_idx=int(final.sample_idx),
               buf_samples_sum=int(np.asarray(final.buf_samples).sum()),
               chunks=len(mon.history), hung=hung)
    assert got == cs.MONITOR_REF
