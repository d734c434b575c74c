"""The port's campaign telemetry (``repro_torch.obs``): sinks, the bridge,
the Perfetto and campaign-HTML exports and the dashboard, mirroring
tests/obs/test_bus.py, test_perfetto.py and the parts of
test_dashboard.py that need no search or mux.  The exports of the same
event stream equal the JAX package's, and a small port sweep gives the
same rows with telemetry on and off."""
import http.client
import json
import threading
import urllib.error
import urllib.request

import pytest

import repro.obs as J
import repro_torch.obs as O
import repro_torch.sims.memsys as tm
from repro_torch import dse
from repro_torch.core.tracing import TracingDomain


def _validate_chrome_trace(trace):
    """The trace-event-format invariants Perfetto's importer relies on."""
    assert isinstance(trace, dict)
    evs = trace["traceEvents"]
    assert isinstance(evs, list) and evs
    for ev in evs:
        assert isinstance(ev["ph"], str) and ev["ph"] in "XiCM", ev
        assert isinstance(ev["name"], str) and ev["name"]
        assert isinstance(ev["pid"], int) and isinstance(ev["tid"], int)
        assert isinstance(ev["ts"], (int, float)) and ev["ts"] >= 0
        if ev["ph"] == "X":
            assert ev["dur"] >= 0, ev
        if ev["ph"] == "i":
            assert ev["s"] in ("g", "p", "t")
        if ev["ph"] == "M":
            assert ev["name"] in ("process_name", "thread_name")
            assert "name" in ev["args"]
        if "args" in ev:
            json.dumps(ev["args"])
    return evs


def _build():
    return tm.build(n_cores=3, pattern="mixed", n_reqs=6, device="cpu")


SPEC = {"conn_latency[-1]": [10.0, 20.0, 30.0],
        "kind.l1.extra_hit_rate": [0.0, 0.8]}


@pytest.fixture(scope="module")
def campaign(tmp_path_factory):
    """A port sweep captured to memory and to a JSONL log, its rows, and
    the rows of the same sweep with telemetry off."""
    bf = dse.memoize_build(_build)
    spec = dse.SweepSpec.grid(SPEC)
    kw = dict(until=400.0, chunk=4)
    seq0 = O.BUS.seq
    rows_off = dse.run_sweep(bf, spec, **kw)
    assert O.BUS.seq == seq0          # disabled: zero events materialized
    path = tmp_path_factory.mktemp("obs") / "campaign.jsonl"
    sink = O.BUS.attach(O.JsonlSink(str(path)))
    try:
        with O.capture() as mem:
            rows_on = dse.run_sweep(bf, spec, **kw)
    finally:
        O.BUS.detach(sink)
        sink.close()
    return mem.events, str(path), rows_off, rows_on


# events the port's runner does not emit yet (search, halving, checkpoints)
SYNTHETIC = [
    {"kind": "search.start", "ts": 10.0, "seq": 0, "driver": "X",
     "objective": ["o"], "cycle_budget": 5000.0},
    {"kind": "search.ask", "ts": 10.5, "seq": 1, "round": 0, "n": 4},
    {"kind": "trial", "ts": 10.7, "seq": 2, "point": {"a": 1}},
    {"kind": "search.tell", "ts": 11.0, "seq": 3, "round": 0, "n": 4,
     "budget": 800.0, "best": {"a": 1}},
    {"kind": "rung.promote", "ts": 11.1, "seq": 4, "bracket": 1,
     "rung": 0, "horizon": 60.0, "promoted": 1, "dropped": 3,
     "warm": True, "spent": 240.0, "replay_cycles": 0.0},
    {"kind": "ckpt.save", "ts": 11.4, "seq": 5, "dur": 0.2, "path": "p"},
    {"kind": "search.end", "ts": 12.0, "seq": 6, "best": {"a": 1}},
]


# ---------------------------------------------------------------------------
# sinks (tests/obs/test_bus.py)
# ---------------------------------------------------------------------------
def test_capture_uses_the_sinks_module_memory_sink():
    assert not O.BUS.active
    with O.capture() as sink:
        assert isinstance(sink, O.MemorySink) and O.BUS.active
        O.BUS.emit("inside", x=1)
    assert not O.BUS.active
    assert sink.kinds() == ["inside"] and sink.of("inside")[0]["x"] == 1
    import repro_torch.obs.bus as bus
    assert not hasattr(bus, "MemorySink")


def test_callback_sink_and_thread_safe_emit():
    bus, got = O.Bus(), []
    bus.attach(O.CallbackSink(got.append))
    threads = [threading.Thread(target=lambda: [bus.emit("k")
                                                for _ in range(200)])
               for _ in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=10)
    assert not any(th.is_alive() for th in threads)
    assert sorted(e["seq"] for e in got) == list(range(800))


def test_jsonl_round_trip(tmp_path):
    path = tmp_path / "events.jsonl"
    bus = O.Bus()
    sink = bus.attach(O.JsonlSink(str(path)))
    bus.emit("round.end", round=0, dur=0.25, frozen_ids=[1, 2])
    bus.emit("search.tell", round=0, budget=123.5)
    sink.close()
    header = json.loads(path.read_text().splitlines()[0])
    assert header["kind"] == "obs.meta"
    assert header["v"] == O.SCHEMA_VERSION == J.SCHEMA_VERSION
    events = O.read_jsonl(str(path))
    assert [e["kind"] for e in events] == ["round.end", "search.tell"]
    assert events[0]["frozen_ids"] == [1, 2]
    assert events[1]["budget"] == 123.5
    assert J.read_jsonl(str(path)) == events        # the reference reads it


def test_jsonl_unjsonable_payload_degrades_to_repr(tmp_path):
    path = tmp_path / "e.jsonl"
    bus = O.Bus()
    sink = bus.attach(O.JsonlSink(str(path)))
    bus.emit("k", weird=object())
    sink.close()
    (ev,) = O.read_jsonl(str(path))
    assert ev["kind"] == "k" and "object" in ev["weird"]


def test_jsonl_tolerates_torn_tail(tmp_path):
    path = tmp_path / "e.jsonl"
    bus = O.Bus()
    sink = bus.attach(O.JsonlSink(str(path), flush_every=100))
    bus.emit("ok")
    sink.flush()
    with open(path, "a") as fh:
        fh.write('\n\n{"kind": "torn", "half')    # live log mid-write
    assert [e["kind"] for e in O.read_jsonl(str(path))] == ["ok"]
    sink.close()
    sink.close()                                   # idempotent


def test_jsonl_version_check(tmp_path):
    path = tmp_path / "e.jsonl"
    path.write_text('{"kind": "obs.meta", "v": 999}\n{"kind": "x"}\n')
    with pytest.raises(ValueError, match="schema"):
        O.read_jsonl(str(path))
    assert [e["kind"] for e in O.read_jsonl(
        str(path), require_version=False)] == ["x"]
    (tmp_path / "none.jsonl").write_text('{"kind": "x"}\n')
    with pytest.raises(ValueError, match="header"):
        O.read_jsonl(str(tmp_path / "none.jsonl"))


# ---------------------------------------------------------------------------
# a port sweep on the bus
# ---------------------------------------------------------------------------
def test_telemetry_on_and_off_give_identical_rows(campaign):
    events, path, rows_off, rows_on = campaign
    assert rows_on == rows_off and len(rows_on) == 6
    assert [(r["virtual_time"], r["epochs"]) for r in rows_on] == \
        [(r["virtual_time"], r["epochs"]) for r in rows_off]
    kinds = {e["kind"] for e in events}
    assert {"sweep.start", "rounds.start", "round.end", "transfer",
            "sweep.end"} <= kinds
    assert O.read_jsonl(path) == events


def test_campaign_trace_validates_and_covers_activity(campaign):
    events, path, _, _ = campaign
    evs = _validate_chrome_trace(O.to_chrome_trace(events))
    procs = {e["args"]["name"] for e in evs
             if e["ph"] == "M" and e["name"] == "process_name"}
    assert procs == {"dse-campaign"}
    tracks = {e["args"]["name"] for e in evs
              if e["ph"] == "M" and e["name"] == "thread_name"}
    assert {"rounds", "compile", "transfer"} <= tracks
    names = [e["name"] for e in evs]
    assert any(n.startswith("round ") for n in names)
    assert any(n.startswith("transfer:") for n in names)
    assert "lanes" in {e["name"] for e in evs if e["ph"] == "C"}


@pytest.mark.parametrize("which", ["campaign", "synthetic"])
def test_exports_equal_jax(campaign, tmp_path, which):
    """The same event stream (the port sweep's, or the search, halving
    and checkpoint events the port does not emit yet) gives the JAX
    package's Chrome trace, Daisen tasks and campaign HTML."""
    events = campaign[0] if which == "campaign" else SYNTHETIC
    evs = _validate_chrome_trace(O.to_chrome_trace(events))
    assert O.to_chrome_trace(events) == J.to_chrome_trace(events)
    mine, ref = O.campaign_tasks(events), J.campaign_tasks(events)
    assert [t.row() for t in mine] == [t.row() for t in ref]
    a = O.export_campaign_html(events, str(tmp_path / "a.html"), title="c")
    b = J.export_campaign_html(events, str(tmp_path / "b.html"), title="c")
    assert open(a).read() == open(b).read()
    if which == "synthetic":
        assert {"budget"} <= {e["name"] for e in evs if e["ph"] == "C"}
        s = [e for e in evs if e["name"].startswith("search round")]
        assert s and s[0]["dur"] > 0 and "budget" in s[0]["args"]
        assert any("promote" in e["name"] for e in evs)
        assert any(e["name"] == "ckpt.save" for e in evs)


def test_export_accepts_jsonl_path(campaign, tmp_path):
    events, path, _, _ = campaign
    out = O.export_chrome_trace(path, str(tmp_path / "trace.json"))
    with open(out) as fh:
        trace = json.load(fh)
    _validate_chrome_trace(trace)
    assert [e["name"] for e in trace["traceEvents"]] == \
        [e["name"] for e in O.to_chrome_trace(events)["traceEvents"]]
    tasks = O.campaign_tasks(path)
    assert tasks and min(t.start for t in tasks) >= 0.0
    assert all(t.end >= t.start for t in tasks)
    assert {"rounds", "transfer"} <= {t.location for t in tasks}
    doc = open(O.export_campaign_html(path, str(tmp_path / "c.html"),
                                      title="sweep campaign")).read()
    assert "Daisen-lite" in doc and "sweep campaign" in doc


def test_engine_task_bridge_lands_in_engine_process():
    bus = O.Bus()
    dom = TracingDomain("engine")
    tracer = O.bridge_domain(dom, bus=bus, clock="virtual")
    with O.capture(bus) as mem:
        with dom.task("inst", "load", "Core0"):
            dom.tag_task("hit")
            with dom.task("mem", "read", "L1[0]"):
                pass
    dom.detach(tracer)
    tasks = mem.of("task")
    assert len(tasks) == 2 and all(t["clock"] == "virtual" for t in tasks)
    child = [t for t in tasks if t["location"] == "L1[0]"][0]
    parent = [t for t in tasks if t["location"] == "Core0"][0]
    assert child["parent_id"] == parent["id"]
    assert parent["tags"] == ["hit"] and bus.metrics.snapshot()["tag.hit"]
    evs = _validate_chrome_trace(O.to_chrome_trace(mem.events))
    engine = [e for e in evs if e["pid"] == 2 and e["ph"] == "X"]
    assert {e["name"] for e in engine} == {"inst/load", "mem/read"}
    assert len({e["tid"] for e in engine}) == 2
    with pytest.raises(AssertionError):
        O.BusTracer(bus, clock="sideways")


def test_bridge_is_inert_without_sinks():
    bus = O.Bus()
    dom = TracingDomain("engine")
    O.bridge_domain(dom, bus=bus)
    with dom.task("a", "b", "c"):
        pass
    assert bus.seq == 0


# ---------------------------------------------------------------------------
# dashboard (tests/obs/test_dashboard.py)
# ---------------------------------------------------------------------------
def _get(port, path):
    with urllib.request.urlopen(
            f"http://127.0.0.1:{port}{path}", timeout=5) as r:
        return r.status, json.loads(r.read().decode())


def _drop_clock(snap):
    return {k: v for k, v in snap.items()
            if k not in ("started", "updated", "uptime")}


def test_stats_aggregation_equals_jax(campaign):
    """The snapshot of the port sweep's events and of the synthetic
    search, cache and shard events equals the JAX aggregator's."""
    cache = [
        {"kind": "cache.enable", "ts": 1.0, "seq": 0, "dir": "/c"},
        {"kind": "cache.miss", "ts": 1.1, "seq": 1, "bytes": 0},
        {"kind": "cache.write", "ts": 1.2, "seq": 2, "bytes": 11},
        {"kind": "cache.hit", "ts": 1.3, "seq": 3, "bytes": 11},
        {"kind": "cache.evict", "ts": 1.35, "seq": 4, "bytes": 5},
        {"kind": "shard.rebalance", "ts": 2.0, "seq": 5, "shards": 2,
         "moved": 5},
        {"kind": "mux.start", "ts": 2.1, "seq": 6, "jobs": ["a", "b"]},
        {"kind": "totally.new", "ts": 2.2, "seq": 7}]
    for events in (campaign[0], SYNTHETIC, cache):
        mine, ref = O.CampaignStats(), J.CampaignStats()
        for ev in events:
            mine.on_event(ev)
            ref.on_event(ev)
        assert _drop_clock(mine.snapshot()) == _drop_clock(ref.snapshot())
    snap = mine.snapshot()
    assert snap["cache"]["hit_rate"] == pytest.approx(0.5)
    assert snap["shards"] == {"devices": 2, "rebalances": 1,
                              "lanes_moved": 5}
    assert snap["events"] == 8


def test_campaign_endpoint_reports_a_live_sweep():
    bus = O.Bus()
    srv = O.CampaignServer(bus=bus, port=0)
    try:
        bus.emit("rounds.start", B=6, ladder=[4], quantum=64, shard=1,
                 pipeline=2)
        bus.emit("round.end", round=0, rung=4, epochs=40, survivors=3,
                 pending=2, pool=6, dur=0.1, host_s=0.01, wait_s=0.05)
        code, snap = _get(srv.port, "/campaign")
        assert code == 200 and snap["rounds_drained"] == 1
        assert snap["lanes"] == {"live": 3, "pending": 2, "pool": 6}
        assert snap["pipeline"]["depth"] == 2
        assert snap["round_timeline"][0]["rung"] == 4
        bus.emit("sweep.end", n_points=6, groups=1, dur=0.2)
        assert _get(srv.port, "/campaign")[1]["lanes"]["live"] == 0
    finally:
        srv.close()


def test_events_sse_replays_ring():
    bus = O.Bus()
    srv = O.CampaignServer(bus=bus, port=0)
    try:
        bus.emit("round.end", round=0, epochs=4, survivors=1, pending=0,
                 pool=0)
        bus.emit("sweep.end", n_points=1, groups=1, dur=0.1)
        conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=5)
        conn.request("GET", "/events")
        resp = conn.getresponse()
        assert resp.status == 200
        assert resp.getheader("Content-Type") == "text/event-stream"
        got = []
        while len(got) < 2:
            line = resp.fp.readline()
            if line.startswith(b"data: "):
                got.append(json.loads(line[len(b"data: "):]))
        assert [e["kind"] for e in got] == ["round.end", "sweep.end"]
        bus.emit("round.end", round=1, epochs=4, survivors=0, pending=0,
                 pool=0)
        while True:
            line = resp.fp.readline()
            if line.startswith(b"data: "):
                ev = json.loads(line[len(b"data: "):])
                break
        assert ev["kind"] == "round.end" and ev["round"] == 1
        conn.close()
    finally:
        srv.close()


def test_metrics_index_and_404():
    bus = O.Bus()
    srv = O.CampaignServer(bus=bus, port=0)
    try:
        bus.count("dse.rounds", 3)
        code, body = _get(srv.port, "/metrics")
        assert code == 200 and body["dse.rounds"] == 3.0
        with urllib.request.urlopen(srv.url, timeout=5) as r:
            page = r.read().decode()
        assert "campaign" in page and "/campaign" in page
        with pytest.raises(urllib.error.HTTPError) as err:
            _get(srv.port, "/nope")
        assert err.value.code == 404
    finally:
        srv.close()


def test_port_in_use_falls_back_to_ephemeral():
    a = O.CampaignServer(bus=O.Bus(), port=0)
    try:
        b = O.CampaignServer(bus=O.Bus(), port=a.port)
        try:
            assert b.port != a.port
            assert b.endpoint.requested_port == a.port
            assert _get(b.port, "/campaign")[0] == 200
        finally:
            b.close()
    finally:
        a.close()


def test_close_detaches_and_releases():
    bus = O.Bus()
    srv = O.CampaignServer(bus=bus, port=0)
    assert bus.active
    port = srv.port
    srv.close()
    assert not bus.active
    srv.close()
    with pytest.raises(OSError):
        urllib.request.urlopen(f"http://127.0.0.1:{port}/campaign",
                               timeout=1)
