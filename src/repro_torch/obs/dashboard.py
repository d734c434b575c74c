"""The live campaign dashboard: ``/campaign`` JSON + ``/events`` SSE.

AkitaRTM watches one running simulation (``core/monitor.py``); a DSE
campaign is hundreds of simulations streamed through rounds, and what a
user needs mid-flight is campaign-level state: rounds drained, live and
pending lanes, throughput, budget burn-down, the current best per
objective.  :class:`CampaignServer` attaches to the telemetry bus as a
sink and serves exactly that over the same stdlib HTTP machinery the
monitor uses (:class:`~repro_torch.core.monitor.HttpEndpoint` —
ephemeral-port fallback, clean shutdown):

* ``GET /campaign``  — one JSON snapshot (:meth:`CampaignStats.snapshot`);
* ``GET /events``    — Server-Sent Events: recent-event replay, then the
  live stream as rounds drain (``data:`` lines of schema-v1 events);
* ``GET /metrics``   — the bus metrics registry, rendered to JSON;
* ``GET /``          — a minimal self-refreshing HTML view of /campaign.

Everything is read-only and snapshot-based: HTTP threads never touch
simulation state, so a slow client can never stall a round.  A copy of
``repro.obs.dashboard``.  Its search and mux panels read the events of
``repro_torch.dse.search`` and ``repro_torch.dse.mux``, its cache and
shard panels those of ``repro_torch.dse.cache`` and the sharded lanes
(``shard=``).
"""
from __future__ import annotations

import collections
import json
import queue
import threading
import time

from repro_torch.core.monitor import HttpEndpoint

from .bus import BUS, SCHEMA_VERSION, Bus

_RATE_WINDOW = 32      # events per rate estimate (rounds / tells)


class CampaignStats:
    """Streaming aggregation of bus events into one dashboard snapshot.

    Consumes the sweep/search event catalogue (OBSERVABILITY.md) —
    unknown kinds only bump the event counter, so the aggregator keeps
    working as the schema grows.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self.started = time.time()
        self.updated = self.started
        self.events = 0
        self.rounds = 0
        self.sweeps = 0
        self.lanes = {"live": 0, "pending": 0, "pool": 0}
        self.epochs_total = 0
        self._round_hist = collections.deque(maxlen=_RATE_WINDOW)
        self.compiles = {"count": 0, "dur_total": 0.0}
        self.transfers = {"count": 0, "dur_total": 0.0}
        self.search = {"driver": None, "objective": None, "round": 0,
                       "trials": 0, "budget": 0.0, "cycle_budget": None,
                       "best": None, "done": False}
        self._tell_hist = collections.deque(maxlen=_RATE_WINDOW)
        self.promotions = []           # last few rung.promote payloads
        self.cache = {"hits": 0, "misses": 0, "writes": 0,
                      "bytes_read": 0, "bytes_written": 0,
                      "evictions": 0, "bytes_evicted": 0, "dir": None}
        self.shards = {"devices": 1, "rebalances": 0, "lanes_moved": 0}
        self.pipeline = {"depth": 1, "overlap_frac": None,
                         "host_s_total": 0.0, "wait_s_total": 0.0}
        self.mux = {"runs": 0, "jobs": 0}
        # the round timeline: one compact entry per drained round, the
        # raw material for a per-round occupancy strip chart
        self._timeline = collections.deque(maxlen=120)

    # ------------------------------------------------------------------
    def on_event(self, ev: dict) -> None:
        with self._lock:
            self._update(ev)

    def _update(self, ev: dict) -> None:
        self.events += 1
        self.updated = ev.get("ts", time.time())
        kind = ev.get("kind", "")
        if kind == "round.end":
            self.rounds += 1
            self.lanes = {"live": int(ev.get("survivors", 0)),
                          "pending": int(ev.get("pending", 0)),
                          "pool": int(ev.get("pool", 0))}
            self.epochs_total += int(ev.get("epochs", 0))
            self._round_hist.append((ev["ts"], int(ev.get("epochs", 0))))
            self.pipeline["host_s_total"] += float(ev.get("host_s", 0.0))
            self.pipeline["wait_s_total"] += float(ev.get("wait_s", 0.0))
            if ev.get("overlap_frac") is not None:
                self.pipeline["overlap_frac"] = float(ev["overlap_frac"])
            self._timeline.append(
                {k: ev.get(k) for k in ("round", "rung", "dur", "host_s",
                                        "wait_s", "overlap_frac", "inflight",
                                        "finished", "survivors", "epochs",
                                        "probe", "endgame")})
        elif kind == "sweep.end":
            self.sweeps += 1
            self.lanes = {"live": 0, "pending": 0, "pool": 0}
        elif kind == "compile":
            self.compiles["count"] += int(ev.get("n", 1))
            self.compiles["dur_total"] += float(ev.get("dur", 0.0))
        elif kind == "transfer":
            self.transfers["count"] += 1
            self.transfers["dur_total"] += float(ev.get("dur", 0.0))
        elif kind == "search.start":
            self.search.update(driver=ev.get("driver"),
                               objective=ev.get("objective"),
                               cycle_budget=ev.get("cycle_budget"),
                               done=False)
        elif kind == "search.tell":
            self.search["round"] = int(ev.get("round", 0)) + 1
            self.search["trials"] += int(ev.get("n", 0))
            self.search["budget"] = float(ev.get("budget", 0.0))
            if ev.get("best") is not None:
                self.search["best"] = ev["best"]
            self._tell_hist.append((ev["ts"], self.search["budget"]))
        elif kind == "search.end":
            self.search["done"] = True
            if ev.get("best") is not None:
                self.search["best"] = ev["best"]
        elif kind == "rung.promote":
            self.promotions.append(
                {k: ev.get(k) for k in ("bracket", "rung", "horizon",
                                        "promoted", "dropped", "warm",
                                        "spent", "replay_cycles")})
            del self.promotions[:-8]
        elif kind == "cache.hit":
            self.cache["hits"] += 1
            self.cache["bytes_read"] += int(ev.get("bytes", 0))
        elif kind == "cache.miss":
            self.cache["misses"] += 1
        elif kind == "cache.write":
            self.cache["writes"] += 1
            self.cache["bytes_written"] += int(ev.get("bytes", 0))
        elif kind == "cache.evict":
            self.cache["evictions"] += 1
            self.cache["bytes_evicted"] += int(ev.get("bytes", 0))
        elif kind == "cache.enable":
            self.cache["dir"] = ev.get("dir")
        elif kind == "mux.start":
            self.mux["runs"] += 1
            self.mux["jobs"] += len(ev.get("jobs") or ())
        elif kind == "shard.rebalance":
            self.shards["devices"] = int(ev.get("shards", 1))
            self.shards["rebalances"] += 1
            self.shards["lanes_moved"] += int(ev.get("moved", 0))
        elif kind == "rounds.start":
            self.shards["devices"] = int(ev.get("shard", 1))
            self.pipeline["depth"] = int(ev.get("pipeline", 1))

    @staticmethod
    def _rate(hist) -> float:
        """Units/sec over the recent window of (ts, increment|total)."""
        if len(hist) < 2:
            return 0.0
        dt = hist[-1][0] - hist[0][0]
        return 0.0 if dt <= 0 else sum(v for _, v in list(hist)[1:]) / dt

    def snapshot(self) -> dict:
        with self._lock:
            now = time.time()
            budget = self.search["budget"]
            cap = self.search["cycle_budget"]
            tells = list(self._tell_hist)
            cycles_per_sec = 0.0
            if len(tells) >= 2:
                dt = tells[-1][0] - tells[0][0]
                if dt > 0:
                    cycles_per_sec = (tells[-1][1] - tells[0][1]) / dt
            return {
                "schema": SCHEMA_VERSION,
                "started": self.started,
                "updated": self.updated,
                "uptime": now - self.started,
                "events": self.events,
                "rounds_drained": self.rounds,
                "sweeps": self.sweeps,
                "lanes": dict(self.lanes),
                "epochs": {"total": self.epochs_total,
                           "per_sec": self._rate(self._round_hist)},
                "cycles": {"spent": budget, "cap": cap,
                           "remaining": (None if cap is None
                                         else max(cap - budget, 0.0)),
                           "burn_fraction": (None if not cap
                                             else min(budget / cap, 1.0)),
                           "per_sec": cycles_per_sec},
                "compiles": dict(self.compiles),
                "transfers": dict(self.transfers),
                "cache": dict(
                    self.cache,
                    hit_rate=(self.cache["hits"]
                              / (self.cache["hits"] + self.cache["misses"])
                              if self.cache["hits"] + self.cache["misses"]
                              else None)),
                "shards": dict(self.shards),
                "pipeline": dict(
                    self.pipeline,
                    run_overlap_frac=(
                        self.pipeline["host_s_total"]
                        / (self.pipeline["host_s_total"]
                           + self.pipeline["wait_s_total"])
                        if self.pipeline["host_s_total"]
                        + self.pipeline["wait_s_total"] > 0 else None)),
                "mux": dict(self.mux),
                "round_timeline": list(self._timeline),
                "search": dict(self.search),
                "promotions": list(self.promotions),
            }


_INDEX_HTML = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>campaign</title>
<style>body{font-family:monospace;margin:16px;background:#fafafa}
pre{background:#fff;border:1px solid #ddd;padding:12px}</style></head>
<body><h3>DSE campaign</h3>
<h4>round timeline (recent; # = overlap)</h4><pre id="t">-</pre>
<pre id="s">loading...</pre>
<script>
function bar(f){const n=Math.round((f||0)*20);
  return '#'.repeat(n)+'.'.repeat(20-n);}
function timeline(rows){
  return rows.slice(-24).map(r=>
    `r${String(r.round).padStart(4)} rung=${String(r.rung).padStart(4)} `+
    `${(r.dur||0).toFixed(3)}s host=${(r.host_s||0).toFixed(3)}s `+
    `wait=${(r.wait_s||0).toFixed(3)}s [${bar(r.overlap_frac)}] `+
    `infl=${r.inflight}${r.endgame?' end':''}${r.probe?' probe':''}`
  ).join('\\n')||'-';}
async function tick(){
  try{const r=await fetch('/campaign');const j=await r.json();
      document.getElementById('t').textContent=
        timeline(j.round_timeline||[]);
      document.getElementById('s').textContent=
        JSON.stringify(j,null,2);}catch(e){}
  setTimeout(tick,1000);}
tick();
</script></body></html>
"""


class CampaignServer:
    """Serve live campaign telemetry from a bus over HTTP.

    Attaching the server to a bus is what switches it on — it is itself
    a sink: every event updates :class:`CampaignStats`, lands in a
    bounded replay ring, and is fanned out to connected SSE clients
    through per-client bounded queues (a stalled client drops events,
    it never backpressures the campaign).

    ``port`` is a request; the bound port is on ``self.port``
    (ephemeral fallback — see
    :class:`~repro_torch.core.monitor.HttpEndpoint`).
    """

    def __init__(self, bus: Bus | None = None, port: int = 0,
                 history: int = 512, attach: bool = True):
        self.bus = bus if bus is not None else BUS
        self.stats = CampaignStats()
        self._ring: collections.deque = collections.deque(maxlen=history)
        self._clients: list[queue.Queue] = []
        self._lock = threading.Lock()
        self._closed = threading.Event()
        srv = self

        from http.server import BaseHTTPRequestHandler

        class H(BaseHTTPRequestHandler):
            def _json(self, body, code=200):
                data = json.dumps(body).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                path = self.path.split("?", 1)[0]
                if path == "/campaign":
                    self._json(srv.stats.snapshot())
                elif path == "/metrics":
                    self._json(srv.bus.metrics.snapshot())
                elif path == "/events":
                    self._sse()
                elif path == "/":
                    data = _INDEX_HTML.encode()
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     "text/html; charset=utf-8")
                    self.send_header("Content-Length", str(len(data)))
                    self.end_headers()
                    self.wfile.write(data)
                else:
                    self._json({"error": "not found",
                                "endpoints": ["/", "/campaign", "/events",
                                              "/metrics"]}, code=404)

            def _sse(self):
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Cache-Control", "no-cache")
                self.end_headers()
                q = srv._subscribe()
                try:
                    while not srv._closed.is_set():
                        try:
                            ev = q.get(timeout=0.25)
                        except queue.Empty:
                            self.wfile.write(b": keepalive\n\n")
                            self.wfile.flush()
                            continue
                        self.wfile.write(
                            f"data: {json.dumps(ev)}\n\n".encode())
                        self.wfile.flush()
                except (BrokenPipeError, ConnectionResetError, OSError):
                    pass
                finally:
                    srv._unsubscribe(q)

            def log_message(self, *a):
                pass

        self.endpoint = HttpEndpoint(H, port=port)
        self.port = self.endpoint.port
        self.url = self.endpoint.url
        if attach:
            self.bus.attach(self)

    # -- sink interface -----------------------------------------------------
    def on_event(self, ev: dict) -> None:
        self.stats.on_event(ev)
        with self._lock:
            self._ring.append(ev)
            clients = list(self._clients)
        for q in clients:
            try:
                q.put_nowait(ev)
            except queue.Full:       # stalled client: drop, never block
                pass

    def close(self) -> None:
        self.bus.detach(self)
        self._closed.set()
        self.endpoint.shutdown()

    # -- SSE plumbing -------------------------------------------------------
    def _subscribe(self) -> queue.Queue:
        q: queue.Queue = queue.Queue(maxsize=1024)
        with self._lock:
            for ev in self._ring:    # replay recent history on connect
                try:
                    q.put_nowait(ev)
                except queue.Full:
                    break
            self._clients.append(q)
        return q

    def _unsubscribe(self, q: queue.Queue) -> None:
        with self._lock:
            self._clients = [c for c in self._clients if c is not q]
