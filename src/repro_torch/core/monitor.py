"""AkitaRTM-lite: real-time monitoring of running simulations (paper §3.5).
Counterpart of ``repro.core.monitor``.

The browser dashboard is replaced by a terminal/JSON dashboard plus an
optional stdlib HTTP endpoint (AkitaRTM "spawns a server when any Akita-based
simulation starts"); the *data model* is the same:

* simulation progress (virtual time, epochs, ticks, progress ratio);
* component inspection (read any component's state fields live);
* buffer-level **bottleneck analyzer** — in a successful simulation all
  buffers drain; persistently non-empty buffers mark the stalled consumer
  (paper's hang-diagnosis recipe);
* **hang detection** — virtual time advancing with no progress ticks, or no
  events left before the horizon;
* ``force_tick`` — force-trigger a component's tick (the paper's breakpoint
  debugging aid).

Implementation: the monitor runs the simulation in host-side chunks
(``run(until=t+chunk)``); between chunks the state is inspected.  This is
the chunked analogue of RTM sampling a live Go process.

The HTTP thread never reads the simulation's tensors.  With an endpoint
on, every assignment to :attr:`Monitor.state` (on the caller's thread)
refreshes a snapshot of :meth:`Monitor.status` and
:meth:`Monitor.bottleneck_report`, and the endpoint serves that snapshot:
a read of device memory from another thread would wait on, or break, the
CUDA graph the main thread is replaying or capturing.
"""
from __future__ import annotations

import dataclasses
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import torch

from .engine import tree_leaves


class _Server(ThreadingHTTPServer):
    # SSE clients (repro_torch.obs.dashboard) hold their handler thread
    # open for the stream's lifetime; shutdown must not wait on them.
    daemon_threads = True
    block_on_close = False


class HttpEndpoint:
    """A stdlib threaded HTTP server with ephemeral-port fallback and a
    clean ``shutdown()`` — the serving half shared by :class:`Monitor`
    (AkitaRTM-lite) and the campaign dashboard
    (:mod:`repro_torch.obs.dashboard`).

    ``port`` is a *request*: when it is already bound (two monitored
    sims in one CI job, a stale server from a previous run) the endpoint
    falls back to an OS-assigned ephemeral port instead of crashing the
    simulation it is observing.  The actually-bound port is on
    ``self.port``; callers report it instead of assuming.
    """

    def __init__(self, handler_cls, port: int = 0,
                 host: str = "127.0.0.1"):
        try:
            self.httpd = _Server((host, int(port)), handler_cls)
        except OSError:
            if int(port) == 0:
                raise               # ephemeral bind failing is terminal
            self.httpd = _Server((host, 0), handler_cls)
        self.host = host
        self.port = int(self.httpd.server_address[1])
        self.requested_port = int(port)
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True)
        self._thread.start()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def shutdown(self) -> None:
        """Stop serving and release the socket (idempotent)."""
        if self.httpd is not None:
            self.httpd.shutdown()
            self.httpd.server_close()
            self._thread.join(timeout=5)
            self.httpd = None


class Monitor:
    def __init__(self, sim, state, domain=None, http_port: int | None = None):
        self.sim = sim
        self.domain = domain
        self.history: list[dict] = []
        self._httpd: HttpEndpoint | None = None
        self.http_port: int | None = None
        # what the HTTP thread serves; replaced whole, never mutated
        self._snapshot = {"status": {}, "bottlenecks": []}
        self.state = state
        if http_port is not None:
            self._serve(http_port)

    @property
    def state(self):
        return self._state

    @state.setter
    def state(self, s):
        self._state = s
        if self._httpd is not None:
            self._refresh_snapshot()

    def _refresh_snapshot(self):
        self._snapshot = {"status": self.status(),
                          "bottlenecks": self.bottleneck_report()}

    # ------------------------------------------------------------------
    def status(self) -> dict:
        s = self.state
        st = s.stats
        ticks = int(st.ticks)
        return {
            "virtual_time": float(s.time),
            "epochs": int(st.epochs),
            "ticks": ticks,
            "progress_ticks": int(st.progress_ticks),
            "progress_ratio": float(int(st.progress_ticks) / max(ticks, 1)),
            "delivered": int(st.delivered),
            "pending_messages": int(torch.sum(self.sim.flat_in_cnt(s))
                                    + torch.sum(self.sim.flat_out_cnt(s))),
        }

    def inspect(self, kind: str, inst: int) -> dict:
        """Live component state inspection (RTM's component detail view)."""
        tree = self.state.comp_state[kind]
        if isinstance(tree, dict):
            return {k: v[inst].cpu().tolist() for k, v in tree.items()}
        return {f"leaf{i}": v[inst].cpu().tolist()
                for i, v in enumerate(tree_leaves(tree))}

    def bottleneck_report(self, top: int = 5) -> list[dict]:
        """Fullest buffers first — the RTM Bottleneck Analyzer."""
        s = self.state
        in_cnt = self.sim.flat_in_cnt(s).cpu().numpy()
        out_cnt = self.sim.flat_out_cnt(s).cpu().numpy()
        rows = []
        for ki, k in enumerate(self.sim.kinds):
            pb = self.sim.port_base[ki]
            for inst in range(k.n_instances):
                for p in range(k.n_ports):
                    g = pb + inst * k.n_ports + p
                    if in_cnt[g] or out_cnt[g]:
                        rows.append({
                            "port": f"{k.name}[{inst}].p{p}",
                            "in_level": int(in_cnt[g]),
                            "out_level": int(out_cnt[g]),
                            "stalled_consumer": bool(in_cnt[g] > 0),
                        })
        rows.sort(key=lambda r: -(r["in_level"] + r["out_level"]))
        return rows[:top]

    def force_tick(self, kind: str, inst: int):
        """Force-trigger a tick on a suspect component (paper §3.5)."""
        cid = self.sim.comp_id(kind, inst)
        next_tick = self.state.next_tick.clone()
        next_tick[cid] = self.state.time
        self.state = dataclasses.replace(self.state, next_tick=next_tick)
        self.state = self.sim.run(self.state, until=float(self.state.time))
        return self.status()

    # ------------------------------------------------------------------
    def run_monitored(self, until: float, chunk: float = 1000.0,
                      hang_chunks: int = 3, verbose: bool = True):
        """Run to ``until`` in chunks, reporting progress and detecting hangs.

        Returns (final_state, hang_detected).
        """
        stall = 0
        last_prog = -1
        t = float(self.state.time)
        while t < until:
            t = min(t + chunk, until)
            tk = (self.domain.start_task("monitor", "chunk", "engine")
                  if self.domain else None)
            self.state = self.sim.run(self.state, until=t)
            if tk:
                self.domain.end_task(tk)
            stat = self.status()
            self.history.append(stat)
            if verbose:
                print(f"[RTM] vt={stat['virtual_time']:>10.1f} "
                      f"epochs={stat['epochs']:>8d} "
                      f"progress={stat['progress_ratio']:.2f} "
                      f"pending={stat['pending_messages']}")
            prog = stat["progress_ticks"]
            if prog == last_prog and stat["pending_messages"] > 0:
                stall += 1
                if stall >= hang_chunks:
                    if verbose:
                        print("[RTM] HANG detected — bottleneck analysis:")
                        for row in self.bottleneck_report():
                            print("   ", row)
                    return self.state, True
            else:
                stall = 0
            last_prog = prog
            if stat["pending_messages"] == 0 and \
                    float(self.state.time) >= until:
                break
        return self.state, False

    # ------------------------------------------------------------------
    def _serve(self, port: int):
        """Optional stdlib HTTP endpoint: GET /status, /bottlenecks.

        ``port`` is a request — if it is already in use the monitor
        serves on an ephemeral port instead of crashing; the bound port
        is on ``self.http_port``.
        """
        mon = self

        class H(BaseHTTPRequestHandler):
            def do_GET(self):
                snap = mon._snapshot
                body = (snap["status"] if self.path != "/bottlenecks"
                        else snap["bottlenecks"])
                body = json.dumps(body).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):
                pass

        self._refresh_snapshot()
        self._httpd = HttpEndpoint(H, port=port)
        self.http_port = self._httpd.port

    def shutdown(self):
        """Stop the HTTP endpoint and release its socket (idempotent;
        safe to call when no endpoint was started)."""
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd = None
            self.http_port = None

    # backwards-compatible alias
    def close(self):
        self.shutdown()
