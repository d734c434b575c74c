"""The campaign telemetry bus: ``emit(kind, **fields)`` + a metrics
registry, with pluggable sinks.  A copy of ``repro.obs.bus``;
:func:`capture` takes its sink from :mod:`repro_torch.obs.sinks`.

Akita's tracing story (paper §3.4–3.6) covers a *single engine run*:
``start_task``/``end_task`` annotations flow to tracers, AkitaRTM watches
a live simulation, Daisen renders the trace afterwards.  Everything the
DSE stack does *between* engine runs — rounds, lane compaction, chunk
autotuning, compiles, ask/tell search rounds, rung promotions, budget
spend — happened in the dark.  This module is the campaign-side
counterpart: one process-wide :class:`Bus` that the sweep/search
machinery emits structured events into, and that sinks (JSONL files,
the live ``/campaign`` dashboard, the Perfetto exporter) consume.

Design constraints, in order:

* **Zero-cost when disabled.**  ``Bus.emit`` returns before building the
  event when no sink is attached, and every instrumented call site
  guards payload assembly with ``if BUS.active:`` — a telemetry-off
  sweep materializes *zero* events (the monotonic ``seq`` counter does
  not advance; pinned by ``tests/obs``).
* **Host-side only.**  Emission happens strictly between jitted
  dispatches — never inside a traced function — so telemetry can never
  change compiled programs or results: a telemetry-on sweep's rows are
  bit-identical to a telemetry-off run (gated in ``BENCH_trace.json``).
* **Flat, versioned events.**  An event is a flat dict with three
  reserved keys — ``kind`` (dotted event name), ``ts`` (wall-clock
  epoch seconds), ``seq`` (process-monotonic) — plus event-specific
  fields; completed spans carry ``dur`` (seconds).  The schema version
  (:data:`SCHEMA_VERSION`) rides the JSONL header and the event
  catalogue lives in OBSERVABILITY.md.

Sinks implement a single method ``on_event(ev: dict)`` (and optionally
``close()``); a sink that raises is detached-in-place semantics-free —
the error is recorded on ``Bus.sink_errors`` and the campaign keeps
running (telemetry must never kill the work it watches).
"""
from __future__ import annotations

import contextlib
import threading
import time
from typing import Any

SCHEMA_VERSION = 1

MAX_SINK_ERRORS = 16     # keep the first few, drop the rest


# ---------------------------------------------------------------------------
class Counter:
    """A monotonically increasing count (events seen, trials run)."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        self.value += n


class Gauge:
    """A point-in-time value (live lanes, budget spent)."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Streaming summary of an observed quantity (round durations,
    transfer times): count / total / min / max / last."""

    __slots__ = ("count", "total", "min", "max", "last")

    def __init__(self):
        self.count = 0
        self.total = 0.0
        self.min = float("inf")
        self.max = float("-inf")
        self.last = 0.0

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.total += v
        self.min = v if v < self.min else self.min
        self.max = v if v > self.max else self.max
        self.last = v

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0


class MetricsRegistry:
    """Named counters/gauges/histograms, created on first use.

    One registry rides the bus; ``snapshot()`` renders every metric to a
    JSON-safe dict (what ``/campaign`` serves under ``"metrics"``).
    """

    def __init__(self):
        self._metrics: dict[str, Any] = {}
        self._lock = threading.Lock()

    def _get(self, name: str, cls):
        m = self._metrics.get(name)
        if m is None:
            with self._lock:
                m = self._metrics.setdefault(name, cls())
        if not isinstance(m, cls):
            raise TypeError(f"metric {name!r} is {type(m).__name__}, "
                            f"not {cls.__name__}")
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get(name, Histogram)

    def snapshot(self) -> dict:
        out = {}
        for name, m in sorted(self._metrics.items()):
            if isinstance(m, Histogram):
                out[name] = {"count": m.count, "total": m.total,
                             "mean": m.mean, "last": m.last,
                             "min": None if m.count == 0 else m.min,
                             "max": None if m.count == 0 else m.max}
            else:
                out[name] = m.value
        return out

    def clear(self) -> None:
        with self._lock:
            self._metrics.clear()


# ---------------------------------------------------------------------------
class Bus:
    """The event fan-out: ``emit`` builds one event dict and hands it to
    every attached sink, under a lock (sinks may be mutated from the
    dashboard's HTTP threads)."""

    def __init__(self):
        self._sinks: list = []
        self._emitted = 0
        self._lock = threading.Lock()
        self.metrics = MetricsRegistry()
        self.sink_errors: list[tuple[str, str]] = []

    # -- sink management ----------------------------------------------------
    @property
    def active(self) -> bool:
        """True when at least one sink is attached — the one flag every
        instrumented call site checks before assembling a payload."""
        return bool(self._sinks)

    def attach(self, sink):
        with self._lock:
            self._sinks.append(sink)
        return sink

    def detach(self, sink) -> None:
        with self._lock:
            self._sinks = [s for s in self._sinks if s is not sink]

    @property
    def seq(self) -> int:
        """Events materialized so far (the disabled-path zero-cost pin:
        a telemetry-off run leaves this unchanged)."""
        return self._emitted

    # -- emission -----------------------------------------------------------
    def emit(self, kind: str, **fields) -> dict | None:
        """Materialize and fan out one event; no-op (returns ``None``)
        while no sink is attached."""
        if not self._sinks:
            return None
        with self._lock:
            seq = self._emitted
            self._emitted += 1
        ev = {"kind": kind, "ts": time.time(), "seq": seq}
        ev.update(fields)
        with self._lock:
            sinks = list(self._sinks)
        for s in sinks:
            try:
                s.on_event(ev)
            except Exception as e:   # telemetry never kills the campaign
                if len(self.sink_errors) < MAX_SINK_ERRORS:
                    self.sink_errors.append((type(s).__name__, repr(e)))
        return ev

    @contextlib.contextmanager
    def span(self, kind: str, **fields):
        """Emit ``kind`` as a completed span on exit (``dur`` = wall
        seconds inside the block).  Payload fields may be added by
        mutating the yielded dict."""
        extra: dict = dict(fields)
        t0 = time.perf_counter()
        try:
            yield extra
        finally:
            if self._sinks:
                self.emit(kind, dur=time.perf_counter() - t0, **extra)

    # -- metric sugar (guarded: no-ops while inactive) ----------------------
    def count(self, name: str, n: float = 1.0) -> None:
        if self._sinks:
            self.metrics.counter(name).inc(n)

    def gauge(self, name: str, v: float) -> None:
        if self._sinks:
            self.metrics.gauge(name).set(v)

    def observe(self, name: str, v: float) -> None:
        if self._sinks:
            self.metrics.histogram(name).observe(v)


# The process-wide default bus.  The DSE stack emits here; attach a sink
# (JSONL / dashboard / memory) to switch a campaign's telemetry on.
BUS = Bus()

emit = BUS.emit


def capture(bus: Bus | None = None):
    """Context manager: attach a fresh in-memory sink for the block and
    return it (``with capture() as sink: ... sink.events``)."""
    b = bus if bus is not None else BUS

    from .sinks import MemorySink

    @contextlib.contextmanager
    def _ctx():
        sink = MemorySink()
        b.attach(sink)
        try:
            yield sink
        finally:
            b.detach(sink)

    return _ctx()
