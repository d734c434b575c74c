"""First-party bus sinks: in-memory, append-only JSONL, and callback.

The sink contract (OBSERVABILITY.md) is one method::

    on_event(ev: dict) -> None       # called on the emitting thread
    close() -> None                  # optional; flush + release resources

Sinks must be cheap — they run inline between a campaign's device
dispatches — and must never assume a particular event mix (unknown
``kind``\\ s are normal; the schema grows).  A copy of
``repro.obs.sinks``.
"""
from __future__ import annotations

import json
import os
import sys
import threading
import time
from typing import Callable

from .bus import SCHEMA_VERSION


class MemorySink:
    """Buffers every event in order (tests + ad-hoc analysis)."""

    def __init__(self):
        self.events: list[dict] = []

    def on_event(self, ev: dict) -> None:
        self.events.append(ev)

    def close(self) -> None:
        pass

    def kinds(self) -> list[str]:
        return [e["kind"] for e in self.events]

    def of(self, *kinds: str) -> list[dict]:
        want = set(kinds)
        return [e for e in self.events if e["kind"] in want]


class CallbackSink:
    """Routes every event to a callable (dashboards, tee-ing, filters)."""

    def __init__(self, fn: Callable[[dict], None]):
        self.fn = fn

    def on_event(self, ev: dict) -> None:
        self.fn(ev)

    def close(self) -> None:
        pass


class JsonlSink:
    """Append-only JSONL event log — the campaign's durable artifact.

    Line 1 is a header event carrying the schema version and run
    context (``obs.meta``); every later line is one emitted event,
    verbatim.  The format is deliberately boring: committable, diffable,
    streamable (``tail -f``), and the input both the Perfetto exporter
    and the campaign-HTML renderer accept.

    Non-JSON-safe payload values degrade to ``repr`` instead of killing
    the campaign (the bus would swallow the error, but a half-written
    line would corrupt the log).
    """

    def __init__(self, path: str, flush_every: int = 1):
        self.path = str(path)
        self._fh = open(self.path, "a")
        self._lock = threading.Lock()
        self._n = 0
        self.flush_every = max(1, int(flush_every))
        self._write({"kind": "obs.meta", "v": SCHEMA_VERSION,
                     "ts": time.time(), "pid": os.getpid(),
                     "argv": list(sys.argv)})

    def _write(self, ev: dict) -> None:
        try:
            line = json.dumps(ev, sort_keys=False)
        except (TypeError, ValueError):
            line = json.dumps({k: (v if _jsonable(v) else repr(v))
                               for k, v in ev.items()})
        with self._lock:
            self._fh.write(line + "\n")
            self._n += 1
            if self._n % self.flush_every == 0:
                self._fh.flush()

    def on_event(self, ev: dict) -> None:
        self._write(ev)

    def flush(self) -> None:
        with self._lock:
            self._fh.flush()

    def close(self) -> None:
        with self._lock:
            if not self._fh.closed:
                self._fh.flush()
                self._fh.close()


def _jsonable(v) -> bool:
    try:
        json.dumps(v)
        return True
    except (TypeError, ValueError):
        return False


def read_jsonl(path: str, require_version: bool = True) -> list[dict]:
    """Load an event log written by :class:`JsonlSink`.

    Returns the events *without* the header line; raises ``ValueError``
    on a schema-version mismatch (``require_version=False`` skips the
    check for logs from other producers).  Blank/truncated trailing
    lines are tolerated — a live campaign's log is readable mid-write.
    """
    events: list[dict] = []
    header = None
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                ev = json.loads(line)
            except json.JSONDecodeError:
                continue              # torn tail of a live log
            if header is None and ev.get("kind") == "obs.meta":
                header = ev
                continue
            events.append(ev)
    if require_version:
        if header is None:
            raise ValueError(f"{path}: no obs.meta header line")
        if int(header.get("v", -1)) != SCHEMA_VERSION:
            raise ValueError(
                f"{path}: schema v{header.get('v')} != v{SCHEMA_VERSION}")
    return events
