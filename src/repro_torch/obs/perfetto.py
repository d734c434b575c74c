"""Post-campaign visualization: Chrome-trace (Perfetto) export and a
Daisen-lite campaign timeline.

:func:`export_chrome_trace` renders a campaign's event stream (a list of
schema-v1 events or a :class:`~repro_torch.obs.sinks.JsonlSink` log path) into
the Chrome trace-event JSON format — load it at https://ui.perfetto.dev
(or ``chrome://tracing``).  Campaign activity maps onto named tracks of
one "campaign" process:

* **rounds**    — one slice per drained round (rung size, live lanes,
  finished/survivor counts, quantum in ``args``);
* **compile**   — retrace/compile occurrences with durations;
* **transfer**  — ``device_get`` pulls (liveness vectors, result rows);
* **search**    — one slice per ask→tell search round, budget in args;
* **bracket b** — rung-promotion instants (promoted/dropped counts,
  warm-vs-cold cost) per halving bracket;
* **checkpoint** — search checkpoint save/load slices;
* counter tracks — ``budget`` (cycles spent) and ``lanes``
  (live/pending), rendered by Perfetto as area charts.

Engine tasks bridged onto the bus (:mod:`repro_torch.obs.bridge`) land in a
second "engine" process with one track per task location — virtual-time
clocks stay separate from the campaign's wall clock instead of being
spliced onto it.

:func:`export_campaign_html` renders the same stream through the
Daisen-lite HTML timeline (:mod:`repro_torch.core.daisen`) — no Perfetto
needed, one self-contained file.  A copy of ``repro.obs.perfetto``.
"""
from __future__ import annotations

import json

from repro_torch.core.daisen import export_html
from repro_torch.core.tracing import Task

from .sinks import read_jsonl

_PID_CAMPAIGN = 1
_PID_ENGINE = 2

_TID_ROUNDS = 1
_TID_COMPILE = 2
_TID_TRANSFER = 3
_TID_SEARCH = 4
_TID_CHECKPOINT = 5
_TID_TRIALS = 6
_TID_BRACKET0 = 16         # bracket b -> tid 16 + b
_TID_ENGINE0 = 1           # engine locations -> tid 1.. in pid 2


def _load(events) -> list[dict]:
    if isinstance(events, (str, bytes)):
        return read_jsonl(events)
    return list(events)


def _meta(pid: int, tid: int | None, name: str) -> dict:
    ev = {"ph": "M", "pid": pid, "ts": 0,
          "name": "thread_name" if tid is not None else "process_name",
          "args": {"name": name}}
    if tid is not None:
        ev["tid"] = tid
    else:
        ev["tid"] = 0
    return ev


def _x(name: str, pid: int, tid: int, start_s: float, dur_s: float,
       args: dict) -> dict:
    return {"ph": "X", "name": name, "pid": pid, "tid": tid,
            "ts": start_s * 1e6, "dur": max(dur_s, 0.0) * 1e6,
            "args": args}


def _instant(name: str, pid: int, tid: int, ts_s: float,
             args: dict) -> dict:
    return {"ph": "i", "s": "t", "name": name, "pid": pid, "tid": tid,
            "ts": ts_s * 1e6, "args": args}


def _counter(name: str, ts_s: float, values: dict) -> dict:
    return {"ph": "C", "name": name, "pid": _PID_CAMPAIGN, "tid": 0,
            "ts": ts_s * 1e6, "args": values}


def _args(ev: dict, skip=("kind", "ts", "seq", "dur")) -> dict:
    return {k: v for k, v in ev.items()
            if k not in skip and _scalarish(v)}


def _scalarish(v) -> bool:
    return isinstance(v, (int, float, str, bool, type(None))) or (
        isinstance(v, (list, tuple)) and len(v) <= 16)


def to_chrome_trace(events) -> dict:
    """Build the trace dict (``{"traceEvents": [...]}``) from a
    schema-v1 event stream."""
    events = _load(events)
    out: list[dict] = [
        _meta(_PID_CAMPAIGN, None, "dse-campaign"),
        _meta(_PID_CAMPAIGN, _TID_ROUNDS, "rounds"),
        _meta(_PID_CAMPAIGN, _TID_COMPILE, "compile"),
        _meta(_PID_CAMPAIGN, _TID_TRANSFER, "transfer"),
        _meta(_PID_CAMPAIGN, _TID_SEARCH, "search"),
        _meta(_PID_CAMPAIGN, _TID_CHECKPOINT, "checkpoint"),
        _meta(_PID_CAMPAIGN, _TID_TRIALS, "trials"),
    ]
    asks: dict[int, dict] = {}          # search round -> ask event
    brackets: set[int] = set()
    engine_tids: dict[str, int] = {}

    for ev in events:
        kind = ev.get("kind", "")
        ts = float(ev.get("ts", 0.0))
        dur = float(ev.get("dur", 0.0))
        if kind == "round.end":
            out.append(_x(f"round {ev.get('round', '?')} "
                          f"(C={ev.get('rung', '?')})",
                          _PID_CAMPAIGN, _TID_ROUNDS, ts - dur, dur,
                          _args(ev)))
            out.append(_counter("lanes", ts,
                                {"live": ev.get("survivors", 0),
                                 "pending": ev.get("pending", 0)}))
        elif kind == "compile":
            out.append(_x(f"compile b={ev.get('b', '?')}",
                          _PID_CAMPAIGN, _TID_COMPILE, ts - dur, dur,
                          _args(ev)))
        elif kind == "transfer":
            out.append(_x(f"transfer:{ev.get('what', '?')}",
                          _PID_CAMPAIGN, _TID_TRANSFER, ts - dur, dur,
                          _args(ev)))
        elif kind == "search.ask":
            asks[int(ev.get("round", -1))] = ev
        elif kind == "search.tell":
            r = int(ev.get("round", -1))
            ask = asks.pop(r, None)
            start = float(ask["ts"]) if ask else ts
            args = _args(ev)
            if ask:
                args.update({f"ask_{k}": v for k, v in _args(ask).items()
                             if k not in args})
            out.append(_x(f"search round {r}", _PID_CAMPAIGN,
                          _TID_SEARCH, start, ts - start, args))
            out.append(_counter("budget", ts,
                                {"cycles": ev.get("budget", 0.0)}))
        elif kind == "trial":
            out.append(_instant("trial", _PID_CAMPAIGN, _TID_TRIALS,
                                ts, _args(ev)))
        elif kind == "rung.promote":
            b = int(ev.get("bracket", 0))
            if b not in brackets:
                brackets.add(b)
                out.append(_meta(_PID_CAMPAIGN, _TID_BRACKET0 + b,
                                 f"bracket {b}"))
            out.append(_instant(f"rung {ev.get('rung', '?')} promote",
                                _PID_CAMPAIGN, _TID_BRACKET0 + b, ts,
                                _args(ev)))
        elif kind in ("ckpt.save", "ckpt.load"):
            out.append(_x(kind, _PID_CAMPAIGN, _TID_CHECKPOINT,
                          ts - dur, dur, _args(ev)))
        elif kind == "task":
            loc = str(ev.get("location", "?"))
            tid = engine_tids.get(loc)
            if tid is None:
                tid = engine_tids[loc] = _TID_ENGINE0 + len(engine_tids)
                if len(engine_tids) == 1:
                    out.append(_meta(_PID_ENGINE, None, "engine"))
                out.append(_meta(_PID_ENGINE, tid, loc))
            start = float(ev.get("start", ts))
            end = float(ev.get("end", start))
            out.append(_x(f"{ev.get('category', '?')}/"
                          f"{ev.get('action', '?')}",
                          _PID_ENGINE, tid, start, end - start,
                          _args(ev, skip=("kind", "ts", "seq", "dur",
                                          "start", "end"))))
    return {"traceEvents": out, "displayTimeUnit": "ms"}


def export_chrome_trace(events, out_path: str) -> str:
    """Write the Chrome-trace JSON for ``events`` (a list or a JSONL log
    path) to ``out_path``; load the file in Perfetto."""
    with open(out_path, "w") as fh:
        json.dump(to_chrome_trace(events), fh)
    return out_path


# ---------------------------------------------------------------------------
def campaign_tasks(events) -> list[Task]:
    """Map a campaign event stream onto
    :class:`~repro_torch.core.tracing.Task` rows for the Daisen-lite
    renderer — one lane per activity class, wall times rebased to the
    first event."""
    events = _load(events)
    wall = [float(e["ts"]) for e in events if "ts" in e]
    t0 = min(wall) if wall else 0.0
    tasks: list[Task] = []
    n = 0

    def add(category, action, location, start, end, **details):
        nonlocal n
        n += 1
        tasks.append(Task(id=f"c{n:08x}", parent_id="",
                          category=category, action=action,
                          location=location, start=start, end=end,
                          details=details))

    for ev in events:
        kind = ev.get("kind", "")
        ts = float(ev.get("ts", t0)) - t0
        dur = float(ev.get("dur", 0.0))
        if kind == "round.end":
            add("round", f"C={ev.get('rung', '?')}", "rounds",
                ts - dur, ts, round=ev.get("round"),
                finished=ev.get("finished"), survivors=ev.get("survivors"))
        elif kind == "compile":
            add("compile", f"b={ev.get('b', '?')}", "compile",
                ts - dur, ts)
        elif kind == "transfer":
            add("transfer", str(ev.get("what", "?")), "transfer",
                ts - dur, ts)
        elif kind == "search.tell":
            add("search", f"round {ev.get('round', '?')}", "search",
                ts - dur if dur else ts, ts,
                budget=ev.get("budget"), n=ev.get("n"))
        elif kind == "rung.promote":
            add("promote", f"rung {ev.get('rung', '?')}",
                f"bracket {ev.get('bracket', 0)}", ts, ts,
                promoted=ev.get("promoted"), dropped=ev.get("dropped"))
        elif kind == "task":
            start = float(ev.get("start", 0.0))
            end = float(ev.get("end", start))
            add(str(ev.get("category", "?")), str(ev.get("action", "?")),
                f"engine/{ev.get('location', '?')}", start, end)
    return tasks


def export_campaign_html(events, out_path: str,
                         title: str = "campaign timeline") -> str:
    """Render the Daisen-lite campaign timeline HTML for ``events`` (a
    list or a JSONL log path)."""
    return export_html(campaign_tasks(events), out_path, title=title)
