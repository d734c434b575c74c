"""Bridge engine-side :class:`~repro_torch.core.tracing.Task`\\ s onto the
campaign bus — one event stream covers both clocks.

The engine's tracing domains (paper §3.4) timestamp tasks on *their*
clock: host domains use wall time, simulation domains use virtual time.
:class:`BusTracer` is an ordinary tracer (attach it to any
:class:`~repro_torch.core.tracing.TracingDomain`, with the usual filter
predicate) that re-emits completed tasks as ``task`` events tagged with
the domain name and clock, so a campaign's JSONL log interleaves engine
tasks with round/search events and the Perfetto export can render both
— campaign wall-time tracks next to engine task tracks.

Event shape (schema v1)::

    {"kind": "task", "domain": ..., "clock": "wall"|"virtual",
     "id", "parent_id", "category", "action", "location",
     "start", "end", "dur", "tags", "ts", "seq"}

``start``/``end``/``dur`` are in the domain's own clock units;
``ts``/``seq`` are the bus's wall clock and ordering, as for every
event.  A copy of ``repro.obs.bridge``.
"""
from __future__ import annotations

from typing import Callable

from repro_torch.core.tracing import Task, TracingDomain

from .bus import BUS, Bus


class BusTracer:
    """A tracer that forwards completed tasks to a telemetry bus."""

    def __init__(self, bus: Bus | None = None, domain: str = "engine",
                 clock: str = "virtual"):
        assert clock in ("wall", "virtual"), clock
        self.bus = bus if bus is not None else BUS
        self.domain = domain
        self.clock = clock

    # tracer interface (repro_torch.core.tracers._Base shape) ----------
    def on_start(self, t: Task) -> None:
        pass

    def on_end(self, t: Task) -> None:
        if not self.bus.active:
            return
        end = t.start if t.end is None else t.end
        self.bus.emit("task", domain=self.domain, clock=self.clock,
                      id=t.id, parent_id=t.parent_id,
                      category=t.category, action=t.action,
                      location=t.location, start=t.start, end=end,
                      dur=end - t.start, tags=list(t.tags))

    def on_tag(self, t: Task, tag: str) -> None:
        if self.bus.active:
            self.bus.count(f"tag.{tag}")


def bridge_domain(domain: TracingDomain, bus: Bus | None = None,
                  clock: str = "wall",
                  filter: Callable[[Task], bool] | None = None) -> BusTracer:
    """Attach a :class:`BusTracer` to ``domain`` and return it (detach
    with ``domain.detach(tracer)``)."""
    tracer = BusTracer(bus, domain=domain.name, clock=clock)
    domain.attach(tracer, filter=filter)
    return tracer
