"""Task-based tracing (paper §3.4, Table 2).  A copy of
``repro.core.tracing``, which imports no JAX, kept in the port so the port
imports nothing of the JAX package.

Tasks are hierarchical: every task records its parent, so the trace forms a
tree (instruction -> cache miss -> memory transaction).  The instrumentation
API is exactly the paper's three calls — ``start_task`` / ``end_task`` /
``tag_task`` — kept deliberately minimal so hardware-model code stays clean
(AOP separation: the model emits annotations; *tracers* decide what to do
with them).

Two clocks coexist (DESIGN.md §3): host tasks (train steps, checkpoint
saves, sim runs) use wall time; simulation tasks use virtual time — the
caller supplies ``time_fn`` per domain.

Tasks that run nested on a thread sit on that thread's task stack, and a
task started there takes the top of the stack as its parent.  An
asynchronous task (a served request, its wait in the queue) outlives the
calls that start and end it: :meth:`TracingDomain.start_task` takes its
parent explicitly (``parent=``, as Akita's StartTask takes the parent's
ID) and leaves the stack alone.

Enhanced backtraces (paper Fig. 6b): the active task chain is tracked per
thread; :func:`format_backtrace` renders root→leaf with category/action/
location so a crash shows the *architectural* cause chain alongside the
Python traceback.  Use the :func:`task` context manager to get this
automatically on exceptions.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import json
import threading
import time as _time
from typing import Any, Callable, Iterable

_id_counter = itertools.count()
_local = threading.local()


def _new_id() -> str:
    return f"t{next(_id_counter):08x}"


@dataclasses.dataclass
class Task:
    """One traced task — the paper's Table 2 record."""

    id: str
    parent_id: str
    category: str
    action: str
    location: str
    start: float
    end: float | None = None
    tags: list[str] = dataclasses.field(default_factory=list)
    details: dict = dataclasses.field(default_factory=dict)

    def row(self) -> tuple:
        return (self.id, self.parent_id, self.category, self.action,
                self.location, self.start,
                -1.0 if self.end is None else self.end,
                json.dumps(self.tags), json.dumps(self.details))

    ROW_FIELDS = ("id", "parent_id", "category", "action", "location",
                  "start", "end", "tags", "details")


def _stack() -> list[Task]:
    if not hasattr(_local, "stack"):
        _local.stack = []
        _local.domains = []      # the domain of each task on the stack
    return _local.stack


def current_task() -> Task | None:
    s = _stack()
    return s[-1] if s else None


_FROM_STACK = object()     # ``parent`` not given: the thread's current task


class TracingDomain:
    """A set of tracers attached to an instrumented subsystem.

    Akita lets users attach multiple tracers to one component and one tracer
    to many components; here tracers attach to a domain with an optional
    per-tracer filter predicate over tasks.
    """

    def __init__(self, name: str = "default",
                 time_fn: Callable[[], float] = _time.perf_counter):
        self.name = name
        self.time_fn = time_fn
        self._tracers: list[tuple[Any, Callable[[Task], bool] | None]] = []

    # -- tracer management -------------------------------------------------
    def attach(self, tracer, filter: Callable[[Task], bool] | None = None):
        self._tracers.append((tracer, filter))
        return tracer

    def detach(self, tracer):
        self._tracers = [(tr, f) for tr, f in self._tracers if tr is not tracer]

    # -- instrumentation API (paper: StartTask / EndTask / TagTask) --------
    def start_task(self, category: str, action: str, location: str,
                   time: float | None = None, parent=_FROM_STACK,
                   push: bool | None = None, **details) -> Task:
        """Start a task.  Its parent is the thread's current task, unless
        ``parent`` names it (a :class:`Task`, or ``None`` for a root).  A
        task is pushed onto the thread's stack unless its parent was given:
        an asynchronous task ends in another call, and other tasks must
        not take it as their parent meanwhile.  ``push=True`` pushes a task
        with a given parent all the same (it runs nested on this thread,
        for another task's sake)."""
        if push is None:
            push = parent is _FROM_STACK
        if parent is _FROM_STACK:
            parent = current_task()
        t = Task(id=_new_id(),
                 parent_id=parent.id if parent else "",
                 category=category, action=action, location=location,
                 start=self.time_fn() if time is None else time,
                 details=details)
        if push:
            _stack().append(t)
            _local.domains.append(self)
        for tr, f in self._tracers:
            if f is None or f(t):
                tr.on_start(t)
        return t

    def end_task(self, t: Task, time: float | None = None):
        t.end = self.time_fn() if time is None else time
        s, d = _stack(), _local.domains
        if any(x is t for x in s):
            # pop t and anything mistakenly left above it
            while s[-1] is not t:
                s.pop()
                d.pop()
            s.pop()
            d.pop()
        for tr, f in self._tracers:
            if f is None or f(t):
                tr.on_end(t)

    def tag_task(self, tag: str, t: Task | None = None):
        t = t or current_task()
        if t is None:
            return
        t.tags.append(tag)
        for tr, f in self._tracers:
            if f is None or f(t):
                tr.on_tag(t, tag)

    # -- context-manager sugar ---------------------------------------------
    def task(self, category: str, action: str, location: str,
             parent=_FROM_STACK, **details):
        """A task over a ``with`` block.  It nests on the thread, so it is
        pushed even where ``parent`` names its parent."""
        return _TaskCtx(self, category, action, location,
                        dict(details, parent=parent, push=True))


class _TaskCtx:
    def __init__(self, dom, category, action, location, details):
        self.dom, self.args = dom, (category, action, location)
        self.details = details
        self.t: Task | None = None

    def __enter__(self) -> Task:
        self.t = self.dom.start_task(*self.args, **self.details)
        return self.t

    def __exit__(self, etype, e, tb):
        if etype is not None and self.t is not None:
            # Enhanced backtrace (paper Fig. 6b): print the task chain.
            print(format_backtrace(self.t, header=f"Panic: {e!r}"))
        if self.t is not None:
            self.dom.end_task(self.t)
        return False


def subtask(category: str, action: str, location: str, **details):
    """A task over a ``with`` block under the thread's current task, on
    that task's domain; nothing where no task is open.  For code that
    runs inside traced work but holds no domain (the model's layer loop
    inside a train step's forward or an engine's prefill)."""
    doms = getattr(_local, "domains", None)
    if not doms:
        return contextlib.nullcontext()
    return doms[-1].task(category, action, location, **details)


def format_backtrace(leaf: Task | None = None, header: str = "Backtrace",
                     chain: Iterable[Task] | None = None) -> str:
    """Render the architectural cause chain root→leaf (paper Fig. 6b)."""
    if chain is None:
        chain = list(_stack())
        if leaf is not None and (not chain or chain[-1] is not leaf):
            chain = chain + [leaf]
    lines = [header]
    for t in chain:
        det = f" {t.details}" if t.details else ""
        lines.append(f"  @{t.location}, {t.category}, {t.action}{det}")
    return "\n".join(lines)


# A module-level default domain for convenience.
default_domain = TracingDomain("default")
start_task = default_domain.start_task
end_task = default_domain.end_task
tag_task = default_domain.tag_task
task = default_domain.task
attach = default_domain.attach
