"""First-party tracers (paper §3.4): TotalTime, AverageTime, BusyTime,
TagCount, and DBTracer (SQLite — the paper's default — and CSV).

Tracers receive task annotations and decide what to do with them; they can be
attached per-domain with a filter predicate (the analogue of attaching a
tracer to a subset of components).  A ``metrics()`` method returns the
collected summary, and DBTracer persists the complete task tree for
post-simulation analysis (Daisen export reads it back).

Counterpart of ``repro.core.tracers``: host Python, copied, apart from
:func:`flush_engine_trace`, which copies the engine's counters off the
device once, and :class:`ProfilerRangeTracer`, which puts a wall-clock
domain's tasks on ``torch.profiler``'s timeline.
"""
from __future__ import annotations

import csv
import json
import sqlite3
import threading
from collections import defaultdict

from .tracing import Task, current_task


class _Base:
    def on_start(self, t: Task):
        pass

    def on_end(self, t: Task):
        pass

    def on_tag(self, t: Task, tag: str):
        pass


class TotalTimeTracer(_Base):
    """Total time spent in matching tasks (e.g. total memory latency)."""

    def __init__(self):
        self.total = 0.0
        self.count = 0

    def on_end(self, t: Task):
        if t.end is not None:
            self.total += t.end - t.start
            self.count += 1

    def metrics(self):
        return {"total_time": self.total, "count": self.count}


class AverageTimeTracer(TotalTimeTracer):
    """Average task latency (e.g. average L2 transaction latency)."""

    def metrics(self):
        avg = self.total / self.count if self.count else 0.0
        return {"avg_time": avg, "count": self.count}


class BusyTimeTracer(_Base):
    """Time a location is handling >=1 task (e.g. ALU utilization)."""

    def __init__(self):
        self.busy = defaultdict(float)
        self._active = defaultdict(int)
        self._since = {}

    def on_start(self, t: Task):
        loc = t.location
        if self._active[loc] == 0:
            self._since[loc] = t.start
        self._active[loc] += 1

    def on_end(self, t: Task):
        loc = t.location
        self._active[loc] -= 1
        if self._active[loc] == 0 and t.end is not None:
            self.busy[loc] += t.end - self._since.pop(loc)

    def metrics(self):
        return dict(self.busy)


class TagCountTracer(_Base):
    """Counts tag occurrences (e.g. cache hits vs misses)."""

    def __init__(self):
        self.counts = defaultdict(int)

    def on_tag(self, t: Task, tag: str):
        self.counts[tag] += 1

    def metrics(self):
        return dict(self.counts)


class DBTracer(_Base):
    """Persists every completed task (SQLite default, CSV alternative).

    The SQLite database also carries a ``runs`` table with execution info and
    a ``metrics`` table for periodic series (buffer levels, port throughput)
    — the paper's performance-analysis framework (§3.4).
    """

    SCHEMA = """
    CREATE TABLE IF NOT EXISTS runs(
        run_id TEXT PRIMARY KEY, command TEXT, workdir TEXT,
        start REAL, end REAL, info TEXT);
    CREATE TABLE IF NOT EXISTS tasks(
        id TEXT, parent_id TEXT, category TEXT, action TEXT, location TEXT,
        start REAL, end REAL, tags TEXT, details TEXT);
    CREATE TABLE IF NOT EXISTS metrics(
        run_id TEXT, name TEXT, location TEXT, t REAL, value REAL);
    """

    def __init__(self, path: str, backend: str = "sqlite",
                 run_id: str = "run0"):
        self.path, self.backend, self.run_id = str(path), backend, run_id
        self._lock = threading.Lock()
        if backend == "sqlite":
            self._conn = sqlite3.connect(self.path, check_same_thread=False)
            self._conn.executescript(self.SCHEMA)
            import os
            import sys
            self._conn.execute(
                "INSERT OR REPLACE INTO runs VALUES(?,?,?,?,?,?)",
                (run_id, " ".join(sys.argv), os.getcwd(), 0.0, -1.0, "{}"))
            self._conn.commit()
        elif backend == "csv":
            self._fh = open(self.path, "w", newline="")
            self._csv = csv.writer(self._fh)
            self._csv.writerow(Task.ROW_FIELDS)
        else:
            raise ValueError(backend)

    def on_end(self, t: Task):
        with self._lock:
            if self.backend == "sqlite":
                self._conn.execute(
                    "INSERT INTO tasks VALUES(?,?,?,?,?,?,?,?,?)", t.row())
            else:
                self._csv.writerow(t.row())

    def add_metric(self, name: str, location: str, t: float, value: float):
        if self.backend == "sqlite":
            with self._lock:
                self._conn.execute("INSERT INTO metrics VALUES(?,?,?,?,?)",
                                   (self.run_id, name, location, t, value))

    def add_metrics(self, rows):
        """rows: iterable of (name, location, t, value)."""
        if self.backend == "sqlite":
            with self._lock:
                self._conn.executemany(
                    "INSERT INTO metrics VALUES(?,?,?,?,?)",
                    [(self.run_id, *r) for r in rows])

    def flush(self):
        with self._lock:
            if self.backend == "sqlite":
                self._conn.commit()
            else:
                self._fh.flush()

    def close(self):
        self.flush()
        if self.backend == "sqlite":
            self._conn.close()
        else:
            self._fh.close()

    # -- read-back helpers (used by Daisen export + tests) ------------------
    def fetch_tasks(self):
        assert self.backend == "sqlite"
        cur = self._conn.execute("SELECT * FROM tasks ORDER BY start")
        out = []
        for row in cur.fetchall():
            out.append(Task(id=row[0], parent_id=row[1], category=row[2],
                            action=row[3], location=row[4], start=row[5],
                            end=None if row[6] < 0 else row[6],
                            tags=json.loads(row[7]),
                            details=json.loads(row[8])))
        return out

    def fetch_metrics(self, name: str | None = None):
        assert self.backend == "sqlite"
        q = "SELECT name, location, t, value FROM metrics"
        args = ()
        if name:
            q += " WHERE name=?"
            args = (name,)
        return self._conn.execute(q + " ORDER BY t", args).fetchall()


class ProfilerRangeTracer(_Base):
    """Mirrors a domain's tasks as ``torch.profiler`` ranges named
    ``<domain>.<category>`` (``train.forward``, ``serve.decode``), so that
    the profiler's host ops, and the device work they launch, nest under
    the program's spans on the device trace's clock.

    While no profiler records it checks one flag and does nothing else.
    It mirrors only tasks on the thread's task stack: a task started with
    an explicit parent does not nest on the thread, and a range must.
    Attach it with :func:`profiler_ranges`, once per domain."""

    def __init__(self, prefix: str):
        from torch.autograd import profiler
        self.prefix = prefix
        self._prof = profiler
        self._open = {}               # task id -> its open range

    def on_start(self, t: Task):
        if self._prof._is_profiler_enabled and current_task() is t:
            rf = self._prof.record_function(f"{self.prefix}.{t.category}")
            rf.__enter__()
            self._open[t.id] = rf

    def on_end(self, t: Task):
        if self._open:
            rf = self._open.pop(t.id, None)
            if rf is not None:
                rf.__exit__(None, None, None)


def profiler_ranges(domain) -> ProfilerRangeTracer:
    """The domain's :class:`ProfilerRangeTracer`, attached if it has
    none: a second one would open every range twice."""
    for tr, _ in domain._tracers:
        if isinstance(tr, ProfilerRangeTracer):
            return tr
    return domain.attach(ProfilerRangeTracer(domain.name))


def flush_engine_trace(sim, state, db: DBTracer, virtual_time_scale=1.0):
    """Flush device-level engine counters into the trace DB (§3.4's periodic
    buffer-level / busy-time recording): per-component busy ticks and the
    sampled in-buffer levels."""
    busy = state.stats.busy.cpu().numpy()
    rows = []
    ci = 0
    for k in sim.kinds:
        for i in range(k.n_instances):
            rows.append(("busy_ticks", f"{k.name}[{i}]", float(state.time),
                         float(busy[ci])))
            ci += 1
    if sim.max_samples and int(state.sample_idx) > 0:
        samples = state.buf_samples.cpu().numpy()
        n = min(int(state.sample_idx), sim.max_samples)
        for si in range(n):
            t = (si + 1) * sim.sample_period * virtual_time_scale
            for ki, k in enumerate(sim.kinds):
                pb = sim.port_base[ki]
                for inst in range(k.n_instances):
                    for p in range(k.n_ports):
                        rows.append((
                            "buf_level", f"{k.name}[{inst}].p{p}", t,
                            float(samples[si, pb + inst * k.n_ports + p])))
    db.add_metrics(rows)
    db.flush()
