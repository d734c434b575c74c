"""Cross-job lane multiplexing: pack lanes from concurrent sweep jobs
into shared round batches (DSE.md "Multiplexing jobs into shared
batches").  Counterpart of ``repro.dse.mux``.

The round loop never cared which campaign a lane belongs to — harvest
and compaction work on opaque lane ids — so two half-full jobs over the
same topology can share chunk-ladder rungs, captured blocks and rounds
instead of each running an underfilled batch.  :class:`LaneMux` is the
front door for that: ``submit()`` any number of jobs (each its own
:class:`~repro_torch.dse.sweep.SweepSpec`, horizon, epoch budget and
extractor), then one ``run()`` interleaves every job's points
round-robin into a single combined spec and drives one
:func:`~repro_torch.dse.runner.run_sweep` over it.

* **Fair refill** — the combined point order *is* the pending-queue
  order, so a round-robin interleave admits each job's lanes at the
  same rate: job B's points don't wait behind the whole of job A.
* **Shared groups** — jobs whose points carry the same ``static.*``
  assignment (and the same build function) land in the same sweep group
  and stack into the same lane batches; jobs with *different* build
  functions are kept apart by a reserved ``static.mux_build`` axis that
  a dispatching wrapper consumes (their groups run one after the other,
  each on its own simulation's blocks).
* **Per-job row routing** — the combined sweep runs with an
  index-aware extractor (``extract(sim, lane_state, index)``): each
  lane's global index maps back to its owning job, whose own extractor
  produces the row.  ``run()`` returns ``{job_id: rows}`` with each
  job's rows in *its own* spec order, the routing axis stripped — a
  multiplexed job's rows are exactly its solo-run rows, bit-identically
  (``tests/test_torch_mux.py``).

Per-lane horizons and budgets make the mix safe: each point keeps its
own ``until`` / ``max_epochs`` as traced per-lane operands, so a
short job's lanes freeze and harvest while a long job's lanes keep
riding the same rounds.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Sequence

import numpy as np

from repro_torch.obs.bus import BUS

from .runner import default_extract, run_sweep
from .schedule import ChunkSchedule
from .sweep import STATIC_PREFIX, SweepSpec

MUX_AXIS = STATIC_PREFIX + "mux_build"   # reserved routing axis


@dataclasses.dataclass
class MuxJob:
    """One submitted sweep job: a spec plus its run knobs.

    ``until`` / ``max_epochs`` may be scalars or per-point sequences
    (they become per-lane operands either way).  ``extract`` follows the
    :func:`~repro_torch.dse.runner.run_sweep` contract.
    """

    job_id: str
    build_fn: Callable
    spec: SweepSpec
    until: object
    extract: Callable | None = None
    max_epochs: object = 2_000_000

    def __post_init__(self):
        for pt in self.spec.points:
            if MUX_AXIS in pt:
                raise ValueError(
                    f"{MUX_AXIS!r} is reserved for job routing; "
                    f"job {self.job_id!r} may not assign it")


class LaneMux:
    """Multiplex several sweep jobs through one shared round loop.

    >>> mux = LaneMux()
    >>> mux.submit("a", build, spec_a, until=800.0)
    >>> mux.submit("b", build, spec_b, until=[...per-point...])
    >>> rows = mux.run()          # {"a": [...], "b": [...]}

    Run knobs (``chunk`` / ``schedule`` / ``shard`` / ``pipeline``)
    apply to the shared loop, passed at :meth:`run`.  A ``LaneMux`` is
    one-shot per ``run()`` but reusable: jobs accumulate until ``run()``
    consumes them.
    """

    def __init__(self):
        self._jobs: list[MuxJob] = []

    def submit(self, job_id: str, build_fn: Callable, spec: SweepSpec,
               until, extract: Callable | None = None,
               max_epochs=2_000_000) -> MuxJob:
        """Queue a job for the next :meth:`run`.  ``job_id`` must be
        unique among queued jobs."""
        if any(j.job_id == job_id for j in self._jobs):
            raise ValueError(f"duplicate job_id {job_id!r}")
        job = MuxJob(job_id=job_id, build_fn=build_fn, spec=spec,
                     until=until, extract=extract, max_epochs=max_epochs)
        self._jobs.append(job)
        return job

    # ------------------------------------------------------------------
    @staticmethod
    def _interleave(jobs: Sequence[MuxJob]):
        """Round-robin combined point order: (job index, local index)
        pairs — position k of every job before position k+1 of any."""
        order: list[tuple[int, int]] = []
        longest = max(len(j.spec) for j in jobs)
        for k in range(longest):
            for ji, job in enumerate(jobs):
                if k < len(job.spec):
                    order.append((ji, k))
        return order

    def run(self, chunk: int | None = None,
            schedule: ChunkSchedule | None = None,
            shard: "bool | int" = False,
            pipeline: "bool | int | None" = None) -> dict[str, list[dict]]:
        """Run every queued job through one shared round loop and return
        ``{job_id: rows}`` (each job's rows in its own spec order)."""
        jobs, self._jobs = self._jobs, []
        if not jobs:
            return {}

        # distinct build functions get a routing axis + dispatch wrapper;
        # a single shared build runs exactly as a plain sweep would
        builds: list[Callable] = []
        build_of: list[int] = []
        for job in jobs:
            try:
                bi = builds.index(job.build_fn)
            except ValueError:
                bi = len(builds)
                builds.append(job.build_fn)
            build_of.append(bi)
        multi_build = len(builds) > 1

        order = self._interleave(jobs)
        points: list[dict] = []
        owner: list[tuple[int, int]] = []     # global index -> (job, local)
        u_all: list[float] = []
        me_all: list[int] = []
        for ji, k in order:
            job = jobs[ji]
            pt = dict(job.spec.points[k])
            if multi_build:
                pt[MUX_AXIS] = build_of[ji]
            points.append(pt)
            owner.append((ji, k))
            u = np.broadcast_to(np.asarray(job.until, np.float32),
                                (len(job.spec),))
            me = np.broadcast_to(np.asarray(job.max_epochs, np.int64),
                                 (len(job.spec),))
            u_all.append(float(u[k]))
            me_all.append(int(me[k]))

        combined = SweepSpec.explicit(points, ragged=True)

        if multi_build:
            def build_fn(mux_build, **kw):
                return builds[int(mux_build)](**kw)
        else:
            build_fn = builds[0]

        extractors = [j.extract or default_extract for j in jobs]

        def route(sim, lane_state, index):
            ji, _ = owner[index]
            return extractors[ji](sim, lane_state)

        if BUS.active:
            BUS.emit("mux.start", jobs=[j.job_id for j in jobs],
                     n_points=len(points), shared_build=not multi_build)
            BUS.count("dse.mux.runs")
        t0 = time.perf_counter()
        rows = run_sweep(build_fn, combined, u_all, extract=route,
                         chunk=chunk, schedule=schedule,
                         max_epochs=me_all, shard=shard,
                         pipeline=pipeline)

        out: dict[str, list[dict]] = {
            j.job_id: [None] * len(j.spec) for j in jobs}
        for g, row in enumerate(rows):
            ji, k = owner[g]
            row.pop(MUX_AXIS, None)           # strip the routing axis
            out[jobs[ji].job_id][k] = row
        if BUS.active:
            BUS.emit("mux.end", jobs=[j.job_id for j in jobs],
                     n_points=len(points),
                     dur=time.perf_counter() - t0)
        return out
