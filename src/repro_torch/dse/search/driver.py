"""The closed-loop search contract: ``ask() -> (points, horizons)`` /
``tell(rows)`` around round-based sweeps.  Counterpart of
``repro.dse.search.driver``; for the same search it gives the same rows,
budget and ``SearchState`` JSON, text for text.

A *search driver* owns the between-rounds decisions of a design-space
search — which points to simulate next and how far (in simulated cycles)
to run each one — while every round executes through the existing
:func:`~repro_torch.dse.runner.run_sweep` machinery, so the lanes stay
lane-batched, chunk-laddered and capture nothing new after warmup (one
CUDA graph a rung on the card), and the engine
hot loop is untouched (all acquisition/selection logic is host-side
bookkeeping over result rows).

* :class:`Objective` — one or many result columns with directions
  (``"virtual_time"`` or ``{"virtual_time": "min", "hit_rate": "max"}``),
  scalarization weights, non-dominated ranking (via
  :func:`~repro_torch.dse.report.dominates`) and running Pareto fronts.
* :class:`SearchState` — the resumable, JSON-serializable record of a
  search: trial history, cumulative *simulated-cycle* budget, RNG state
  and a driver-specific pocket.  Serializing after any ``tell`` and
  reconstructing the driver with ``state=`` resumes the identical
  trajectory (rows are bit-reproducible, selection is stable-sorted).
* :class:`SearchDriver` — the loop contract plus shared bookkeeping
  (budget accounting in simulated cycles: each trial costs the cycles it
  *newly* simulated — ``row["virtual_time"]`` when the extractor reports
  it, else its horizon, minus the frozen time of the trial's
  :class:`~repro_torch.dse.runner.ResumeHandle` when the lane resumed from a
  previous rung's state instead of replaying from cycle 0).
* :func:`run_search` — the driver loop: memoize the build function
  (:func:`~repro_torch.dse.runner.memoize_build`, so every round reuses one
  built simulation and its tuned ladder), then ``ask`` → ``run_sweep``
  → ``tell`` until the driver is done.

Concrete drivers: :class:`~repro_torch.dse.search.halving.SuccessiveHalving`,
:class:`~repro_torch.dse.search.bo.BatchBO` and
:class:`~repro_torch.dse.search.bo.RandomSearch`.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Callable, Mapping, Sequence

import numpy as np

from repro_torch.obs.bus import BUS

from ..report import MAX, MIN, pareto_front, score_vector, _dominates_scores
from ..runner import (LaneStates, ResumeHandle, _shard_devices,
                      memoize_build, run_sweep)
from ..schedule import ChunkSchedule
from ..sweep import SweepSpec


class Objective:
    """What the search optimizes: result columns + directions.

    ``spec`` is a column name (minimized) or a ``{column: 'min'|'max'}``
    mapping.  Multi-objective searches either *scalarize* — ``scalar``
    is the weighted sum of the canonical minimize-direction values
    (``weights`` defaults to 1.0 each) — or rank by domination:
    ``order`` sorts rows best-first by (number of rows in the batch that
    dominate it, scalarized value, input index), so non-dominated rows
    are promoted first and the scalarization only breaks ties.  For a
    single objective both reduce to a stable sort on the column.

    NaN or missing objective values scalarize to ``+inf`` (never
    selected over a finished trial) and neither dominate nor are
    dominated, matching :func:`~repro_torch.dse.report.pareto_front`.
    """

    def __init__(self, spec: str | Mapping[str, str],
                 weights: Mapping[str, float] | None = None):
        if isinstance(spec, str):
            spec = {spec: MIN}
        self.objectives = dict(spec)
        assert self.objectives and all(
            d in (MIN, MAX) for d in self.objectives.values()), spec
        self.weights = {c: float((weights or {}).get(c, 1.0))
                        for c in self.objectives}

    @property
    def columns(self) -> list[str]:
        return list(self.objectives)

    def scalar(self, row: Mapping) -> float:
        """Scalarized objective, lower is better; NaN/missing -> +inf."""
        total = 0.0
        for c, d in self.objectives.items():
            try:
                v = float(row[c])
            except (KeyError, TypeError, ValueError):
                return float("inf")
            if v != v:
                return float("inf")
            total += self.weights[c] * (-v if d == MAX else v)
        return total

    def order(self, rows: Sequence[Mapping]) -> list[int]:
        """Indices of ``rows`` sorted best-first (stable)."""
        scalars = [self.scalar(r) for r in rows]
        inf = float("inf")
        if len(self.objectives) == 1:
            key = lambda i: (scalars[i], i)
        else:
            scores = []
            for r in rows:
                try:
                    s = score_vector(r, self.objectives)
                except (KeyError, TypeError, ValueError):
                    s = (float("nan"),) * len(self.objectives)
                scores.append(s)
            dom = [sum(_dominates_scores(o, s) for o in scores)
                   for s in scores]
            # failed trials (scalar == inf: NaN/missing objectives) rank
            # behind every finished row — a NaN score is never dominated,
            # so domination count alone would promote it over finished
            # but dominated rows
            key = lambda i: (scalars[i] == inf, dom[i], scalars[i], i)
        return sorted(range(len(rows)), key=key)

    def front(self, rows: Sequence[Mapping]) -> list[dict]:
        """Non-dominated ``rows`` (the running Pareto front)."""
        return pareto_front(rows, self.objectives)


# ---------------------------------------------------------------------------
@dataclasses.dataclass
class SearchState:
    """The resumable record of a search — everything a driver needs to
    continue is either here or in the driver's constructor arguments.

    ``history`` holds one flat trial dict per evaluated (point, horizon)
    pair: the sweep result row (axis assignments merged with extracted
    columns) plus ``"until"`` (the horizon it ran to) and ``"round"``.
    ``budget`` is the cumulative *simulated-cycle* spend.  ``rng`` is
    the numpy bit-generator state of the driver's RNG.  ``driver`` is a
    JSON-safe pocket for driver-specific progress (survivor sets, rung
    indices, ...).

    Valid snapshot points are round boundaries (after ``tell``) —
    ``SearchDriver.tell`` refreshes ``rng`` there, and ``run_search``'s
    ``callback`` fires there.  Restoring: rebuild the driver with the
    same constructor arguments plus ``state=``; the remaining trajectory
    is identical (pinned by ``tests/test_torch_search.py``).
    """

    round: int = 0
    budget: float = 0.0
    history: list = dataclasses.field(default_factory=list)
    driver: dict = dataclasses.field(default_factory=dict)
    rng: dict | None = None

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), sort_keys=True)

    @staticmethod
    def from_json(s: str) -> "SearchState":
        return SearchState(**json.loads(s))


# ---------------------------------------------------------------------------
class SearchDriver:
    """Base class: the ``ask``/``tell`` loop contract plus shared
    bookkeeping (history, simulated-cycle budget, RNG persistence).

    Subclasses implement ``_ask() -> (points, horizons) | None`` —
    optionally ``(points, horizons, handles)`` with one
    :class:`~repro_torch.dse.runner.ResumeHandle` (or None) per point, the
    warm-resume contract — and ``_tell(points, horizons, rows,
    states=None)`` (selection/acquisition; ``states`` is the sweep's
    :class:`~repro_torch.dse.runner.LaneStates` when the driver declared
    ``wants_states``), and may override ``done``.  ``seed`` feeds a
    numpy RNG whose state rides :class:`SearchState`, so a resumed
    driver continues the same stream.  ``cycle_budget`` (optional)
    hard-stops the search once the cumulative simulated-cycle spend
    reaches it.
    """

    def __init__(self, objective: str | Mapping[str, str] | Objective,
                 *, seed: int = 0, cycle_budget: float | None = None,
                 state: SearchState | None = None):
        self.objective = (objective if isinstance(objective, Objective)
                          else Objective(objective))
        self.cycle_budget = cycle_budget
        self.state = state if state is not None else SearchState()
        self._rng = np.random.default_rng(seed)
        if self.state.rng is not None:
            self._rng.bit_generator.state = self.state.rng
        self._asked: tuple[list[dict], list[float]] | None = None
        self._handles: list[ResumeHandle | None] | None = None
        self._costs: list[float] | None = None

    # -- the loop contract ------------------------------------------------
    def ask(self) -> tuple[list[dict], list[float]] | None:
        """The next round: ``(points, horizons)`` — parallel lists, one
        horizon (simulated-cycle ``until``) per design point — or
        ``None`` when the search is finished.  When the driver resumes
        lanes from previous-rung states, the per-point handles are on
        :attr:`resume_handles` (``run_search`` feeds them to
        ``run_sweep(resume=...)``)."""
        if self.done:
            return None
        asked = self._ask()
        self._handles = None
        if asked is not None:
            if len(asked) == 3:
                points, horizons, handles = asked
                if handles is not None and any(h is not None
                                               for h in handles):
                    assert len(handles) == len(points), asked
                    self._handles = list(handles)
            else:
                points, horizons = asked
            assert len(points) == len(horizons), asked
            if not points:
                return None
            self._asked = (list(points), [float(u) for u in horizons])
            if BUS.active:
                us = self._asked[1]
                BUS.emit("search.ask", round=self.state.round,
                         n=len(points), u_min=min(us), u_max=max(us),
                         warm=(0 if self._handles is None else
                               sum(1 for h in self._handles
                                   if h is not None)))
            return self._asked
        return None

    @property
    def resume_handles(self) -> "list[ResumeHandle | None] | None":
        """Per-point resume handles of the pending ask (or None when
        every lane starts cold)."""
        return self._handles

    @property
    def wants_states(self) -> bool:
        """Whether ``tell`` should receive the sweep's final lane states
        (:class:`~repro_torch.dse.runner.LaneStates`).  Drivers that promote
        warm override this; the loop only pays the (already-transferred)
        state bookkeeping when someone will use it."""
        return False

    def tell(self, rows: Sequence[Mapping],
             states: LaneStates | None = None) -> None:
        """Feed back the result rows of the last ``ask``, in ask order.
        Records history + budget (each trial's *incremental* cycles —
        see :meth:`_trial_cycles` — also stored per trial under
        ``"cycles"``), lets the driver select/refit, advances the round
        counter and snapshots the RNG state (making this a valid resume
        point).  ``states`` carries the sweep's final lane states when
        the driver ``wants_states``."""
        assert self._asked is not None, "tell() without a pending ask()"
        points, horizons = self._asked
        assert len(rows) == len(points), (len(rows), len(points))
        tele = BUS.active
        costs = []
        for j, (u, row) in enumerate(zip(horizons, rows)):
            h = self._handles[j] if self._handles is not None else None
            cost = self._trial_cycles(u, row, h)
            trial = dict(row)
            trial["until"] = u
            trial["round"] = self.state.round
            trial["cycles"] = cost
            self.state.history.append(trial)
            self.state.budget += cost
            costs.append(cost)
            if tele:
                BUS.emit("trial", round=self.state.round, until=u,
                         cycles=cost, warm=h is not None,
                         value=self.objective.scalar(row), row=trial)
                BUS.count("search.trials")
        self._costs = costs
        self._tell(points, horizons, rows, states)
        if tele:
            best = self.best()
            BUS.emit("search.tell", round=self.state.round, n=len(rows),
                     cost=sum(costs), budget=self.state.budget,
                     cycle_budget=self.cycle_budget, best=best)
            BUS.gauge("search.budget", self.state.budget)
            if best is not None:
                BUS.gauge("search.best", self.objective.scalar(best))
        self._asked = None
        self._handles = None
        self._costs = None
        self.state.round += 1
        self.state.rng = self._rng.bit_generator.state

    @staticmethod
    def _trial_cycles(until: float, row: Mapping,
                      handle: ResumeHandle | None = None) -> float:
        """Simulated-cycle cost of one trial: the cycles it *newly* ran.

        A cold trial costs the cycles it actually simulated (a lane that
        drains early costs its own drain time, not the horizon), falling
        back to the horizon when the extractor does not report a usable
        ``virtual_time`` (a NaN would poison the cumulative budget and
        permanently disarm ``cycle_budget``).  A warm trial resumed from
        ``handle`` costs only the increment past the handle's frozen
        time — the whole point of state-resumed promotion: a config
        promoted up an entire horizon ladder costs its *final* virtual
        time, not the sum of every rung's replay.
        """
        try:
            v = float(row["virtual_time"])
        except (KeyError, TypeError, ValueError):
            v = float(until)
        if v != v:
            v = float(until)
        start = float(handle.time) if handle is not None else 0.0
        return max(v - start, 0.0)

    @property
    def done(self) -> bool:
        if (self.cycle_budget is not None
                and self.state.budget >= self.cycle_budget):
            return True
        return self._done()

    # -- subclass hooks ---------------------------------------------------
    def _ask(self) -> tuple[list[dict], list[float]] | None:
        raise NotImplementedError

    def _tell(self, points, horizons, rows,
              states: LaneStates | None = None) -> None:
        pass

    def _done(self) -> bool:
        raise NotImplementedError

    # -- results ----------------------------------------------------------
    @property
    def max_horizon(self) -> float:
        """The horizon at which trials are final (fully comparable to an
        exhaustive sweep).  Subclasses with a horizon ladder override."""
        hist = self.state.history
        return max((t["until"] for t in hist), default=0.0)

    def trials_at_max_horizon(self) -> list[dict]:
        return [t for t in self.state.history
                if t["until"] >= self.max_horizon]

    def best(self) -> dict | None:
        """The best trial: lowest scalarized objective among trials run
        to the full horizon (falling back to all of history when the
        budget cap stopped the search before any full-horizon round)."""
        pool = self.trials_at_max_horizon() or self.state.history
        if not pool:
            return None
        order = self.objective.order(pool)
        return pool[order[0]]

    def front(self) -> list[dict]:
        """The Pareto front over full-horizon trials (multi-objective);
        for a single objective this is just the best trial(s)."""
        pool = self.trials_at_max_horizon()
        return self.objective.front(pool) if pool else []

    def _draw_seed(self) -> int:
        """A child seed from the driver's persistent RNG stream (used
        for per-round candidate sampling; deterministic under resume)."""
        return int(self._rng.integers(0, 2**31 - 1))


# ---------------------------------------------------------------------------
@dataclasses.dataclass
class SearchResult:
    """What :func:`run_search` returns: the best trial, the running
    Pareto ``front`` (full-horizon trials), the full trial history
    (``rows``), the simulated-cycle ``budget`` spent, the number of
    ask/tell ``rounds`` executed, and the final resumable ``state``."""

    best: dict | None
    front: list[dict]
    rows: list[dict]
    budget: float
    rounds: int
    state: SearchState


def run_search(build_fn: Callable, driver: SearchDriver, *,
               extract: Callable | None = None,
               max_epochs: int = 2_000_000,
               chunk: int | None = None,
               schedule: ChunkSchedule | None = None,
               shard: "bool | int" = False,
               callback: Callable | None = None) -> SearchResult:
    """Drive a closed-loop search: ``ask`` → round-based sweep → ``tell``
    until the driver finishes.

    ``build_fn`` / ``extract`` / ``chunk`` / ``schedule`` / ``shard``
    mean exactly what they mean for :func:`~repro_torch.dse.runner.run_sweep`
    — each round is one ``run_sweep`` call over the asked points at
    per-point horizons.  ``build_fn`` is memoized for the duration of
    the search (:func:`~repro_torch.dse.runner.memoize_build`), so every
    round reuses one built simulation per static group — and therefore
    the shared :func:`~repro_torch.dse.runner.runner_for` blocks and the
    autotuned chunk ladder — instead of capturing again per round; pass an
    already-memoized build function to extend that reuse across
    searches.  ``callback(driver)`` fires after every ``tell`` (a valid
    :class:`SearchState` snapshot point).
    """
    build_fn = memoize_build(build_fn)
    if BUS.active:
        BUS.emit("search.start", driver=type(driver).__name__,
                 objective=driver.objective.objectives,
                 cycle_budget=driver.cycle_budget,
                 shard=_shard_devices(shard),
                 resumed_round=driver.state.round)
    rounds = 0
    while True:
        asked = driver.ask()
        if asked is None:
            break
        points, horizons = asked
        # the per-static-group key check stays on: a driver bug that
        # drops an axis key from some points fails here, naming the
        # point, not as an opaque stacking error inside the sweep
        spec = SweepSpec.explicit(points)
        want = driver.wants_states
        out = run_sweep(build_fn, spec,
                        until=np.asarray(horizons, np.float32),
                        extract=extract, chunk=chunk, schedule=schedule,
                        max_epochs=max_epochs, shard=shard,
                        resume=driver.resume_handles,
                        return_states=want)
        rows, states = out if want else (out, None)
        driver.tell(rows, states=states)
        rounds += 1
        if callback is not None:
            callback(driver)
    best = driver.best()
    if BUS.active:
        BUS.emit("search.end", rounds=rounds, budget=driver.state.budget,
                 trials=len(driver.state.history), best=best)
    return SearchResult(best=best, front=driver.front(),
                        rows=list(driver.state.history),
                        budget=driver.state.budget, rounds=rounds,
                        state=driver.state)
