"""Successive halving over round-based sweeps (ASHA-style).  Counterpart
of ``repro.dse.search.halving``.

Run the whole candidate pool at a short horizon, promote the top
``1/eta`` fraction to an ``eta``-times longer horizon, repeat until the
survivors reach the full horizon — the classic successive-halving
schedule (Jamieson & Talwalkar; ASHA), with the *horizon ladder* as the
fidelity axis: a rung-``r`` trial runs ``max_horizon / eta**(R-1-r)``
simulated cycles.  This is exactly the workload the runner's per-lane
``until`` was built for: every rung is one mixed- or uniform-horizon
``run_sweep`` round, so promotion costs no new capture and stragglers
cost no waste.

The horizon ladder is the *search* analogue of the runner's chunk
ladder (DSE.md): the chunk ladder schedules **wall-clock** (which lanes
share a block in a round, result-invariant), the horizon ladder
schedules **simulated-cycle budget** (how long each config deserves to
run, the thing the search economizes).

``brackets > 1`` staggers Hyperband-style brackets: the pool is split
round-robin, bracket ``b`` starts ``b`` rungs up the ladder (fewer
configs, longer horizons), and every round asks all live brackets at
once — a genuinely mixed-horizon batch through one lane-batched sweep.

Promotion ranks rows with :meth:`Objective.order` — single objectives
stably sort the scalarized column; multi-objective pools promote
non-dominated rows first (via :func:`~repro_torch.dse.report.dominates`).
Rows are bit-reproducible and the sort is stable, so a seeded search's
trajectory is bit-reproducible and resumable (``state=``).

**Warm promotion** (``warm=True``, the default): a promoted config does
not replay from cycle 0 at the next rung — its rung-end
:class:`~repro_torch.core.SimState` rides a
:class:`~repro_torch.dse.runner.ResumeHandle` into the next round's stacked
batch and the lane simply *continues* to the longer horizon.  The
engine's epoch sequence is state-determined and ``until`` is an
absolute per-lane operand, so a resumed row is bit-identical to a cold
run at the same horizon (tests/test_torch_warm_resume.py) while the
budget is charged only the *increment*: a config promoted through the
whole ladder costs its final virtual time, not the sum of every rung's
replay (DSE.md "Warm-state promotions").  Rung states persist through
``repro_torch.ckpt`` via :func:`~repro_torch.dse.search.warm.save_search` /
:func:`~repro_torch.dse.search.warm.load_search`, so a resumed search never
re-pays completed rungs either.
"""
from __future__ import annotations

import json
import math
from typing import Mapping, Sequence

from repro_torch.obs.bus import BUS

from ..runner import LaneStates, ResumeHandle
from ..sweep import SweepSpec
from .driver import Objective, SearchDriver, SearchState


def horizon_ladder(max_horizon: float, min_horizon: float | None = None,
                   eta: int = 3, rungs: int | None = None) -> list[float]:
    """Geometric rung horizons ending exactly at ``max_horizon``.

    Either name the bottom (``min_horizon`` — the count of rungs is the
    largest R with ``max/eta**(R-1) >= min_horizon``) or the count
    (``rungs``).  Returns ``[max/eta**(R-1), ..., max/eta, max]``.
    """
    assert eta >= 2 and max_horizon > 0
    if rungs is None:
        if min_horizon is None:
            rungs = 1
        else:
            assert 0 < min_horizon <= max_horizon
            rungs = 1 + int(math.floor(
                math.log(max_horizon / min_horizon) / math.log(eta) + 1e-9))
    assert rungs >= 1
    return [max_horizon / eta ** (rungs - 1 - r) for r in range(rungs)]


class SuccessiveHalving(SearchDriver):
    """ASHA-style successive halving driving mixed-horizon sweep rounds.

    ``pool`` is the candidate set: a :class:`SweepSpec`, a sequence of
    point dicts, or an axes dict (as :meth:`SweepSpec.random` takes)
    sampled to ``n_init`` points with ``seed``.  Points may use any
    sweep axis — including ``shape.*`` family axes, so the search picks
    topology shapes as freely as latencies.

    The horizon ladder comes from ``max_horizon`` + (``min_horizon`` or
    ``rungs``) + ``eta`` (:func:`horizon_ladder`); each promotion keeps
    the top ``ceil(n / eta)`` of a rung.  ``brackets`` staggers
    Hyperband-style brackets (see module docstring).  ``cycle_budget``
    optionally hard-caps the simulated-cycle spend; ``bracket_budgets``
    additionally caps each bracket's *own* spend — ``"equal"`` splits
    ``cycle_budget`` evenly, or pass one explicit cap per bracket — so
    one expensive bracket can never starve its siblings.  Every bracket
    tracks its spend (``"spent"`` in the driver pocket) either way.

    ``warm=True`` (default) promotes by state-resume instead of replay
    (module docstring); ``warm=False`` restores the replay-from-zero
    behavior exactly (useful for A/B budget accounting, and for JSON-
    only resumes that cannot carry rung states).
    """

    def __init__(self, pool, objective: str | Mapping | Objective, *,
                 max_horizon: float, min_horizon: float | None = None,
                 rungs: int | None = None, eta: int = 3,
                 n_init: int | None = None, brackets: int = 1,
                 seed: int = 0, cycle_budget: float | None = None,
                 bracket_budgets: Sequence[float] | str | None = None,
                 warm: bool = True,
                 state: SearchState | None = None):
        super().__init__(objective, seed=seed, cycle_budget=cycle_budget,
                         state=state)
        if isinstance(pool, dict):
            assert n_init, "an axes-dict pool needs n_init"
            pool = SweepSpec.random(pool, n_init, seed=seed)
        points = [dict(p) for p in pool]
        assert points, "empty candidate pool"
        self.eta = int(eta)
        self.warm = bool(warm)
        self._handle_store: dict[str, ResumeHandle] = {}
        self.horizons = horizon_ladder(max_horizon, min_horizon, self.eta,
                                       rungs)
        n_brackets = max(1, min(int(brackets), len(self.horizons),
                                len(points)))
        if not self.state.driver:        # fresh search (not a resume)
            self.state.driver = {"brackets": [
                {"rung": b, "alive": points[b::n_brackets],
                 "spent": 0.0, "budget": None}
                for b in range(n_brackets)]}
        brs = self.state.driver["brackets"]
        if bracket_budgets is not None:
            if bracket_budgets == "equal":
                assert cycle_budget, \
                    "bracket_budgets='equal' needs a cycle_budget to split"
                caps = [float(cycle_budget) / len(brs)] * len(brs)
            else:
                caps = [float(c) for c in bracket_budgets]
                assert len(caps) == len(brs), (
                    f"{len(caps)} bracket budgets for {len(brs)} brackets")
            for br, cap in zip(brs, caps):
                br["budget"] = cap

    # ------------------------------------------------------------------
    @property
    def max_horizon(self) -> float:
        return self.horizons[-1]

    @property
    def wants_states(self) -> bool:
        return self.warm            # rung-end states feed the promotions

    def adopt_handles(self, handles: Mapping[str, ResumeHandle]) -> None:
        """Install rung-end resume handles restored from a checkpoint
        (:func:`~repro_torch.dse.search.warm.load_search`): the resumed search
        continues warm instead of replaying its current rungs from
        cycle 0.  Without this, a JSON-only ``state=`` resume still
        produces identical rows — it just re-pays the replay cycles."""
        self._handle_store = dict(handles)

    @staticmethod
    def _hkey(bi: int, point: Mapping) -> str:
        """Handle-store key: bracket index + canonical point JSON (two
        brackets may carry the same point at different rungs)."""
        return f"{bi}|{json.dumps(point, sort_keys=True)}"

    @staticmethod
    def _bracket_live(br: dict) -> bool:
        cap = br.get("budget")
        return bool(br["alive"]) and (cap is None
                                      or br.get("spent", 0.0) < cap)

    def _live_brackets(self) -> list[dict]:
        return [br for br in self.state.driver["brackets"]
                if self._bracket_live(br)
                and br["rung"] < len(self.horizons)]

    def _done(self) -> bool:
        return not self._live_brackets()

    def _ask(self):
        points, horizons, handles = [], [], []
        segments = []
        for bi, br in enumerate(self.state.driver["brackets"]):
            if not (self._bracket_live(br)
                    and br["rung"] < len(self.horizons)):
                continue
            u = self.horizons[br["rung"]]
            for p in br["alive"]:
                points.append(dict(p))
                horizons.append(u)
                handles.append(self._handle_store.get(self._hkey(bi, p))
                               if self.warm else None)
            segments.append((bi, br, len(br["alive"])))
        self._segments = segments
        return points, horizons, handles

    def _tell(self, points, horizons, rows,
              states: LaneStates | None = None) -> None:
        lo = 0
        for bi, br, n in self._segments:
            seg = list(rows[lo:lo + n])
            seg_points = [dict(p) for p in points[lo:lo + n]]
            if self._costs is not None:   # per-bracket spend tracking
                br["spent"] = float(br.get("spent", 0.0)
                                    + sum(self._costs[lo:lo + n]))
            if self.warm:
                # this rung's handles are consumed: promoted points get
                # fresh rung-end states below, dropped points never run
                pref = f"{bi}|"
                for k in [k for k in self._handle_store
                          if k.startswith(pref)]:
                    del self._handle_store[k]
            last_rung = br["rung"] >= len(self.horizons) - 1
            if last_rung:
                keep, order = 0, []
                br["alive"] = []         # final rung: recorded, retired
            else:
                keep = max(1, math.ceil(n / self.eta))
                order = self.objective.order(seg)
                br["alive"] = [seg_points[i] for i in order[:keep]]
                if self.warm and states is not None:
                    for i in order[:keep]:
                        gi = lo + i
                        self._handle_store[
                            self._hkey(bi, seg_points[i])] = \
                            states.handle(gi, horizons[gi])
            if BUS.active:
                # warm-vs-cold cost: `spent` is what this rung actually
                # charged (warm lanes pay increments); `replay_cycles`
                # is what a replay-from-zero rung would have cost
                replay = 0.0
                for row in seg:
                    try:
                        replay += float(row.get("virtual_time",
                                                self.horizons[br["rung"]]))
                    except (TypeError, ValueError):
                        replay += float(self.horizons[br["rung"]])
                BUS.emit(
                    "rung.promote", bracket=bi, rung=br["rung"],
                    horizon=self.horizons[br["rung"]], n=n,
                    promoted=keep if not last_rung else 0,
                    dropped=n - keep if not last_rung else n,
                    warm=self.warm, final=last_rung,
                    spent=(float(sum(self._costs[lo:lo + n]))
                           if self._costs is not None else None),
                    replay_cycles=replay,
                    bracket_spent=br.get("spent", 0.0),
                    bracket_budget=br.get("budget"),
                    promoted_points=[seg_points[i] for i in order[:keep]]
                    [:8])
            br["rung"] += 1
            lo += n
        self._segments = None
