"""Batched Bayesian optimization (dependency-free) and random search.
Counterpart of ``repro.dse.search.bo``: host numpy, the same draws from
the same seeded numpy stream.

:class:`BatchBO` fits a Gaussian-process surrogate — an RBF kernel over
axis values normalized to the unit cube, plain numpy Cholesky algebra,
no external optimizer — to the scalarized objective of every trial so
far, then proposes the next *batch* of design points by batched
**Thompson sampling** (one joint posterior draw per batch slot, each
slot takes the draw's argmin — draws differ, so the batch spreads
between exploitation and exploration automatically) or batched **UCB**
(lowest ``mean − beta·std``, best-q distinct) over a fresh candidate
pool drawn with :meth:`SweepSpec.random`.  Everything runs host-side
between rounds on tiny matrices (history × pool); the simulated rounds
themselves go through the same lane-batched ``run_sweep`` path as any
sweep.

Axis encodings (the surrogate's coordinates, shared with sampling via
:func:`~repro_torch.dse.sweep.parse_axis_spec`): ``(lo, hi)`` ranges — float
or inclusive int — map affinely to [0, 1]; ``(lo, hi, 'log')`` ranges
map in log space; choice lists (including ``shape.*`` family axes) map
by ordinal index — neighbouring choices are assumed more alike than
distant ones, the right prior for monotone axes like sizes and counts.

:class:`RandomSearch` is the baseline every search paper demands: the
same loop, a fresh random batch each round, no model.

Both drivers draw per-round sampling seeds from the driver RNG stream
(persisted in :class:`SearchState`), so seeded runs are
bit-reproducible and mid-search resume continues identically.
"""
from __future__ import annotations

import math
import time
from typing import Mapping

import numpy as np

from repro_torch.obs.bus import BUS

from ..sweep import SweepSpec, parse_axis_spec
from .driver import SearchDriver, SearchState


class RandomSearch(SearchDriver):
    """A fresh random batch at a fixed horizon, every round."""

    def __init__(self, axes: dict, objective, *, horizon: float,
                 batch: int = 16, rounds: int = 8, seed: int = 0,
                 cycle_budget: float | None = None,
                 state: SearchState | None = None):
        super().__init__(objective, seed=seed, cycle_budget=cycle_budget,
                         state=state)
        self.axes = dict(axes)
        self.horizon = float(horizon)
        self.batch = int(batch)
        self.rounds = int(rounds)

    @property
    def max_horizon(self) -> float:
        return self.horizon

    def _done(self) -> bool:
        return self.state.round >= self.rounds

    def _ask(self):
        pts = list(SweepSpec.random(self.axes, self.batch,
                                    seed=self._draw_seed()))
        return pts, [self.horizon] * len(pts)


# ---------------------------------------------------------------------------
def _axis_codec(axes: dict):
    """Per-axis encoders onto [0, 1] (the surrogate's unit cube).

    Spec styles come from :func:`~repro_torch.dse.sweep.parse_axis_spec` —
    the same classifier ``SweepSpec.random`` samples with, so encoding
    can never drift from sampling: float and (inclusive-)int ranges map
    affinely, ``'log'`` ranges map in log space, choice lists by
    ordinal index.
    """
    codecs = {}
    for name, spec in axes.items():
        kind, *args = parse_axis_spec(spec)
        if kind == "log":
            lo, hi = math.log(args[0]), math.log(args[1])
            codecs[name] = (lambda v, lo=lo, hi=hi:
                            (math.log(float(v)) - lo) / max(hi - lo, 1e-12))
        elif kind in ("int", "float"):
            lo, hi = float(args[0]), float(args[1])
            codecs[name] = (lambda v, lo=lo, hi=hi:
                            (float(v) - lo) / max(hi - lo, 1e-12))
        else:
            values = args[0]
            index = {c: i for i, c in enumerate(values)}
            k = max(len(values) - 1, 1)
            codecs[name] = (lambda v, index=index, k=k:
                            index[v] / k if v in index else 0.5)
    return codecs


def _rbf(a: np.ndarray, b: np.ndarray, ls: float) -> np.ndarray:
    d2 = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
    return np.exp(-0.5 * d2 / (ls * ls))


_erf = np.vectorize(math.erf)


def _ncdf(z: np.ndarray) -> np.ndarray:
    return 0.5 * (1.0 + _erf(z / math.sqrt(2.0)))


def _npdf(z: np.ndarray) -> np.ndarray:
    return np.exp(-0.5 * z * z) / math.sqrt(2.0 * math.pi)


class BatchBO(SearchDriver):
    """Batched Bayesian optimization over continuous/choice axes.

    ``axes`` uses :meth:`SweepSpec.random` specs.  Round 0 evaluates
    ``batch`` random points (the surrogate needs data); each later round
    refits the GP on all history and proposes ``batch`` points from a
    ``pool``-sized fresh candidate set by ``acquisition`` — ``"ts"``
    (batched Thompson sampling, the default), ``"ucb"``
    (``mean − beta·std``) or ``"qei"`` (greedy constant-liar expected
    improvement: pick the max-EI candidate, append it to the training
    set with a *liar* observation at the incumbent best, refit, repeat
    — each pick's posterior collapses around the previous picks, so
    near-duplicates lose their EI and the batch spreads; the classic
    sequential-simulation qEI approximation).  Exact duplicates of
    evaluated points are excluded from the pool.  ``lengthscale`` is the RBF lengthscale on
    the unit cube; ``noise`` the observation-noise variance (objectives
    here are deterministic simulations — the default is just jitter).
    Multi-objective specs are scalarized (:class:`Objective` weights).
    """

    def __init__(self, axes: dict, objective, *, horizon: float,
                 batch: int = 8, rounds: int = 8, pool: int = 256,
                 acquisition: str = "ts", beta: float = 2.0,
                 lengthscale: float = 0.25, noise: float = 1e-6,
                 seed: int = 0, cycle_budget: float | None = None,
                 state: SearchState | None = None):
        super().__init__(objective, seed=seed, cycle_budget=cycle_budget,
                         state=state)
        assert acquisition in ("ts", "ucb", "qei"), acquisition
        self.axes = dict(axes)
        self.horizon = float(horizon)
        self.batch = int(batch)
        self.rounds = int(rounds)
        self.pool = int(pool)
        self.acquisition = acquisition
        self.beta = float(beta)
        self.lengthscale = float(lengthscale)
        self.noise = float(noise)
        self._codec = _axis_codec(self.axes)

    @property
    def max_horizon(self) -> float:
        return self.horizon

    def _done(self) -> bool:
        return self.state.round >= self.rounds

    # ------------------------------------------------------------------
    def _encode(self, pts) -> np.ndarray:
        return np.asarray([[self._codec[a](p[a]) for a in self.axes]
                           for p in pts], np.float64)

    def _key(self, p: Mapping) -> tuple:
        return tuple(p[a] for a in self.axes)

    def _ask(self):
        if not self.state.history:
            # warmup: the first `batch` *distinct* points of a random
            # pool (choice axes repeat combinations; rerunning an
            # identical deterministic config would be pure waste)
            pts, seen = [], set()
            for p in SweepSpec.random(self.axes,
                                      max(self.pool, self.batch),
                                      seed=self._draw_seed()):
                k = self._key(p)
                if k not in seen:
                    seen.add(k)
                    pts.append(p)
                if len(pts) == self.batch:
                    break
            return pts, [self.horizon] * len(pts)

        hist = self.state.history
        # the pool is deduped against history AND within itself: choice
        # axes repeat combinations, and duplicate candidates would tie
        # on every acquisition value — the batch must be distinct
        # *points*, not distinct pool indices
        seen = {self._key(t) for t in hist}
        cand = []
        for p in SweepSpec.random(self.axes, self.pool,
                                  seed=self._draw_seed()):
            k = self._key(p)
            if k not in seen:
                seen.add(k)
                cand.append(p)
        if not cand:
            return None
        x = self._encode(hist)
        y = np.asarray([self.objective.scalar(t) for t in hist], np.float64)
        finite = np.isfinite(y)
        if finite.any():
            worst = y[finite].max()
            y = np.where(finite, y, worst)       # failed trials = worst
        else:
            y = np.zeros_like(y)
        mu0, sd0 = float(y.mean()), float(y.std()) or 1.0
        yn = (y - mu0) / sd0
        p = self._encode(cand)

        q = min(self.batch, len(cand))
        t0 = time.perf_counter()
        if self.acquisition == "qei":
            picks = self._qei(x, yn, p, q)
        else:
            mean, cov = self._posterior(x, yn, p)
            if self.acquisition == "ucb":
                std = np.sqrt(np.clip(np.diag(cov), 1e-12, None))
                picks = list(np.argsort(mean - self.beta * std,
                                        kind="stable")[:q])
            else:
                picks = self._thompson(mean, cov, q)
        if BUS.active:
            BUS.emit("bo.propose", round=self.state.round,
                     acquisition=self.acquisition, history=len(hist),
                     pool=len(cand), batch=q,
                     dur=time.perf_counter() - t0)
        return [dict(cand[i]) for i in picks], [self.horizon] * q

    def _posterior(self, x, yn, p):
        """GP posterior (mean, covariance) at pool ``p`` given unit-cube
        history ``x`` with standardized objectives ``yn``."""
        n = len(x)
        k = _rbf(x, x, self.lengthscale)
        jitter = max(self.noise, 1e-9)
        for _ in range(6):                      # escalate until PD
            try:
                low = np.linalg.cholesky(k + jitter * np.eye(n))
                break
            except np.linalg.LinAlgError:
                jitter *= 10.0
        else:
            raise np.linalg.LinAlgError("GP kernel not PD")
        ks = _rbf(x, p, self.lengthscale)
        alpha = np.linalg.solve(low.T, np.linalg.solve(low, yn))
        v = np.linalg.solve(low, ks)
        mean = ks.T @ alpha
        cov = _rbf(p, p, self.lengthscale) - v.T @ v
        return mean, cov

    def _qei(self, x, yn, p, q: int) -> list[int]:
        """Greedy constant-liar qEI over pool ``p``: after each pick the
        picked location enters the training set with the incumbent-best
        value (the *liar*), so the refitted posterior's uncertainty —
        and therefore EI — collapses around it and the next pick lands
        somewhere informative instead of on a near-duplicate.  q small
        Cholesky refits on (history + <q) points: host-side noise."""
        xs, ys = [np.asarray(r) for r in x], list(np.asarray(yn))
        best = float(np.min(yn))
        picks: list[int] = []
        for _ in range(q):
            mean, cov = self._posterior(np.asarray(xs), np.asarray(ys), p)
            std = np.sqrt(np.clip(np.diag(cov), 1e-12, None))
            z = (best - mean) / std
            ei = (best - mean) * _ncdf(z) + std * _npdf(z)
            if picks:
                ei[np.asarray(picks, int)] = -np.inf
            picks.append(int(np.argmax(ei)))     # ties -> lowest index
            xs.append(p[picks[-1]])
            ys.append(best)                      # the constant liar
        return picks

    def _thompson(self, mean, cov, q: int) -> list[int]:
        """One joint posterior draw per batch slot; each slot takes its
        draw's argmin (first unpicked position in that draw's order)."""
        m = len(mean)
        jitter = 1e-9
        for _ in range(6):
            try:
                low = np.linalg.cholesky(cov + jitter * np.eye(m))
                break
            except np.linalg.LinAlgError:
                jitter *= 10.0
        else:
            low = np.diag(np.sqrt(np.clip(np.diag(cov), 1e-12, None)))
        picks: list[int] = []
        for _ in range(q):
            draw = mean + low @ self._rng.standard_normal(m)
            for i in np.argsort(draw, kind="stable"):
                if int(i) not in picks:
                    picks.append(int(i))
                    break
        return picks
