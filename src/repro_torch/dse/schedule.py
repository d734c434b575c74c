"""Round scheduling for straggler-free batched sweeps (DSE.md).  A copy of
``repro.dse.schedule``: pure policy, so nothing changes on the port, where
each rung's executable is a captured lane-batched block (a CUDA graph on
the card) instead of an XLA compile.

A monolithic vmapped batch runs every lane until the *slowest* lane's
horizon: finished lanes keep burning full masked epochs, so at B=256 the
batch can fall below sequential shared-jit throughput.  The runner breaks
a sweep into *rounds* instead — run a bounded epoch quantum, pull the
cheap per-lane liveness vector to host, compact the surviving lanes into
the next rung of a geometric **chunk ladder** and refill from the
pending-config queue.  This module owns the policy side of that loop:

* :func:`make_ladder` — the descending geometric rung sizes.  Every rung
  compiles once (executables are cached per batch size), so arbitrary B
  streams through a handful of cached programs with zero recompiles
  after warmup.
* :class:`ChunkSchedule` — ladder + epoch quantum + autotune switches.
  The quantum is *adaptive upward*: when a round's total cost — device
  wall time **plus the host-side harvest/compact/assembly time the
  runner reports** — falls under ``min_round_s``, or when host work
  dominates the device step outright, the quantum doubles (bounded), so
  round overhead stays amortized on any workload without retuning.
  Counting host time matters under pipelining (ENGINE_PERF.md "Round
  pipelining"): a short quantum used to look free because only the
  device step was credited, even when per-round host bookkeeping was
  the actual bottleneck.  Quantum and ladder choices never change
  results — lanes are independent under vmap and freeze bit-exactly at
  their own horizons — they only move wall-clock.
* :class:`ChunkAutotuner` — a one-shot probe of 2–3 ladder rungs on the
  first quanta, picking the rung with the best measured lane throughput.
  The probe score divides lanes by device time *plus* that round's
  host-side harvest/compact time, so the winner maximizes pipeline
  occupancy — end-to-end round throughput — not just device throughput
  (a wide rung whose harvest gathers dominate the round no longer wins).
  On small hosts the config-axis vmap saturates well below large B
  (DSE.md "Performance"), so the right chunk is often much smaller than
  the sweep; probing is real work (probe lanes advance normally), so it
  costs only the timing, not replayed simulation.
"""
from __future__ import annotations

import dataclasses

MIN_RUNG = 8          # smallest ladder rung worth its own executable
MAX_TOP = 256         # default ladder top (probe downward from here)
DEFAULT_QUANTUM = 128         # epochs per round before a liveness pull
MAX_QUANTUM = 1 << 20
AUTOTUNE_MIN_B = 64   # below this, probing costs more than it saves


def make_ladder(b: int, top: int | None = None, min_rung: int = MIN_RUNG,
                factor: int = 2) -> tuple[int, ...]:
    """Descending geometric rung sizes for a B-point sweep.

    The top rung is ``min(b, top)`` (default ``MAX_TOP``); below it the
    sizes divide by ``factor`` down to ``min_rung``.  Rungs never exceed
    ``b`` — a 5-point sweep gets the single rung ``(5,)``.  ``top`` /
    ``min_rung`` values below 1 clamp to 1 (a zero or negative chunk
    request degenerates to lane-at-a-time, it never hangs or raises).
    """
    assert b >= 1 and factor >= 2
    t = max(1, min(b, MAX_TOP if top is None else int(top)))
    mr = max(1, min(int(min_rung), t))
    rungs = [t]
    while rungs[-1] // factor >= mr:
        rungs.append(rungs[-1] // factor)
    return tuple(rungs)


@dataclasses.dataclass
class ChunkSchedule:
    """Ladder, quantum and autotune policy for one round-based run.

    ``ladder`` — descending chunk sizes; each rung that gets used
    compiles one executable (cached on the runner).  ``quantum`` —
    engine epochs each lane may advance per round; adaptively doubled
    while rounds finish faster than ``min_round_s`` so host-side round
    overhead stays negligible.  ``autotune`` — probe the top
    ``probe_rungs`` rungs on the first quanta and keep the fastest
    (:class:`ChunkAutotuner`); the choice is cached per runner so later
    calls (and the timed leg of a benchmark) skip the probe.
    """

    ladder: tuple[int, ...]
    quantum: int = DEFAULT_QUANTUM
    autotune: bool = False
    probe_rungs: int = 3
    min_round_s: float = 0.05

    def __post_init__(self):
        assert self.ladder and list(self.ladder) == sorted(
            self.ladder, reverse=True), "ladder must be descending"
        self.quantum = int(self.quantum)

    @property
    def top(self) -> int:
        return self.ladder[0]

    def size_for(self, want: int) -> int:
        """Smallest rung that fits ``want`` lanes (the top rung if none
        does) — survivors compact down the ladder as the sweep drains."""
        fit = [r for r in self.ladder if r >= want]
        return fit[-1] if fit else self.top

    def narrowed(self, top: int) -> "ChunkSchedule":
        """This schedule with the ladder trimmed to ``top`` (the
        autotuner's winning rung) and probing switched off."""
        ladder = tuple(r for r in self.ladder if r <= top) or (top,)
        return dataclasses.replace(self, ladder=ladder, autotune=False)

    def grow_quantum(self, round_dt: float, host_dt: float = 0.0,
                     steps: int = 1) -> None:
        """Adaptive quantum policy: grow while rounds are cheap *in
        total* — device step plus the host-side harvest/compact/assembly
        time (``host_dt``) the runner measured for the round — or while
        host work dominates the device step (then a bigger quantum
        amortizes the fixed per-round bookkeeping and raises pipeline
        occupancy).  ``steps`` bounds the doublings per observation and
        is the caller's pipeline depth: with depth d, d rounds are
        dispatched at a stale quantum before the next measurement
        arrives, so a double-per-observation ramp would pay every
        intermediate quantum d times over — d doublings per observation
        keeps the ramp's *round count* equal to the sequential loop's.
        Growth past the first doubling is predictive (the device step
        scales ~linearly with the quantum while the host side barely
        does, so the measured round is extrapolated before each extra
        doubling); at ``steps=1`` the policy is exactly the sequential
        one-doubling-per-cheap-round rule."""
        for _ in range(max(1, int(steps))):
            if self.quantum >= MAX_QUANTUM or not (
                    (round_dt + host_dt) < self.min_round_s
                    or host_dt > round_dt):
                return
            self.quantum *= 2
            round_dt *= 2.0


def auto_schedule(b: int, quantum: int | None = None,
                  chunk: int | None = None,
                  autotune: bool | None = None) -> ChunkSchedule:
    """The default policy for a B-point sweep.

    ``chunk`` pins the ladder top (no probing); otherwise sweeps big
    enough to amortize a probe (``b >= AUTOTUNE_MIN_B``) autotune the
    top rung, small ones just run at ``b``.
    """
    if chunk is not None:
        return ChunkSchedule(make_ladder(b, top=int(chunk)),
                             quantum=quantum or DEFAULT_QUANTUM)
    tune = (b >= AUTOTUNE_MIN_B) if autotune is None else autotune
    return ChunkSchedule(make_ladder(b), quantum=quantum or DEFAULT_QUANTUM,
                         autotune=tune)


class ChunkAutotuner:
    """One-shot rung probe: measure lane throughput at 2–3 rung sizes,
    keep the best.

    For each candidate rung the runner executes two rounds at that size:
    the first is the compile/warmup round (untimed), the second is timed.
    ``lanes / (dt + host_dt)`` at a fixed quantum is directly
    proportional to end-to-end configs/sec for uniform lanes — the
    denominator is the round's *total* cost, device step plus the
    host-side harvest/compact work the rung caused, so the winner is the
    rung with the best pipeline occupancy rather than the widest device
    dispatch.  Every probed round is *real* sweep progress — survivors
    flow back into the normal round loop — so the probe's only cost is
    running briefly at a sub-optimal width.
    """

    def __init__(self, schedule: ChunkSchedule, fillable: int):
        # probe the largest rungs first; a rung is only probeable while
        # enough live lanes (pool survivors + pending queue) can fill it
        self.candidates = [r for r in schedule.ladder[:schedule.probe_rungs]
                           if r <= fillable]
        self.rates: dict[int, float] = {}
        self._warmed: set[int] = set()

    def next_probe(self, fillable: int) -> int | None:
        """The rung to run the next probe round at, or ``None`` when
        probing is done (all candidates measured or starved of lanes).
        ``fillable`` counts every lane that could fill the rung — pool
        survivors *plus* the pending queue (round one typically drains
        the queue into lanes, so survivors must count or every rung
        below the top starves unprobed)."""
        for r in self.candidates:
            if r not in self.rates and (r in self._warmed or r <= fillable):
                return r
        return None

    def record(self, rung: int, dt: float, lanes: int | None = None,
               host_dt: float = 0.0) -> None:
        """Record a probe round.  ``lanes`` is the number of *live* lanes
        the round ran (zero-horizon padding executes no epochs and must
        not be credited as throughput); ``host_dt`` is the host-side
        harvest/compact/assembly time the round cost — part of the score,
        so a rung that is fast on device but expensive to compact does
        not win."""
        if rung in self._warmed:
            self.rates[rung] = (rung if lanes is None else lanes) \
                / max(dt + host_dt, 1e-9)
        else:
            self._warmed.add(rung)   # first (compile) round is untimed

    def best(self, default: int) -> int:
        if not self.rates:
            return default
        return max(self.rates, key=lambda r: self.rates[r])
