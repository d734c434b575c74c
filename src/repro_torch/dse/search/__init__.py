"""repro_torch.dse.search — closed-loop design-space search over batched
sweeps.  Counterpart of ``repro.dse.search``.

Exhaustive grids are the naive DSE workflow; this package closes the
loop: a :class:`SearchDriver` picks the next design points *and their
horizons* between rounds (``ask()`` → ``tell(rows)``), and every round
executes through :func:`~repro_torch.dse.runner.run_sweep`'s round-based
streaming path — lane-batched blocks, per-lane horizons, the chunk
ladder, no new capture after warmup (builds are memoized across rounds via
:func:`~repro_torch.dse.runner.memoize_build`).  Budget is accounted in
*simulated cycles*; :class:`SearchState` makes a search resumable and
JSON-serializable mid-flight.

Drivers:

* :class:`SuccessiveHalving` — ASHA-style: run wide at short horizons,
  promote the top ``1/eta`` to geometrically longer ones (the horizon
  ladder); optional Hyperband-style brackets mix horizons in one round.
* :class:`BatchBO` — dependency-free batched Bayesian optimization
  (numpy RBF surrogate, batched Thompson sampling, qEI or UCB over a
  :meth:`SweepSpec.random` candidate pool) for continuous axes.
* :class:`RandomSearch` — the no-model baseline.

See DSE.md "Search".  Rung checkpoints: :mod:`.warm`.
"""
from .bo import BatchBO, RandomSearch
from .driver import (Objective, SearchDriver, SearchResult, SearchState,
                     run_search)
from .halving import SuccessiveHalving, horizon_ladder
from .warm import load_search, ref_leaves, ref_unflatten, save_search

__all__ = [
    "Objective", "SearchDriver", "SearchResult", "SearchState",
    "run_search", "SuccessiveHalving", "horizon_ladder", "BatchBO",
    "RandomSearch", "save_search", "load_search",
]
