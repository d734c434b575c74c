"""repro_torch.dse — batched design-space exploration over the engine.
Counterpart of ``repro.dse``:

  * :mod:`~repro_torch.dse.sweep`    — ``SweepSpec`` (grid / random /
    explicit design points; traced, ``static.*`` and ``shape.*`` axes;
    eager path validation) and param-batch stacking;
  * :mod:`~repro_torch.dse.family`   — ``TopologyFamily``: one padded
    maximum-shape build whose sub-shapes are selected by activity masks;
  * :mod:`~repro_torch.dse.runner`   — ``BatchRunner`` / ``run_sweep``:
    lane-batched blocks of the engine (a captured CUDA graph per ladder
    rung on the card) with per-lane horizons, rounds with lane
    compaction and the depth-2 pipeline, optionally sharded over a mesh
    of placements (``shard=``) with globally-rebalanced compaction;
  * :mod:`~repro_torch.dse.cache`    — the campaign cache: a
    cross-process artifact store for the autotuned rung, the rung sets
    sweeps used and family shape unions, so the second process of a
    campaign repeats the first one's choices without probing (the
    reference's persisted executables have no counterpart);
  * :mod:`~repro_torch.dse.schedule` — the chunk ladder, epoch-quantum
    policy and the one-shot chunk-size autotuner behind ``run_rounds``;
  * :mod:`~repro_torch.dse.mux`      — ``LaneMux``: several sweep jobs'
    lanes in shared round batches, fair round-robin refill, per-job rows;
  * :mod:`~repro_torch.dse.report`   — tidy rows, ``dominates`` /
    Pareto-front extraction and JSON/CSV export;
  * :mod:`~repro_torch.dse.search`   — closed-loop search drivers
    (``SuccessiveHalving``, ``BatchBO``, ``RandomSearch``) that pick
    points and horizons between rounds under a simulated-cycle budget,
    with resumable ``SearchState`` and rung checkpoints.
"""
from . import cache
from .cache import configure as configure_cache
from .family import TopologyFamily
from .mux import LaneMux, MuxJob
from .report import (dominates, format_table, pareto_front, score_vector,
                     tidy, to_csv, to_json)
from .runner import (BatchRunner, LaneStates, ResumeHandle,
                     default_extract, extract_rows, lane,
                     memoize_build, run_sweep, runner_for,
                     stack_state_list, stack_states)
from .schedule import ChunkAutotuner, ChunkSchedule, auto_schedule, \
    make_ladder
from .search import (BatchBO, Objective, RandomSearch, SearchDriver,
                     SearchResult, SearchState, SuccessiveHalving,
                     horizon_ladder, load_search, run_search, save_search)
from .sweep import (SweepSpec, apply_point, axis_error, build_param_batch,
                    split_shape, stack_params, valid_axes)

__all__ = [
    "cache", "configure_cache",
    "SweepSpec", "apply_point", "axis_error", "valid_axes",
    "build_param_batch", "stack_params", "split_shape", "TopologyFamily",
    "BatchRunner", "run_sweep", "stack_states", "stack_state_list", "lane",
    "default_extract", "extract_rows", "runner_for", "memoize_build",
    "ResumeHandle", "LaneStates", "LaneMux", "MuxJob",
    "ChunkSchedule", "ChunkAutotuner", "auto_schedule", "make_ladder",
    "SearchDriver", "SearchState", "SearchResult", "Objective",
    "run_search", "SuccessiveHalving", "horizon_ladder", "BatchBO",
    "RandomSearch", "save_search", "load_search",
    "pareto_front", "dominates", "score_vector", "tidy", "to_csv",
    "to_json", "format_table",
]
