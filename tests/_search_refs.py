"""The JAX package's results behind ``chip_smoke.py``'s phase 9: SEARCH_REF,
SEARCH64_REF and BO_REF.  It runs chip_smoke.py's own procedures
(``halving``, ``bo_driver``, ``search_extract``, ``search_summary``) on
``repro.dse`` and ``repro.sims.memsys``, on the CPU:

    JAX_PLATFORMS=cpu PYTHONPATH=src python tests/_search_refs.py a c b

``a``: the exhaustive 192-point sweep and the search of
benchmarks/search_convergence.py; ``c``: the BatchBO and RandomSearch
trajectories; ``b``: the 64-core grid's drain times (single runs, spread
over worker processes), MAX_H at 1.1x the slowest rounded up to 100
cycles, and the search.  Each prints a constant to paste into
chip_smoke.py, and its wall time.
"""
from __future__ import annotations

import math
import multiprocessing
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
from _torch_sim_parity import chip_smoke  # noqa: E402


def _drain_times(points):
    """Worker: drain times (virtual time at which every request is done)
    of single 64-core runs at ``points``."""
    import numpy as np
    from repro.dse import apply_point
    from repro.sims.memsys import build
    cs = chip_smoke()
    sim, st = build(**cs.SEARCH64_BUILD, donate=False, super_epoch=4)
    out = []
    for p in points:
        s = sim.run(sim.copy_state(st), 1e7,
                    params=apply_point(sim.default_params(), p))
        assert int(np.sum(np.asarray(s.comp_state["core"]["remaining"]))) \
            == 0, p
        out.append(float(s.time))
    return out


def ref_a(cs, dse, build):
    bf = dse.memoize_build(lambda: build(**cs.SEARCH_BUILD, donate=True,
                                         super_epoch=4))
    sim, st = bf()
    ex = cs.search_extract(st)
    pool = dse.SweepSpec.grid(cs.SEARCH_AXES)
    full = dse.run_sweep(bf, pool, until=cs.SEARCH_MAX_H, extract=ex)
    res = dse.run_search(bf, cs.halving(dse, pool, cs.SEARCH_MAX_H,
                                        cs.SEARCH_RUNGS), extract=ex)
    return dict(exhaustive=cs.exhaustive_summary(full),
                search=cs.search_summary(res, cs.SEARCH_AXES))


def ref_c(cs, dse, build):
    bf = dse.memoize_build(lambda: build(**cs.SEARCH_BUILD, donate=True,
                                         super_epoch=4))
    _, st = bf()
    ex = cs.search_extract(st)
    return {which: cs.search_summary(
        dse.run_search(bf, cs.bo_driver(dse, which), extract=ex),
        cs.BO_AXES) for which in cs.BO_RUNS}


def ref_b(cs, dse, build, workers=4):
    pool = list(dse.SweepSpec.grid(cs.SEARCH64_AXES))
    parts = [pool[i::workers] for i in range(workers)]
    with multiprocessing.get_context("spawn").Pool(workers) as mp:
        got = mp.map(_drain_times, parts)
    drains = [None] * len(pool)
    for i, part in enumerate(got):
        drains[i::workers] = part
    max_h = math.ceil(1.1 * max(drains) / 100.0) * 100.0
    bf = dse.memoize_build(lambda: build(**cs.SEARCH64_BUILD, donate=True,
                                         super_epoch=4))
    _, st = bf()
    res = dse.run_search(bf, cs.halving(dse, pool, max_h,
                                        cs.SEARCH64_RUNGS),
                         extract=cs.search_extract(st))
    return dict(max_h=max_h, drains=drains,
                exhaustive=dict(n=len(pool), optimum=min(drains),
                                budget=sum(drains)),
                search=cs.search_summary(res, cs.SEARCH64_AXES))


def main(which):
    import repro.dse as dse
    from repro.sims.memsys import build
    cs = chip_smoke()
    names = {"a": ("SEARCH_REF", ref_a), "b": ("SEARCH64_REF", ref_b),
             "c": ("BO_REF", ref_c)}
    for w in which:
        name, fn = names[w]
        t = time.perf_counter()
        ref = fn(cs, dse, build)
        print(f"{name} = {ref!r}")
        print(f"# {name}: {time.perf_counter() - t:.1f} s", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:] or ["a", "c", "b"])
