"""The JAX package's side of the sharded lanes' parity
(``tests/test_torch_sharded.py``) and of one pinned constant of
``chip_smoke.py``.

``lanes_trace(pkg)`` runs the same lane cases through either package
(``"repro"`` or ``"repro_torch"``) on a mesh of 2 placements and returns
what a sharded run shows: every row, the round events (``rounds.start``
with its aligned ladder, each ``round.end`` and ``shard.rebalance``,
``rounds.end``; timings dropped), the ``dse.shard.lanes_moved`` count and
the (batch, placements) keys of every batch run, the padded ones
included.  The quantum is held fixed (it otherwise grows with the host's
clock), so every round is the same in both packages.  The JAX side's
trace is pinned in ``tests/_shard_lanes_ref.json`` (about 2.5 min on a
CPU, mostly XLA compiles: too long for the suite).  It is made in a
process with 2 forced host devices, as the reference's
``tests/dse/test_sharded.py`` runs it:

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=2 \\
        PYTHONPATH=src python tests/_shard_refs.py --lanes \\
        > tests/_shard_lanes_ref.json

``memsys64_trimmed()`` makes chip_smoke.py's MEMSYS64_TRIMMED, the JAX
package's row of memsys at 64 cores x 64 requests (mixed, the build's
defaults; about 15 s on a CPU):

    JAX_PLATFORMS=cpu PYTHONPATH=src python tests/_shard_refs.py --memsys64
"""
from __future__ import annotations

import importlib
import json
import sys

# event fields that read the host's clock or count the package's own
# compiles: not part of the comparison
CLOCK = ("ts", "seq", "dur", "host_s", "wait_s", "overlap_frac",
         "trace_count")
ROUND_EVENTS = ("rounds.start", "round.end", "shard.rebalance", "rounds.end")


def _events(sink):
    return [{k: v for k, v in e.items() if k not in CLOCK}
            for e in sink.events if e["kind"] in ROUND_EVENTS]


def lanes_trace(pkg: str) -> dict:
    """The lane cases through package ``pkg`` at 2 placements: rows, round
    events, lanes moved and batch keys, as JSON-ready values."""
    import numpy as np
    dse = importlib.import_module(f"{pkg}.dse")
    memsys = importlib.import_module(f"{pkg}.sims.memsys")
    bus = importlib.import_module(f"{pkg}.obs.bus")
    kw = {"device": "cpu"} if pkg == "repro_torch" else {}

    class Fixed(dse.ChunkSchedule):
        """A schedule whose quantum does not grow with round timings."""
        def grow_quantum(self, *a, **k):
            pass

    def counter():
        return bus.BUS.metrics.counter("dse.shard.lanes_moved").value

    out = {}
    sim, st = memsys.build(n_cores=2, pattern="mixed", n_reqs=12,
                           donate=False, **kw)
    # one runner: every (batch, placements) is built once
    r = dse.BatchRunner(sim)
    B = 32
    pb = dse.build_param_batch(
        sim, [{"conn_latency[-1]": float(10 + i)} for i in range(B)])
    # even lanes stop early, odd lanes run long: survivors re-pack over
    # many rounds; the unaligned ladder aligns up to (16, 8)
    u = np.where(np.arange(B) % 2 == 0, 100.0, 600.0).astype(np.float32)
    m0 = counter()
    with bus.capture() as sink:
        o = r.run_rounds(st, pb, u, shard=2,
                         schedule=Fixed(ladder=(15, 7), quantum=16,
                                        min_round_s=0.0))
    out["rebalance"] = dict(rows=dse.extract_rows(sim, o, B),
                            events=_events(sink), moved=counter() - m0)

    B = 65
    pb = dse.build_param_batch(
        sim, [{"conn_latency[-1]": float(10 + (i % 7) * 5)}
              for i in range(B)])
    u = np.linspace(40.0, 240.0, B).astype(np.float32)
    mono = r.run_batch(dse.stack_states(st, B), pb, u, shard=True)
    last_shard = r.last_shard
    m0 = counter()
    with bus.capture() as sink:
        o = r.run_rounds(st, pb, u, shard=2,
                         schedule=Fixed(ladder=(33, 15), quantum=32,
                                        min_round_s=0.0))
    keys = r.made if pkg == "repro_torch" else r._fns
    out["b65"] = dict(
        mono_rows=dse.extract_rows(sim, mono, B),
        rows=dse.extract_rows(sim, o, B), events=_events(sink),
        moved=counter() - m0, last_shard=last_shard,
        keys=sorted([int(k[0]), int(k[1])] for k in keys
                    if all(isinstance(x, int) for x in k)))
    return json.loads(json.dumps(out))


def memsys64_trimmed() -> dict:
    """MEMSYS64_TRIMMED: the JAX package's row of one memsys run at 64
    cores x 64 requests, mixed, to completion."""
    from repro.dse.runner import default_extract
    from repro.sims.memsys import build
    sim, st = build(n_cores=64, pattern="mixed", n_reqs=64)
    return dict(n_cores=64, n_reqs=64, pattern="mixed",
                **default_extract(sim, sim.run(st, until=1e6)))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--lanes"]:
        print(json.dumps(lanes_trace("repro"), sort_keys=True))
    elif sys.argv[1:2] == ["--memsys64"]:
        print("MEMSYS64_TRIMMED = " + json.dumps(memsys64_trimmed()))
    else:
        sys.exit(__doc__)
