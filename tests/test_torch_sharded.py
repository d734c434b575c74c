"""The port's sharded lanes (``repro_torch.dse`` ``shard=``): the
counterparts of ``tests/dse/test_sharded.py``.

The hard bar, as in the reference: ``shard=`` is a pure *placement*
decision — every row of ``run_batch`` / ``run_rounds`` / ``run_sweep`` /
``run_search`` bit-identical to the single-device path, on every memsys
pattern, on masked family lanes and on mixed-horizon batches.  The
reference reaches a mesh of 2 devices with forced host devices in a
child process; the port reaches 2 placements of the CPU in process with
``REPRO_TORCH_FORCE_DEVICES=2``.  The unsharded rows themselves are held
against the JAX package by ``tests/test_torch_dse_*.py``; the sharded
runs' rows, round events (the aligned ladder, each round's lanes moved
between slots), counter and padded batches are held against the JAX
package's own sharded runs at 2 forced host devices, pinned by
``tests/_shard_refs.py`` in ``tests/_shard_lanes_ref.json``.
"""
import functools
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from _shard_refs import lanes_trace
from _torch_sim_parity import one_torch_thread  # noqa: F401

import repro_torch.dse.runner as runner_mod
from repro_torch.core import pdes
from repro_torch.core.engine import tree_leaves
from repro_torch.dse import (BatchRunner, ChunkSchedule, Objective,
                             SuccessiveHalving, SweepSpec,
                             build_param_batch, extract_rows, run_search,
                             run_sweep, stack_states)
from repro_torch.dse.runner import _align_up, _shard_devices
from repro_torch.sims.memsys import build, build_family

CPU = torch.device("cpu")
JAX_LANES = Path(__file__).with_name("_shard_lanes_ref.json")


def _build(pattern="mixed", n_reqs=6):
    return build(n_cores=2, pattern=pattern, n_reqs=n_reqs, donate=False,
                 device="cpu")


@pytest.fixture
def two(monkeypatch):
    """Two placements of the CPU."""
    monkeypatch.setenv(pdes.FORCE_DEVICES_ENV, "2")


@functools.cache
def _port_lanes():
    """The port's side of ``_shard_refs.lanes_trace`` at 2 placements of
    the CPU (run once for the tests that read it)."""
    mp = pytest.MonkeyPatch()
    mp.setenv(pdes.FORCE_DEVICES_ENV, "2")
    try:
        return lanes_trace("repro_torch")
    finally:
        mp.undo()


@functools.cache
def _jax_lanes():
    return json.loads(JAX_LANES.read_text())


def _same(a, b):
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert x.dtype == y.dtype and x.shape == y.shape
        if x.dtype == torch.float32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# single-placement contracts
# ---------------------------------------------------------------------------
def test_shard_devices_normalization(monkeypatch):
    monkeypatch.delenv(pdes.FORCE_DEVICES_ENV, raising=False)
    assert _shard_devices(False, CPU) == 1
    assert _shard_devices(0, CPU) == 1
    assert _shard_devices(None, CPU) == 1
    assert _shard_devices(True, CPU) == 1       # one CPU placement
    assert _shard_devices(1, CPU) == 1
    assert _shard_devices(999, CPU) == 1        # clamped to the host
    monkeypatch.setenv(pdes.FORCE_DEVICES_ENV, "3")
    assert _shard_devices(True, CPU) == 3
    assert _shard_devices(2, CPU) == 2
    assert _shard_devices(999, CPU) == 3
    assert _align_up(65, 2) == 66 and _align_up(64, 2) == 64
    assert _align_up(5, 1) == 5


def test_tuned_top_keyed_on_device_count_not_shard_flag():
    """shard=False and shard=1 are the same topology (one placement) and
    share the autotuned rung slot; nothing is keyed on a bool."""
    sim, st = _build()
    r = BatchRunner(sim)
    r._tuned_top[1] = 8          # pretend a 1-placement autotune ran
    B = 16
    pb = build_param_batch(
        sim, [{"conn_latency[-1]": float(10 + i)} for i in range(B)])
    r.run_rounds(st, pb, 80.0, shard=False)
    assert r.last_rounds["chunk"] == 8       # consumed the d=1 slot
    r.run_rounds(st, pb, 80.0, shard=1)
    assert r.last_rounds["chunk"] == 8       # same slot, no re-probe
    assert set(r._tuned_top) == {1}
    assert all(isinstance(k, int) for k in r._tuned_top)


def test_single_device_shard_rows_identical(monkeypatch):
    """With one placement, shard=True runs the same block as the plain
    path: identical results and no new block."""
    monkeypatch.delenv(pdes.FORCE_DEVICES_ENV, raising=False)
    sim, st = _build()
    r = BatchRunner(sim)
    pb = build_param_batch(
        sim, [{"conn_latency[-1]": float(v)} for v in (10, 20, 30)])
    a = r.run_batch(stack_states(st, 3), pb, 2000.0, shard=False)
    n = r.trace_count
    b = r.run_batch(stack_states(st, 3), pb, 2000.0, shard=True)
    assert r.trace_count == n and r.made == {(3, 1)}
    _same(a, b)


# ---------------------------------------------------------------------------
# two placements: bit-identity across every layer + padding
# ---------------------------------------------------------------------------
def test_rounds_and_batch_b65_two_placements(two):
    """B=65 with mixed horizons: ``run_rounds`` under the mesh and the
    monolithic sharded ``run_batch`` equal the unsharded ``run_batch``
    and the JAX package's sharded runs, row for row; every sharded batch
    is even, and the monolithic one ran padded to 66 (33 lanes a
    placement), with the same (batch, placements) keys, round events (a
    ladder (33, 15) aligned up to (34, 16)) and lanes moved as in the JAX
    package."""
    sim, st = _build(n_reqs=12)
    B = 65
    pb = build_param_batch(sim, [{"conn_latency[-1]": float(10 + (i % 7)
                                                            * 5)}
                                 for i in range(B)])
    u = np.linspace(40.0, 240.0, B).astype(np.float32)
    ref = extract_rows(sim, BatchRunner(sim).run_batch(
        stack_states(st, B), pb, u), B)
    got, want = _port_lanes()["b65"], _jax_lanes()["b65"]
    assert got["rows"] == ref and got["mono_rows"] == ref
    assert got == want
    assert got["last_shard"] == 2
    assert all(b % 2 == 0 and d == 2 for b, d in got["keys"]), got["keys"]
    assert [66, 2] in got["keys"]
    rs = [e for e in got["events"] if e["kind"] == "rounds.start"]
    assert rs[0]["shard"] == 2 and rs[0]["ladder"] == [34, 16]


def test_sweep_five_patterns_two_placements(two):
    """``run_sweep`` over all five memsys patterns as static groups with
    mixed horizons: rows identical with and without the mesh."""
    spec = SweepSpec.grid({
        "static.pattern": ["compute", "stream", "pointer", "idle_half",
                           "mixed"],
        "conn_latency[-1]": [10.0, 25.0],
        "kind.core.think_scale": [1.0, 1.5]})

    def bf(pattern="mixed"):
        return _build(pattern, n_reqs=3)
    u = np.linspace(40.0, 200.0, len(spec)).astype(np.float32)
    assert run_sweep(bf, spec, until=u) == \
        run_sweep(bf, spec, until=u, shard=True)


def test_family_lanes_two_placements(two):
    """Masked family lanes (``shape.core``) under the mesh: identical."""
    fspec = SweepSpec.grid({"shape.core": [1, 2],
                            "kind.core.think_scale": [1.0, 1.4]})

    def fb(shape=None):
        return build_family(shape=shape, n_cores=2, pattern="mixed",
                            n_reqs=4, donate=False, device="cpu")
    fu = np.linspace(200.0, 700.0, len(fspec)).astype(np.float32)
    assert run_sweep(fb, fspec, until=fu) == \
        run_sweep(fb, fspec, until=fu, shard=True)


def test_search_two_placements(two):
    """A seeded halving ``run_search`` follows the same trajectory under
    the mesh."""
    def search(shard):
        pool = SweepSpec.grid({"conn_latency[-1]": [10.0, 20.0, 30.0, 40.0],
                               "kind.core.think_scale": [1.0, 1.5]})
        drv = SuccessiveHalving(pool, Objective("virtual_time"),
                                max_horizon=800.0, min_horizon=200.0,
                                eta=2, seed=7)
        return run_search(lambda: _build(n_reqs=4), drv, shard=shard)
    a, b = search(False), search(True)
    assert a.rows == b.rows and a.best == b.best


def test_rows_identical_on_two_devices(monkeypatch):
    """A lane mesh of two distinct devices (the CPU named two ways): each
    half of every batch runs on its own twin of the simulation, and the
    state comes back by bits."""
    mesh = (CPU, torch.device("cpu", 0))
    monkeypatch.setenv(pdes.FORCE_DEVICES_ENV, "2")
    monkeypatch.setattr(runner_mod, "lane_mesh",
                        lambda n, device=None: mesh[:n])
    sim, st = _build()
    B = 5
    pb = build_param_batch(sim, [{"conn_latency[-1]": float(10 + 3 * i)}
                                 for i in range(B)])
    u = np.linspace(80.0, 200.0, B).astype(np.float32)
    r = BatchRunner(sim)
    ref = r.run_batch(stack_states(st, B), pb, u)
    out = r.run_rounds(st, pb, u, shard=2,
                       schedule=ChunkSchedule(ladder=(4, 2), quantum=64,
                                              min_round_s=0.0))
    _same(ref, out)
    assert set(sim._twins) == {mesh[1]}
    assert sim._twins[mesh[1]]._lane_blocks      # its own blocks


def test_rebalance_telemetry_two_placements(two):
    """Under the mesh, survivors re-pack globally each round; the
    ``shard.rebalance`` events report the lanes that changed slot: the
    same (round, moved, lanes) sequence, round events, rows and
    ``dse.shard.lanes_moved`` count as the JAX package's, on a ladder
    (15, 7) that aligns up to (16, 8)."""
    got, want = _port_lanes()["rebalance"], _jax_lanes()["rebalance"]
    rb = lambda t: [(e["round"], e["moved"], e["lanes"])
                    for e in t["events"] if e["kind"] == "shard.rebalance"]
    assert rb(got) == rb(want)
    assert got == want
    ev = [e for e in got["events"] if e["kind"] == "shard.rebalance"]
    assert ev and all(e["shards"] == 2 for e in ev)
    assert sum(e["moved"] for e in ev) > 0, ev
    assert got["moved"] == sum(e["moved"] for e in ev)
    rs = [e for e in got["events"] if e["kind"] == "rounds.start"]
    assert rs and rs[0]["shard"] == 2 and rs[0]["ladder"] == [16, 8]
