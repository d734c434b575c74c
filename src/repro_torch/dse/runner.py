"""Batched design-space execution: the engine's block over a stacked
:class:`~repro_torch.core.SimParams` batch.  Counterpart of
``repro.dse.runner``; its rows and final states are the reference's bit
for bit.

The reference jits ``jax.vmap`` of the engine's loop per batch size.  Here
one *lane-batched block* (``Simulation.lane_block``: K epochs of every
lane, ``torch.func.vmap`` over the lane axis) stands for that executable:
on the card it is one CUDA graph per ladder rung, captured on first use
over static ``[b]``-lane buffers and replayed; on the CPU it runs eagerly
with the reference's K.  ``trace_count`` counts the blocks a runner made,
so the reference's "no recompiles after warmup" reads "no new capture
after warmup".  The horizon and epoch budget are per-lane buffers: each
lane freezes bit-exactly at its own ``until`` / ``max_epochs`` (the
``torch.where`` of every epoch), so a B=1 batch is bit-identical to the
unbatched engine and results never depend on K.

Execution strategies, as in the reference:

* **Rounds** (``run_rounds``, what ``run_sweep`` uses): a round caps
  every lane at its epochs so far plus the *quantum* and enqueues
  ``ceil(quantum / K)`` replays back to back with no host read between
  them; the capped lanes freeze exactly at their caps.  The round then
  copies the per-lane ``(live, epochs)`` vectors to pinned host memory
  without blocking and records a CUDA event (the counterpart of
  ``copy_to_host_async``), so with the depth-2 pipeline the host
  assembles round k+1 while the card runs round k.  Finished lanes are
  harvested and survivors compacted with ``index_select`` on the device
  into fresh tensors, and refilled from the pending queue down the chunk
  ladder (``repro_torch.dse.schedule``).  The endgame round replays until
  no lane is live.
* **Chunking** (``run_chunked``): fixed-size slabs, the final one padded
  with *zero-horizon* lanes that freeze on entry.
* **Sharding** — ``shard=True`` (or ``shard=<n placements>``) lays the
  batch out as ``[shards, chunk]`` lanes over a 1-D mesh of placements
  (``core.pdes.lane_mesh``: the cards, or N placements of one device
  under ``REPRO_TORCH_FORCE_DEVICES=N``).  Each device runs its slots'
  lanes as one lane-batched block (one CUDA graph a rung) on its own
  twin of the simulation (``Simulation.on_device``); consecutive slots
  of one device share that block.  Lanes are independent, so the rows
  are bit-identical to the single-device path.  Batches that don't
  divide the placement count are padded with zero-horizon lanes that
  freeze on entry.  Under ``run_rounds`` the harvest/compact/refill step
  is *global*: survivors from all shards pool on the host and re-pack
  across shards each round (``shard.rebalance`` telemetry counts the
  lanes that changed slot), and ladder rungs align up to multiples of
  the placement count.

Cold-start cost is covered by ``repro_torch.dse.cache``: ``run_sweep``
opens the campaign cache dir on entry when one is configured, and the
runner persists its warm-start artifacts (autotuned rung, the rungs a
sweep can choose, family shape unions) so a fresh process repeats a previous
process's choices and captures every rung before its first timed round.
The reference's persisted executables have no counterpart (a CUDA graph
cannot be serialised).
* **Donation**: with ``donate=True`` a batch handed to ``run_batch`` is
  marked consumed, as ``Simulation.run`` marks its input; ``stack_states``
  makes fresh per-lane copies, so the template stays reusable.
"""
from __future__ import annotations

import collections
import dataclasses
import functools
import inspect
import math
import time
import weakref
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch.core import SimParams, SimState, check_not_consumed
from repro_torch.core.engine import (host_tensor, tree_leaves, tree_map,
                                     tree_unflatten)
from repro_torch.core.pdes import device_count, device_groups, lane_mesh
from repro_torch.obs.bus import BUS

from . import cache as dse_cache
from .family import TopologyFamily
from .schedule import ChunkSchedule, ChunkAutotuner, auto_schedule
from .sweep import (STATIC_PREFIX, SweepSpec, apply_point,
                    build_param_batch, split_shape, stack_params,
                    stack_trees)

INT32_MAX = np.int32(2**31 - 1)


@dataclasses.dataclass(frozen=True)
class ResumeHandle:
    """A frozen lane's continuation point: the final :class:`SimState` of
    a finished run plus where it stopped.

    The engine's horizon is an absolute per-lane operand and its epoch
    sequence is purely state-determined, so feeding ``state`` back in as
    a lane's initial state and running to a *longer* ``until`` continues
    bit-exactly where the run froze (a resumed lane equals a cold run to
    the same horizon).  ``time`` and ``epochs`` let budget accounting
    charge only the increment and the round loop cap epochs correctly
    from the first round.
    """

    state: SimState
    time: float        # frozen virtual_time
    until: float       # horizon the state was run to
    epochs: int        # engine epochs executed so far


class LaneStates:
    """Lazy per-point access to the final states of a finished sweep.

    ``run_sweep(return_states=True)`` hands every group's stacked final
    state to one of these, reusing the single host transfer the row
    extraction already paid.  Only the lanes a caller actually asks for
    are sliced.  ``handle(i, until)`` packages lane ``i`` as a
    :class:`ResumeHandle` for a later warm resume.
    """

    def __init__(self):
        self._groups: list = []            # host-side stacked trees
        self._where: dict[int, tuple[int, int]] = {}

    def add_group(self, host_tree, indices: Sequence[int]) -> None:
        g = len(self._groups)
        self._groups.append(host_tree)
        for j, i in enumerate(indices):
            self._where[int(i)] = (g, j)

    def __contains__(self, i) -> bool:
        return int(i) in self._where

    def __len__(self) -> int:
        return len(self._where)

    def state(self, i: int) -> SimState:
        g, j = self._where[int(i)]
        return lane(self._groups[g], j)

    def time(self, i: int) -> float:
        g, j = self._where[int(i)]
        return float(self._groups[g].time[j])

    def epochs(self, i: int) -> int:
        g, j = self._where[int(i)]
        return int(self._groups[g].stats.epochs[j])

    def handle(self, i: int, until: float) -> ResumeHandle:
        return ResumeHandle(state=self.state(i), time=self.time(i),
                            until=float(until), epochs=self.epochs(i))


def stack_states(state: SimState, n: int) -> SimState:
    """``n`` independent copies of ``state`` stacked on a new leading axis.

    ``torch.stack`` materializes one fresh buffer per leaf: lanes never
    alias each other or the input, so ``state`` stays reusable as a
    template.
    """
    return tree_map(lambda x: torch.stack([x] * n), state)


def stack_state_list(states: Sequence[SimState]) -> SimState:
    """Stack *distinct* per-lane states (e.g. one per family sub-shape)
    into a batch.  Fresh buffers per leaf, like :func:`stack_states`."""
    return stack_trees(states)


def lane(tree, i: int):
    """Extract config ``i``'s slice from a batched tree (on the device or
    on the host)."""
    return tree_map(lambda x: x[i], tree)


def _take(tree, rows):
    """Lanes ``rows`` (a host index array) of a batched tree, gathered on
    its device into fresh tensors."""
    leaves = tree_leaves(tree)
    dev = leaves[0].device
    ix = host_tensor(np.asarray(rows, np.int64), dev).to(
        dev, non_blocking=True)
    return tree_unflatten(tree, [x.index_select(0, ix) for x in leaves])


def _concat(trees):
    """Batched trees joined along the lane axis (fresh tensors)."""
    if len(trees) == 1:
        return trees[0]
    return tree_map(lambda *xs: torch.cat(xs), trees[0], *trees[1:])


def _to_host(tree):
    """A batched tree on the CPU, moved in one device-to-host transfer: the
    leaves are packed into one byte buffer on the device, copied, and
    unpacked on the host."""
    leaves = tree_leaves(tree)
    if not leaves or leaves[0].device.type == "cpu":
        return tree
    packed = torch.cat([x.contiguous().reshape(-1).view(torch.uint8)
                        for x in leaves]).cpu()
    out, at = [], 0
    for x in leaves:
        n = x.numel() * x.element_size()
        # a clone starts at offset 0, which a wider dtype's view needs
        out.append(packed[at:at + n].clone().view(x.dtype)
                   .reshape(x.shape))
        at += n
    return tree_unflatten(tree, out)


def _on_device(sim, state: SimState) -> SimState:
    """A state (e.g. a host-side :class:`ResumeHandle` state) on the
    simulation's device."""
    return tree_map(lambda x: x.to(sim.device), state)


def default_extract(sim, s: SimState) -> dict:
    """Per-config scalar results: virtual time + engine counters.

    ``run_sweep`` hands this *host-side* lanes (one transfer of the whole
    group, sliced on the host), so the ``float()``/``int()`` casts below
    are free; on a lane on the card each cast would be its own sync.
    """
    return {
        "virtual_time": float(s.time),
        "epochs": int(s.stats.epochs),
        "ticks": int(s.stats.ticks),
        "progress_ticks": int(s.stats.progress_ticks),
        "delivered": int(s.stats.delivered),
    }


def extract_rows(sim, out_b: SimState, n: int,
                 extract: Callable | None = None) -> list[dict]:
    """Extract ``n`` result rows from a batched final state with a single
    device-to-host transfer; lanes are then sliced on the host."""
    extract = extract or default_extract
    host = _to_host(out_b)
    return [extract(sim, lane(host, j)) for j in range(n)]


def _shard_devices(shard, device=None) -> int:
    """Normalize a ``shard`` argument (bool or placement count) to the
    number of mesh placements to span: ``False``/``0`` → 1 (the plain
    path), ``True`` → every placement of ``device``'s kind
    (``core.pdes.device_count``: the visible cards, or
    ``REPRO_TORCH_FORCE_DEVICES``), an int → that many (clamped to what
    there is, never below 1)."""
    if shard is True:
        return device_count(device)
    if not shard:
        return 1
    return max(1, min(int(shard), device_count(device)))


def _align_up(n: int, d: int) -> int:
    """``n`` rounded up to a multiple of ``d``."""
    return -(-int(n) // int(d)) * int(d)


def _horizons(until, max_epochs, b: int) -> tuple[np.ndarray, np.ndarray]:
    """Normalize scalar-or-per-lane horizons to host vectors: [b] f32
    ``until`` and [b] i32 ``max_epochs`` (budgets beyond int32 clamp —
    the engine's epoch counter is i32, so the clamp is exact)."""
    u = np.broadcast_to(np.asarray(until, np.float32), (b,)) \
        .astype(np.float32)
    m = np.broadcast_to(
        np.minimum(np.asarray(max_epochs, np.int64), INT32_MAX)
        .astype(np.int32), (b,)).astype(np.int32)
    return u, m


class BatchRunner:
    """Batched runs over one :class:`Simulation`'s design space.

    Lane-batched blocks are cached on the simulation (and on its twin of
    each device a mesh spans) per (lanes, structure); the horizon and
    epoch budget are per-lane buffers, so neither ``until`` nor
    ``max_epochs`` keys the cache and chunk-ladder rounds never capture
    again after warmup.  ``trace_count`` counts the blocks this runner
    caused to be made (captures on the card, first uses on the CPU);
    ``made`` holds the ``(lanes, placements)`` of every batch it ran, the
    counterpart of the reference's executable keys.
    """

    def __init__(self, sim):
        self.sim = sim
        self.trace_count = 0          # blocks made (captures on the card)
        self.made: set[tuple[int, int]] = set()
        # devices -> autotuned rung: the winning chunk depends on the
        # shard topology (per-placement width is C/d), so a runner reused
        # under a different mesh must not inherit a stale rung
        self._tuned_top: dict[int, int] = {}
        self.last_rounds: dict | None = None    # diagnostics of last run
        self.last_shard = 1           # devices the last run_batch spanned

    # ------------------------------------------------------------------
    def _block(self, sim, states_b: SimState, params_b: SimParams, d: int):
        """The lane-batched block of ``sim`` (the runner's simulation or
        its twin on another device) for this batch, made (and on the card
        captured) on first use of its (lanes, structure)."""
        t0 = time.perf_counter()
        blk, made = sim.lane_block(states_b, params_b)
        if made:
            self.trace_count += 1
            if BUS.active:
                BUS.emit("compile", what="run", b=blk.b, shard=d, n=1,
                         dur=time.perf_counter() - t0)
                BUS.count("dse.compiles", 1)
        return blk

    def _launch(self, sim, states_b: SimState, params_b: SimParams, u, m,
                budget, blocks: int | None, d: int):
        """Load a batch into its block and enqueue ``blocks`` steps with no
        host read between them, or (``None``) step until no lane is live
        with one host read of ``more`` per step, as ``Simulation.run``
        reads ``live``.  On the CPU, where a read costs nothing, stepping
        stops as soon as every lane has stopped.  Returns the block, whose
        buffers hold the result until the next load."""
        blk = self._block(sim, states_b, params_b, d)
        blk.load(states_b, params_b, u, m, budget)
        eager = blk.graph is None
        n = 0
        while blocks is None or n < blocks:
            blk.step()
            n += 1
            if (blocks is None or eager) and not bool(blk.more):
                break
        return blk

    def _dispatch(self, states_b: SimState, params_b: SimParams, u, m,
                  budget=None, blocks: int | None = None, d: int = 1,
                  liveness: bool = True):
        """Run a batch laid out as ``[d, b/d]`` over the lane mesh:
        each device's slots as one block (``_launch``) on the simulation's
        twin there.  Returns the result, stacked on the simulation's
        device in lane order, and the pending liveness copies
        (``_liveness_start``) of every block, or ``None``.  The batch is
        consumed when the simulation donates."""
        if self.sim.donate:
            check_not_consumed(states_b)
        b = len(u)
        self.made.add((b, d))
        self.last_shard = d
        budget = m if budget is None else budget
        if d == 1:                    # the plain path: one block, as is
            blk = self._launch(self.sim, states_b, params_b, u, m, budget,
                               blocks, 1)
            out = self.sim.copy_state(blk.state)
            if self.sim.donate:
                object.__setattr__(states_b, "_consumed", True)
            return out, ([self._liveness_start(blk)] if liveness else None)
        outs, pend = [], []
        for dev, lo, hi in device_groups(
                lane_mesh(d, device=self.sim.device), b):
            sim = self.sim.on_device(dev)
            part = lambda t: tree_map(lambda x: x[lo:hi].to(dev), t)
            blk = self._launch(sim, part(states_b), part(params_b),
                               u[lo:hi], m[lo:hi], budget[lo:hi], blocks, d)
            outs.append(tree_map(lambda x: x.to(self.sim.device),
                                 sim.copy_state(blk.state)))
            if liveness:
                pend.append(self._liveness_start(blk))
        if self.sim.donate:
            object.__setattr__(states_b, "_consumed", True)
        return _concat(outs), (pend if liveness else None)

    def _liveness_start(self, blk):
        """Start the copy of the block's per-lane ``(live, epochs)`` to the
        host without blocking: pinned buffers, ``non_blocking`` copies and
        a CUDA event after them (the reference's ``copy_to_host_async``).
        ``live`` means the lane still has events before its horizon and
        its own epoch budget — the compaction key.  Returns an opaque
        pending handle for :meth:`_liveness_read`."""
        live, ep = blk.live, blk.state.stats.epochs
        if live.device.type != "cuda":
            return (live.clone(), ep.clone(), None, blk.b)
        live_h = torch.empty(live.shape, dtype=live.dtype, pin_memory=True)
        ep_h = torch.empty(ep.shape, dtype=ep.dtype, pin_memory=True)
        live_h.copy_(live, non_blocking=True)
        ep_h.copy_(ep, non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(live.device))
        return (live_h, ep_h, event, blk.b)

    def _liveness_read(self, pending):
        """Blocking half of the liveness pull: wait for the events of the
        :meth:`_liveness_start` calls of a batch's blocks (one a device)
        and join their vectors in lane order.  Returns ``((live, epochs),
        wait_s)`` — ``wait_s`` is the time spent blocked here, which under
        pipelining is (near) zero once the card has finished the round
        while the host did round *k+1*'s work."""
        t0 = time.perf_counter()
        for _, _, event, _ in pending:
            if event is not None:
                event.synchronize()
        out = ((pending[0][0].numpy(), pending[0][1].numpy())
               if len(pending) == 1 else
               tuple(np.concatenate([p[i].numpy() for p in pending])
                     for i in (0, 1)))
        b = sum(p[3] for p in pending)
        dt = time.perf_counter() - t0
        if BUS.active:
            BUS.emit("transfer", what="liveness", b=b, dur=dt)
            BUS.observe("dse.transfer.liveness_s", dt)
        return out, dt

    # ------------------------------------------------------------------
    def run_batch(self, states_b: SimState, params_b: SimParams,
                  until, max_epochs=2_000_000,
                  shard: "bool | int" = False) -> SimState:
        """One lane-batched run of a pre-stacked batch.

        ``until`` and ``max_epochs`` may be scalars (shared by every
        lane) or per-lane vectors of length B — each lane freezes
        bit-exactly at its own horizon / budget (stragglers excepted,
        the block still *steps* until the slowest lane is done; use
        :meth:`run_rounds` to reclaim that waste).

        ``shard`` spans the lane mesh: ``True`` means every placement,
        an int pins the count.  A batch that doesn't divide the placement
        count is padded to the next multiple by repeating the last lane at
        **zero horizon and zero budget** (it freezes on entry, exactly
        like chunk padding) and the padding rows are sliced off the
        result — every placement runs ``ceil(B/d)`` lanes.

        ``states_b`` is consumed when the simulation was built with
        ``donate=True`` (see ``stack_states`` /
        ``Simulation.copy_state``); reusing a consumed batch raises.
        """
        if self.sim.donate:
            check_not_consumed(states_b)
        b = int(params_b.conn_latency.shape[0])
        d = _shard_devices(shard, self.sim.device)
        self.last_shard = d
        u, m = _horizons(until, max_epochs, b)
        pad = _align_up(b, d) - b
        if pad:
            grow = lambda x: torch.cat([x] + [x[-1:]] * pad)
            states_b = tree_map(grow, states_b)
            params_b = tree_map(grow, params_b)
            u = np.concatenate([u, np.zeros(pad, np.float32)])
            m = np.concatenate([m, np.zeros(pad, np.int32)])
        out, _ = self._dispatch(states_b, params_b, u, m, d=d,
                                liveness=False)
        return tree_map(lambda x: x[:b], out) if pad else out

    # ------------------------------------------------------------------
    def run_chunked(self, template: SimState | Sequence[SimState],
                    params_b: SimParams, until,
                    chunk: int | None = None,
                    max_epochs=2_000_000,
                    shard: "bool | int" = False) -> SimState:
        """Run a B-point batch in fixed-size chunks of fresh state stacks.

        ``template`` is either one ``SimState`` (every lane starts from a
        fresh copy of it) or a sequence of B per-lane states (topology
        families: each lane's initial state encodes its sub-shape's
        workload).  ``until`` / ``max_epochs`` may be per-lane vectors.
        All chunks share one block; the final partial chunk is padded by
        repeating its last point with a **zero horizon and zero epoch
        budget** — padding lanes freeze on entry instead of re-simulating
        the tail point at full horizon — and the padding lanes are
        dropped from the result.  Returns the stacked final states in
        point order.
        """
        B = int(params_b.conn_latency.shape[0])
        per_lane = isinstance(template, (list, tuple))
        if per_lane:
            assert len(template) == B, (len(template), B)
        u, m = _horizons(until, max_epochs, B)
        chunk = B if chunk is None else max(1, min(int(chunk), B))
        outs = []
        for lo in range(0, B, chunk):
            hi = min(lo + chunk, B)
            part = tree_map(lambda x: x[lo:hi], params_b)
            pad = chunk - (hi - lo)
            u_p, m_p = u[lo:hi], m[lo:hi]
            if pad:                   # repeat the last point's row shape,
                part = tree_map(      # but freeze it: until=0, budget=0
                    lambda x: torch.cat([x] + [x[-1:]] * pad), part)
                u_p = np.concatenate([u_p, np.zeros(pad, np.float32)])
                m_p = np.concatenate([m_p, np.zeros(pad, np.int32)])
            if per_lane:
                lanes = list(template[lo:hi])
                lanes += [lanes[-1]] * pad
                sb = stack_state_list(lanes)
            else:
                sb = stack_states(template, chunk)
            out = self.run_batch(sb, part, u_p, m_p, shard)
            if pad:
                out = tree_map(lambda x: x[:hi - lo], out)
            outs.append(out)
        return _concat(outs)

    # ------------------------------------------------------------------
    def warm_ladder(self, template: SimState | Sequence[SimState],
                    params_b: SimParams, sizes: Sequence[int],
                    shard: "bool | int" = False) -> None:
        """Make (on the card: capture) the blocks for the given batch sizes
        without advancing any lane: a zero-horizon, zero-budget batch
        steps once and executes no epoch.  Benchmarks use this so a
        drain-phase rung can never capture inside a timed region."""
        d = _shard_devices(shard, self.sim.device)
        t = template[0] if isinstance(template, (list, tuple)) else template
        if self.sim.donate:
            check_not_consumed(t)
        for b in sizes:
            b = _align_up(b, d)
            pb = tree_map(lambda x: torch.stack([x[0]] * b), params_b)
            _, pend = self._dispatch(stack_states(t, b), pb,
                                     np.zeros(b, np.float32),
                                     np.zeros(b, np.int32), d=d)
            self._liveness_read(pend)

    # ------------------------------------------------------------------
    def run_rounds(self, template: SimState | Sequence[SimState],
                   params_b: SimParams, until,
                   schedule: ChunkSchedule | None = None,
                   max_epochs=2_000_000,
                   shard: "bool | int" = False,
                   init_epochs=None,
                   pipeline: "bool | int | None" = None) -> SimState:
        """Straggler-free streaming run: rounds + lane compaction + the
        chunk ladder (DSE.md "Rounds and the chunk ladder").

        Each round runs one epoch *quantum* of a ladder-sized batch,
        pulls the per-lane liveness vector to the host (one tiny copy),
        records finished lanes, compacts survivors (a gather on the lane
        axis, on the device, outside the block) and refills from the
        pending-config queue.  Lanes are independent and freeze
        bit-exactly at their own horizons, so the result is
        **bit-identical** to a single full-batch :meth:`run_batch` at
        per-lane ``until`` — rounds only change wall-clock.

        **Pipelining** (``pipeline``, default on): a depth-2 software
        pipeline.  Round *k+1* is assembled from the survivor pool and
        the pending queue and its replays are *enqueued* before the host
        blocks on round *k*'s liveness, whose copy to the host was
        started without blocking at dispatch.  Two in-flight rounds of
        the same rung share its block's buffers; see ``dispatch``.
        ``pipeline=False`` (or ``1``) restores the strictly alternating
        loop, bit-identically; an int sets the depth.  Autotune probe
        rounds and the endgame run unpipelined.

        Under ``shard`` the round batch spans the lane mesh as
        ``[d, C/d]`` and the compact/refill step is **global**: the
        survivor pool is one host-side queue across all shards, so each
        round re-packs live lanes over the whole mesh (the per-round
        ``shard.rebalance`` event counts lanes that changed slot).  Ladder
        rungs align up to multiples of ``d``.

        ``schedule`` defaults to
        :func:`~repro_torch.dse.schedule.auto_schedule` — with a one-shot
        chunk autotune for large B whose winning rung is kept on this
        runner (and, when a campaign cache dir is configured, persisted
        via ``repro_torch.dse.cache`` keyed on the sim signature and the
        shard topology, so a *fresh process* skips the probe too).  With a
        cache dir, once a previous process ran this (sim, B, topology),
        every rung it could choose is captured before the first timed
        round.  Returns the stacked final states in point
        order.

        ``init_epochs`` (scalar or per-lane) is the epoch count already
        recorded in each lane's *initial* state — warm resumes pass the
        epochs a :class:`ResumeHandle` carries so the first round's
        quantum cap advances from there instead of from zero.
        """
        B = int(params_b.conn_latency.shape[0])
        per_lane = isinstance(template, (list, tuple))
        if per_lane:
            assert len(template) == B, (len(template), B)
        if self.sim.donate:      # catch consumed templates up front, not
            for t in (template if per_lane else [template]):  # mid-round
                check_not_consumed(t)
        u, budget = _horizons(until, max_epochs, B)
        d = _shard_devices(shard, self.sim.device)
        auto = schedule is None
        schedule = auto_schedule(B) if auto else \
            dataclasses.replace(schedule)              # never mutate input
        if d > 1:
            # align every rung up to a multiple of d — each round's batch
            # lays out as [d, C/d], and an unaligned rung would pad every
            # round; tuner/ladder bookkeeping all works in aligned units
            schedule = dataclasses.replace(
                schedule, ladder=tuple(sorted(
                    {_align_up(r, d) for r in schedule.ladder},
                    reverse=True)))
        if auto:
            tuned = self._tuned_top.get(d)
            if tuned is None:
                tuned = dse_cache.get_tuned_top(self.sim, d)
                if tuned is not None:   # a previous process's winner
                    self._tuned_top[d] = tuned
            if tuned is not None:
                schedule = schedule.narrowed(tuned)
        # with a campaign cache, capture before the first timed round the
        # rungs a previous process could choose for this (sim, B,
        # topology): a CUDA graph, unlike an XLA executable, cannot come
        # from disk, so a cold rung would capture mid-round
        if dse_cache.active():
            known = dse_cache.get_rung_set(self.sim, B, d) or []
            cold = [r for r in known if (r, d) not in self.made]
            if cold:
                self.warm_ladder(template, params_b, cold, shard=d)

        depth = (2 if pipeline is None or pipeline is True else
                 1 if pipeline is False else max(1, int(pipeline)))
        K = self.sim.super_epoch

        ep = np.broadcast_to(               # per-lane epochs so far
            np.asarray(0 if init_epochs is None else init_epochs,
                       np.int64), (B,)).copy()
        done: list[tuple[list[int], SimState]] = []   # finished segments
        pending = list(range(B))            # configs not yet started
        pool: list[tuple[list[int], SimState]] = []   # alive, unscheduled
        tuner = (ChunkAutotuner(schedule, len(pending))
                 if schedule.autotune else None)
        pad_template = template[0] if per_lane else template
        n_rounds = 0
        n_dispatched = 0
        host_accum = wait_accum = 0.0
        shard_of: dict[int, int] = {}   # config -> mesh slot last round
        if BUS.active:
            BUS.emit("rounds.start", B=B, per_lane=per_lane,
                     ladder=list(schedule.ladder),
                     quantum=schedule.quantum, shard=d,
                     autotune=bool(schedule.autotune), pipeline=depth)

        def fresh(ids):
            if per_lane:
                return stack_state_list([template[i] for i in ids])
            return stack_states(template, len(ids))

        # two in-flight rounds, resolved FIFO; each entry is a dispatched
        # round whose liveness copy is already streaming to the host
        inflight: "collections.deque" = collections.deque()

        def dispatch():
            """Assemble one round from the pool + pending queue and
            enqueue its block steps and its liveness copy.  Pure host and
            enqueue work — never blocks on the card, so it runs while the
            previous round computes.

            Rounds of one rung share one block's buffers.  That is safe
            because every copy in, step and copy out is enqueued on one
            stream in dispatch order: this round's result is copied out to
            fresh tensors (``out`` below) and its ``(live, epochs)`` to
            pinned host memory before the next round's copy in is
            enqueued."""
            nonlocal tuner, schedule, pending, n_dispatched
            h0 = time.perf_counter()
            n_alive = sum(len(ids) for ids, _ in pool)
            remaining = n_alive + len(pending)
            rung = None
            if tuner is not None:
                rung = tuner.next_probe(remaining)
                if rung is None:              # probing done: pick winner
                    top = tuner.best(schedule.top)
                    if BUS.active:
                        BUS.emit("autotune.winner", top=top,
                                 rates={str(r): rate for r, rate
                                        in tuner.rates.items()})
                    schedule = schedule.narrowed(top)
                    self._tuned_top[d] = top
                    dse_cache.put_tuned_top(self.sim, d, top)
                    tuner = None
            C = rung if rung is not None else schedule.size_for(remaining)
            # Endgame: once everything left fits the smallest rung there
            # is nothing to compact *into* and no queue to refill from —
            # run to the full budget in one round.  Needs *every* lane
            # resolved, so only when nothing is in flight.
            endgame = (tuner is None and not inflight
                       and remaining <= schedule.ladder[-1])

            # --- assemble the round's batch: survivors, refill, pad ----
            parts, ids = [], []
            room = C
            while pool and room:
                seg_ids, seg = pool[0]
                if len(seg_ids) <= room:
                    pool.pop(0)
                    parts.append(seg)
                    ids += seg_ids
                    room -= len(seg_ids)
                else:                 # split a segment across rounds
                    parts.append(tree_map(lambda x: x[:room], seg))
                    pool[0] = (seg_ids[room:],
                               tree_map(lambda x: x[room:], seg))
                    ids += seg_ids[:room]
                    room = 0
            n_fresh = min(room, len(pending))
            spawned: list[int] = []
            if n_fresh:
                take, pending = pending[:n_fresh], pending[n_fresh:]
                parts.append(fresh(take))
                ids += take
                spawned = take
                room -= n_fresh
            if room:                  # zero-horizon padding: freezes on
                parts.append(stack_states(pad_template, room))  # entry
                ids += [-1] * room
            sb = _concat(parts)

            rows = np.asarray(ids, np.int32)
            live_row = rows >= 0
            ridx = np.where(live_row, rows, 0)
            if C == B and np.array_equal(ridx, np.arange(B)):
                pb = params_b         # identity round: skip the gather
            else:
                pb = _take(params_b, ridx)
            u_vec = np.where(live_row, u[ridx], 0.0).astype(np.float32)
            cap = budget[ridx].astype(np.int64) if endgame else \
                np.minimum(ep[ridx] + schedule.quantum,
                           budget[ridx].astype(np.int64))
            m_vec = np.where(live_row, cap, 0).astype(np.int32)
            b_vec = np.where(live_row, budget[ridx], 0).astype(np.int32)

            if BUS.active and d > 1:
                # global re-pack diagnostics: which mesh slot does each
                # live config land on this round, vs where it ran last
                # round — moved lanes are the cross-shard rebalancing
                per_dev = C // d
                moved = n_live = 0
                for j, i in enumerate(ids):
                    if i < 0:
                        continue
                    n_live += 1
                    slot = j // per_dev
                    if i in shard_of and shard_of[i] != slot:
                        moved += 1
                    shard_of[i] = slot
                BUS.emit("shard.rebalance", round=n_dispatched, shards=d,
                         moved=moved, lanes=n_live)
                BUS.count("dse.shard.lanes_moved", moved)
            t0 = time.perf_counter()
            # a quantum round: every lane stops at its cap within
            # ceil(quantum / K) blocks, so they go back to back unread
            out, pend = self._dispatch(
                sb, pb, u_vec, m_vec, b_vec,
                None if endgame else math.ceil(schedule.quantum / K), d)
            n_dispatched += 1
            return {"ids": ids, "out": out, "pend": pend, "C": C,
                    "rung": rung, "endgame": endgame,
                    "live_row": live_row, "spawned": spawned,
                    "round": n_dispatched - 1,
                    "t_dispatch": t0, "host_s": t0 - h0}

        def resolve(rec):
            """Block on a dispatched round's liveness (the copy has been
            streaming since dispatch), then harvest finished lanes and
            compact survivors back into the pool."""
            nonlocal n_rounds, host_accum, wait_accum
            (live, ep_c), wait_s = self._liveness_read(rec["pend"])
            dt = time.perf_counter() - rec["t_dispatch"]
            h0 = time.perf_counter()
            ids, out, C = rec["ids"], rec["out"], rec["C"]
            live_row, spawned = rec["live_row"], rec["spawned"]
            tele = BUS.active

            round_epochs = 0
            surv_rows, surv_ids = [], []
            fin_rows, fin_ids = [], []
            for j, i in enumerate(ids):
                if i < 0:
                    continue
                if tele:
                    round_epochs += int(ep_c[j]) - int(ep[i])
                ep[i] = int(ep_c[j])
                if live[j]:
                    surv_rows.append(j)
                    surv_ids.append(i)
                else:
                    fin_rows.append(j)
                    fin_ids.append(i)
            # compaction / harvest: one gather per leaf per group; a round
            # the whole batch finishes (or survives) needs none
            if fin_rows:
                done.append((fin_ids, out if len(fin_rows) == C
                             else _take(out, fin_rows)))
            if surv_rows:
                pool.append((surv_ids, out if len(surv_rows) == C
                             else _take(out, surv_rows)))
            host_s = rec["host_s"] + (time.perf_counter() - h0)
            host_accum += host_s
            wait_accum += wait_s
            if tuner is not None:
                tuner.record(C, dt, lanes=int(np.sum(live_row)),
                             host_dt=host_s)
                if tele and C in tuner.rates:
                    BUS.emit("autotune.probe", rung=C, dur=dt,
                             lanes=int(np.sum(live_row)),
                             rate=tuner.rates[C])
            else:
                q0 = schedule.quantum
                schedule.grow_quantum(dt, host_s, steps=depth)
                if tele and schedule.quantum != q0:
                    BUS.emit("quantum.grow", quantum=schedule.quantum,
                             was=q0, round_dur=dt, host_s=host_s)
            if tele:
                # the per-round heartbeat: lane spawn/freeze/harvest and
                # the compaction decision, one event per drained round
                overlap = host_s / max(host_s + wait_s, 1e-9)
                BUS.emit(
                    "round.end", round=rec["round"], rung=C, dur=dt,
                    live=int(np.sum(live_row)), fresh=len(spawned),
                    pad=int(np.sum(~live_row)), epochs=round_epochs,
                    finished=len(fin_ids), survivors=len(surv_ids),
                    pending=len(pending),
                    pool=sum(len(g) for g, _ in pool),
                    quantum=schedule.quantum,
                    endgame=bool(rec["endgame"]),
                    probe=rec["rung"] is not None,
                    compacted=bool(surv_rows)
                    and len(surv_rows) != C,
                    inflight=len(inflight),
                    host_s=host_s, wait_s=wait_s,
                    overlap_frac=overlap,
                    spawned_ids=spawned[:128],
                    frozen_ids=fin_ids[:128])
                BUS.count("dse.rounds")
                BUS.count("dse.lanes_finished", len(fin_ids))
                BUS.observe("dse.round_s", dt)
                BUS.gauge("dse.lanes_live", len(surv_ids))
                BUS.gauge("dse.lanes_pending", len(pending))
                BUS.gauge("dse.round.overlap_frac", overlap)
            n_rounds += 1

        while pool or pending or inflight:
            # fill the pipeline: dispatch up to ``depth`` rounds before
            # blocking on the oldest round's liveness.  Probe rounds stay
            # unpipelined (they need clean per-round timings) and the
            # endgame is terminal by construction.
            while (pool or pending) and len(inflight) < depth:
                inflight.append(dispatch())
                if inflight[-1]["endgame"] or tuner is not None:
                    break
            resolve(inflight.popleft())

        occ = host_accum / max(host_accum + wait_accum, 1e-9)
        self.last_rounds = {"rounds": n_rounds, "chunk": schedule.top,
                            "quantum": schedule.quantum, "shard": d,
                            "pipeline": depth,
                            "host_s": host_accum, "wait_s": wait_accum,
                            "overlap_frac": occ,
                            "trace_count": self.trace_count}
        # remember the rungs this (sim, B, topology) can choose once tuned
        # — every size_for(remaining), unlike the reference's rungs used:
        # which of them a run uses depends on round timings (the quantum
        # grows with them) — so the next process captures them all before
        # its first timed round
        dse_cache.put_rung_set(self.sim, B, d, {
            schedule.size_for(n) for n in range(1, B + 1)})
        if BUS.active:
            BUS.emit("rounds.end", B=B, rounds=n_rounds,
                     chunk=schedule.top, quantum=schedule.quantum,
                     shard=d, pipeline=depth, overlap_frac=occ,
                     trace_count=self.trace_count)
        # final assembly in point order: concat the finished segments
        # once, then one gather per leaf restores lane order
        all_ids = np.asarray([i for ids, _ in done for i in ids], np.int32)
        full = _concat([t for _, t in done])
        if np.array_equal(all_ids, np.arange(B)):
            return full               # already in point order
        pos = np.empty(B, np.int32)
        pos[all_ids] = np.arange(B, dtype=np.int32)
        return _take(full, pos)


# ---------------------------------------------------------------------------
_RUNNERS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def runner_for(sim) -> BatchRunner:
    """The shared :class:`BatchRunner` of a simulation (weak-keyed, so
    dropping the sim drops its runner).

    ``run_sweep`` uses this instead of a private runner per call: when a
    build function memoizes and returns the *same* ``Simulation`` again,
    repeat sweeps reuse its captured rungs and autotuned chunk.
    """
    r = _RUNNERS.get(sim)
    if r is None:
        r = _RUNNERS[sim] = BatchRunner(sim)
    return r


def memoize_build(build_fn: Callable) -> Callable:
    """Memoize a sweep build function across calls, so incremental point
    submission (repeated sweeps) reuses one built simulation — and
    therefore :func:`runner_for`'s captured rungs and autotuned chunk —
    instead of rebuilding per round.

    * Plain groups: the ``(sim, state)`` of each distinct ``static.*``
      kwarg combination is cached and returned as-is (``run_sweep``
      copies the template state per lane, so it is never consumed).
    * Topology families (``shape=`` calls): the cached family is reused
      whenever its ``shape_max`` covers the requested shape.  A request
      that exceeds the cache is rebuilt at the elementwise maximum of old
      and new, so repeated growth converges to one family per group.
      When a campaign cache dir is configured (``repro_torch.dse.cache``)
      the union also persists *across processes*, keyed on the build
      function + static kwargs: a fresh process builds the family at the
      previous process's final maximum in one shot.

    The wrapper forwards ``build_fn``'s signature (``functools.wraps``),
    so ``run_sweep``'s eager ``static.*`` kwarg validation still sees
    the real keyword names.  Idempotent to re-wrap; keep the wrapper
    itself alive to keep the cache (and the weak-keyed runners) alive.
    """
    if getattr(build_fn, "_dse_memoized", False):
        return build_fn
    cache: dict[tuple, object] = {}

    @functools.wraps(build_fn)
    def wrapped(*args, **kw):
        shape = kw.pop("shape", None)
        # family and plain builds of the same static kwargs return
        # different objects — keep them in disjoint cache slots
        key = (shape is not None, args, tuple(sorted(kw.items())))
        if shape is None:
            if key not in cache:
                cache[key] = build_fn(*args, **kw)
            return cache[key]
        fam = cache.get(key)
        if fam is not None and all(
                fam.shape_max.get(a, 0) >= int(v)
                for a, v in shape.items()):
            return fam
        grown = dict(shape)
        if fam is not None:
            for a, v in fam.shape_max.items():
                grown[a] = max(int(grown.get(a, 0)), int(v))
        bkey = None
        if dse_cache.active():        # cross-process union (same axes only
            bkey = dse_cache.family_build_key(build_fn, args, kw)
            persisted = dse_cache.get_family_shape(bkey)
            if persisted:             # — a foreign axis would leak into
                for a, v in persisted.items():   # the build signature)
                    if a in grown:
                        grown[a] = max(int(grown[a]), int(v))
        fam = build_fn(*args, **kw, shape=grown)
        cache[key] = fam
        if bkey is not None:
            dse_cache.put_family_shape(bkey, fam.shape_max)
        return fam

    wrapped._dse_memoized = True
    return wrapped


def _static_kwarg_names(build_fn) -> list[str] | None:
    """Keyword names ``build_fn`` accepts, or None if it takes **kwargs
    (then any ``static.*`` axis must be assumed valid)."""
    try:
        sig = inspect.signature(build_fn)
    except (TypeError, ValueError):
        return None
    params = sig.parameters.values()
    if any(p.kind is inspect.Parameter.VAR_KEYWORD for p in params):
        return None
    return [p.name for p in params
            if p.kind in (inspect.Parameter.POSITIONAL_OR_KEYWORD,
                          inspect.Parameter.KEYWORD_ONLY)]


def _extract_arity(fn) -> int:
    """2 for the classic ``extract(sim, lane_state)`` signature, 3 when
    the extractor also wants the point's global index (``extract(sim,
    lane_state, index)``)."""
    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        return 2
    n = 0
    for p in sig.parameters.values():
        if p.kind in (inspect.Parameter.POSITIONAL_ONLY,
                      inspect.Parameter.POSITIONAL_OR_KEYWORD):
            n += 1
        elif p.kind is inspect.Parameter.VAR_POSITIONAL:
            return 3
    return 3 if n >= 3 else 2


def run_sweep(build_fn: Callable, spec: SweepSpec, until,
              extract: Callable | None = None, chunk: int | None = None,
              max_epochs: "int | Sequence[int]" = 2_000_000,
              shard: "bool | int" = False,
              schedule: ChunkSchedule | None = None,
              resume: Sequence[ResumeHandle | None] | None = None,
              return_states: bool = False,
              pipeline: "bool | int | None" = None):
    """Simulate every design point of ``spec`` and return tidy result rows.

    ``build_fn(**static_kwargs) -> (sim, state)`` builds the topology; it
    is called once per distinct ``static.*`` axis combination (each such
    group gets its own blocks and runs its traced points as lanes).
    ``extract(sim, final_lane_state) -> dict`` pulls per-config results
    (default: engine counters); lanes are handed to it *host-side* — one
    transfer per group — so scalar casts in the extractor never sync.  An
    extractor that takes a third positional arg gets the point's global
    spec index too.  Rows come back in spec order, each the point's axis
    assignment merged with its extracted results.

    Execution is **round-based and straggler-free**
    (:meth:`BatchRunner.run_rounds`).  ``chunk`` pins the ladder's top
    rung (otherwise large groups autotune it); ``schedule`` overrides the
    whole policy.  ``until`` may be a scalar or a per-point sequence.
    ``shard=True`` (or a placement count) spans each round over the lane
    mesh with globally-rebalanced compaction — rows stay bit-identical to
    the single-device path (:meth:`BatchRunner.run_rounds`).
    ``pipeline`` forwards to :meth:`BatchRunner.run_rounds`.

    **Topology families** (``shape.*`` axes, DSE.md): the runner groups
    by ``static.*`` only, computes each group's family maximum per shape
    axis, and calls ``build_fn(**static_kwargs, shape={axis: max})``,
    which must return a :class:`~repro_torch.dse.family.TopologyFamily`.
    Every shape in the group then runs as lanes of the same ladder rungs
    — activity masks and per-lane initial states select each sub-shape.

    All axis paths are validated before anything runs: unknown axes
    raise ``ValueError`` naming the path and the valid alternatives.

    **Warm resume** (``resume=``): a per-point sequence of
    :class:`ResumeHandle` / ``None``.  A handled point's lane starts
    from the handle's frozen final state and runs on to its (longer,
    absolute) ``until``; the row is bit-identical to a cold run at that
    horizon.  ``return_states=True`` returns ``(rows, LaneStates)``.
    """
    if chunk is not None and schedule is not None:
        raise ValueError(
            "pass either chunk= (pins the ladder top) or schedule= (the "
            "whole policy), not both — a schedule carries its own ladder")
    if resume is not None and len(resume) != len(spec):
        raise ValueError(
            f"resume= must give one handle (or None) per point: "
            f"{len(resume)} != {len(spec)}")
    dse_cache.ensure_enabled()       # open the campaign cache dir, if any
    rows: list[dict | None] = [None] * len(spec)
    lane_states = LaneStates() if return_states else None
    until_arr = np.broadcast_to(np.asarray(until, np.float32), (len(spec),))
    me_arr = np.broadcast_to(np.asarray(max_epochs, np.int64), (len(spec),))
    shape_mode = spec.has_shape_axes()
    tele = BUS.active
    sweep_t0 = time.perf_counter()
    if tele:
        BUS.emit("sweep.start", n_points=len(spec), axes=spec.summary(),
                 shape_mode=bool(shape_mode), shard=_shard_devices(shard),
                 warm=(0 if resume is None
                       else sum(1 for h in resume if h is not None)))
        BUS.count("dse.sweeps")
    static_ok = _static_kwarg_names(build_fn)
    if static_ok is not None:
        bad = [a for a in spec.axes if a.startswith(STATIC_PREFIX)
               and a[len(STATIC_PREFIX):] not in static_ok]
        if bad:
            raise ValueError(
                f"invalid static axes {bad}: build function accepts "
                f"only {sorted(static_ok)}")
    group_no = 0
    for static_kwargs, indices, traced in spec.split_static():
        if tele:
            BUS.emit("sweep.group", group=group_no,
                     static={k: str(v) for k, v in static_kwargs.items()},
                     n_points=len(indices), family=bool(shape_mode))
        group_no += 1
        # validate each group's own axes against that group's build (a
        # group's sim can differ structurally, e.g. static.n_cores)
        group_spec = SweepSpec(tuple(traced))
        u_group = until_arr[np.asarray(indices)]
        me_group = me_arr[np.asarray(indices)]
        res = ([resume[i] for i in indices] if resume is not None
               else None)
        warm = res is not None and any(h is not None for h in res)
        init_ep = (np.asarray([int(h.epochs) if h is not None else 0
                               for h in res], np.int64) if warm else None)
        sched = auto_schedule(len(indices), chunk=chunk) \
            if schedule is None and chunk is not None else schedule
        if shape_mode:
            split = [split_shape(pt) for pt in traced]
            fam_shape: dict[str, int] = {}
            for shape_pt, _ in split:
                for name, v in shape_pt.items():
                    fam_shape[name] = max(int(v), fam_shape.get(name, 1))
            fam = build_fn(**static_kwargs, shape=fam_shape)
            if not isinstance(fam, TopologyFamily):
                raise TypeError(
                    "shape.* axes require a family-aware build function: "
                    "build_fn(**static, shape={...}) must return a "
                    f"TopologyFamily, got {type(fam).__name__}")
            group_spec.validate(fam)
            sim = fam.sim
            base = sim.default_params()
            # grids repeat shapes across traced-axis combinations: derive
            # each distinct shape's masks once and share them between the
            # lane's params and initial state
            mask_cache: dict[tuple, tuple] = {}
            plist, states = [], []
            for shape_pt, traced_pt in split:
                full = fam.full_shape(shape_pt)
                key = tuple(sorted(full.items()))
                if key not in mask_cache:
                    mask_cache[key] = fam.masks(full)
                m = mask_cache[key]
                plist.append(fam.params_for(
                    full, apply_point(base, traced_pt), masks=m))
                states.append(fam.state_for(full, masks=m))
            if warm:                # handled lanes continue, not restart
                states = [_on_device(sim, h.state) if h is not None else s
                          for h, s in zip(res, states)]
            params_b = stack_params(plist)
            runner = runner_for(sim)
            out = runner.run_rounds(states, params_b, u_group,
                                    schedule=sched, max_epochs=me_group,
                                    shard=shard, init_epochs=init_ep,
                                    pipeline=pipeline)
        else:
            sim, st = build_fn(**static_kwargs)
            group_spec.validate(sim)
            params_b = build_param_batch(sim, traced)
            runner = runner_for(sim)
            template = ([_on_device(sim, h.state) if h is not None else st
                         for h in res] if warm else st)
            out = runner.run_rounds(template, params_b, u_group,
                                    schedule=sched, max_epochs=me_group,
                                    shard=shard, init_epochs=init_ep,
                                    pipeline=pipeline)
        # one transfer serves both the result rows and (when asked) the
        # resumable final states — never two transfers per group
        ex = extract or default_extract
        t0 = time.perf_counter()
        host = _to_host(out)
        if tele:
            dt = time.perf_counter() - t0
            BUS.emit("transfer", what="rows", lanes=len(indices), dur=dt,
                     bytes=int(sum(x.numel() * x.element_size()
                                   for x in tree_leaves(host))))
            BUS.observe("dse.transfer.rows_s", dt)
        if _extract_arity(ex) >= 3:     # index-aware extractors
            group_rows = [ex(sim, lane(host, j), indices[j])
                          for j in range(len(indices))]
        else:
            group_rows = [ex(sim, lane(host, j))
                          for j in range(len(indices))]
        if lane_states is not None:
            lane_states.add_group(host, indices)
        for j, i in enumerate(indices):
            row = dict(spec.points[i])
            row.update(group_rows[j])
            rows[i] = row
    if tele:
        BUS.emit("sweep.end", n_points=len(spec), groups=group_no,
                 dur=time.perf_counter() - sweep_t0)
    if return_states:
        return list(rows), lane_states
    return list(rows)
