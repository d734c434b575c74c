"""The Akita engine in PyTorch: event-driven core + Smart Ticking (paper
§3.2) + Availability Backpropagation + transparent vectorized parallelism
(§3.3).  Counterpart of ``repro.core.engine``; it reproduces that engine's
results bit for bit (the same int32 and f32 operations in the same order).

Design:

* Instances of every component kind are rows of batched tensors; one *epoch*
  advances virtual time straight to the next event (``min`` over all wake
  times) — the event-driven jump that lets Smart Ticking skip idle
  stretches entirely.
* Smart Ticking's four rules (paper §3.2) are vectorized:
    1. message arrival wakes the destination component at the arrival time;
    2. an outgoing buffer going full→not-full wakes its owner;
    3. a tick returning progress reschedules at ``t + period``; otherwise the
       component sleeps (``next_tick = +inf``);
    4. duplicate events are impossible by construction (wakes are ``min``-
       reductions into a single per-component wake time).
* Availability Backpropagation (paper Fig. 5): an incoming buffer going
  full→not-full wakes the serving connection; the connection draining a source
  port's outgoing buffer full→not-full wakes the upstream component — the
  backward chain that makes the sleep rules lossless.
* ``naive=True`` builds the ablation engine — every component ticks every
  cycle of its clock, connections attempt delivery every cycle — used by the
  Fig. 9a/9b reproduction.  Both engines share the delivery/tick code, so
  smart and naive runs give bit-identical results.

The loop:

* **Blocks of K epochs.**  The reference runs a ``lax.while_loop`` over
  ``super_epoch`` (K) ``lax.cond``-guarded epochs.  Here one *block* runs K
  epochs; each computes ``live`` on the device and keeps its result only
  where ``live`` (a ``torch.where`` over every leaf: the identity branch of
  ``lax.cond``), so results do not depend on K.  The host reads ``live``
  once per block.  Nothing inside a block waits on the device: no
  ``.item()``, no boolean-mask indexing, no data-dependent shapes.
* **CUDA graphs.**  On the card a block is captured once as a CUDA graph
  over static state buffers and replayed; it ends by copying its result
  into those buffers, so the next replay carries on.  One epoch is a few
  hundred tiny ops, so launching them one by one from Python would cost
  far more than running them.  A graph is captured per ``params``
  structure (which leaves are present, their shapes and dtypes) and
  dropped by ``set_default_peers``; new ``params`` values and horizons
  are copied into its static tensors before a replay.  If capture or replay
  fails, ``run`` raises; it never falls back to the eager block.  On the
  CPU the same block runs eagerly.
* **Lane-batched blocks (DSE).**  ``lane_block`` runs the same block for
  a batch of independent simulations ("lanes", ``repro.dse``): ``_block``
  under ``torch.func.vmap`` over a leading lane axis of ``(state, params,
  until, max_epochs)``, the counterpart of the reference runner's
  ``jax.vmap`` of ``_run``.  Each lane freezes at its own horizon and
  budget through the same ``torch.where``, so a lane's result does not
  depend on K or on its siblings.  On the card the batched block is
  captured once per ``(lanes, structure)`` as a CUDA graph over static
  ``[b]``-lane buffers, apart from the single-run graphs.
* **Segmented port state** — port ring buffers live in per-kind segments
  (``SimState.in_buf`` etc. are dicts keyed by kind name, mirroring
  ``comp_state``), so a kind's tick phase reads and writes *only its own
  segment*.  Delivery is gather/select only: connection membership is a
  build-time constant, so source-side pops are static takes, and
  destination-side pushes are one-hot selects.
* **Donation** — with ``donate=True`` (the default) ``run()`` consumes its
  input state: passing it again raises (use :meth:`Simulation.copy_state`
  first, or build with ``donate=False``).
* **Hoisted constants** — per-kind static index tensors (port slices,
  global port ids, capacity/peer slices, connection-membership masks) live
  on the device from build time: an index held in host memory would be
  copied to the device on every use, and cannot be captured in a graph.
* **Static/traced split (DSE.md)** — structure (topology, wiring,
  capacities) is fixed at build time, while the numeric timing/model knobs
  (connection latencies, per-kind tick periods, opt-in per-kind model
  params) live in a :class:`SimParams` tree passed to ``run()``.

Parallelism is transparent exactly as the paper demands: ``tick_fn`` is
single-instance, lock-free code; the engine vmaps it over instances
(``torch.func.vmap``).

No ``torch.compile`` on this path: generated kernels may divide
approximately or fuse ``a*b+c`` into one FMA, and either would move the
``floor(t/period + EPS)`` grid off the reference's.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import gc
from typing import Any

import numpy as np
import torch

from .. import resolve_device
from .component import ComponentKind, KindHandle, normalize_tick_output
from .message import MSG_WORDS, W_DST, W_TIME, f2i, i2f
from .ports import EPS, Ports

INF = float("inf")
# epochs per block on the card: long enough that the host's read of
# ``live`` between blocks is rare, short enough that capture stays quick
# and a run's last, partly idle block stays cheap
CUDA_SUPER_EPOCH = 64


# ---------------------------------------------------------------------------
# state trees: dataclasses whose fields are tensors, dicts of tensors or None
# ---------------------------------------------------------------------------
def tree_map(fn, tree, *rest):
    """Apply ``fn`` leaf by leaf over trees of the same structure."""
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: tree_map(fn, getattr(tree, f.name),
                             *(getattr(r, f.name) for r in rest))
            for f in dataclasses.fields(tree)})
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves of a tree, in ``tree_map``'s order."""
    out = []
    tree_map(out.append, tree)
    return out


def tree_unflatten(template, leaves):
    """A tree of ``template``'s structure holding ``leaves`` in
    ``tree_map``'s order (the inverse of :func:`tree_leaves`)."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), template)


def ref_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` in the reference's pytree order
    (``jax.tree.leaves``: dataclass fields in declaration order, dict keys
    sorted, ``None`` no leaf), rebuilding the tree; dicts keep their
    insertion order.  ``rest`` are trees of the same structure, where a
    leaf of ``tree`` may be matched by a subtree."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        done = {k: ref_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
        return {k: done[k] for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(ref_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: ref_map(fn, getattr(tree, f.name),
                            *(getattr(r, f.name) for r in rest))
            for f in dataclasses.fields(tree)})
    return fn(tree, *rest)


def ref_leaves(tree) -> list:
    """The leaves of a tree in :func:`ref_map`'s order (that of
    ``jax.tree.leaves`` on the same tree)."""
    out = []
    ref_map(out.append, tree)
    return out


def ref_unflatten(template, leaves):
    """A tree of ``template``'s structure holding ``leaves`` in
    :func:`ref_leaves`' order (its inverse)."""
    leaves = list(leaves)
    n = len(ref_leaves(template))
    if len(leaves) != n:
        raise ValueError(f"{len(leaves)} leaves for a template of {n}")
    it = iter(leaves)
    return ref_map(lambda _: next(it), template)


def _structure(tree):
    """Hashable structure of a tree: keys, shapes and dtypes."""
    if isinstance(tree, torch.Tensor):
        return (tuple(tree.shape), tree.dtype)
    if tree is None:
        return None
    if isinstance(tree, dict):
        return tuple((k, _structure(v)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return tuple(_structure(v) for v in tree)
    if dataclasses.is_dataclass(tree):
        return tuple((f.name, _structure(getattr(tree, f.name)))
                     for f in dataclasses.fields(tree))
    return type(tree)


@contextlib.contextmanager
def _no_gc():
    """No cyclic collection until the block's capture ends.  One inside a
    capture may free an older simulation's graph (a simulation and its
    blocks reference each other), or a pinned buffer or event of a round,
    and either invalidates the capture.  Nor a full collection before it:
    one before every capture is slow, which is why PyTorch's
    ``torch.cuda.graph`` dropped its own."""
    was = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if was:
            gc.enable()


def canonical_device(device) -> torch.device:
    """``device`` with its index made explicit (``cuda`` is the current
    card), so that two names of one device compare equal."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def _from_np(a, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def host_tensor(a, device) -> torch.Tensor:
    """A host array as a tensor ready for a copy to ``device``: pinned when
    that is the card, so that a ``non_blocking`` copy does not wait for the
    stream (a copy from pageable memory would)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.pin_memory() if torch.device(device).type == "cuda" else t


def _to_device(a, device) -> torch.Tensor:
    """A user-supplied leaf as a tensor on ``device``, with JAX's default
    dtypes (64-bit ints and floats become 32-bit)."""
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(
        np.array(a, copy=True))
    narrow = {torch.int64: torch.int32, torch.float64: torch.float32}
    return t.to(device=device, dtype=narrow.get(t.dtype, t.dtype))


def check_not_consumed(state) -> None:
    """Raise a clear error if ``state`` was already donated into a run.

    A donating ``run()`` consumes its input ``SimState`` (it marks it so);
    reusing it raises here, up front, with the way out.
    """
    if getattr(state, "_consumed", False):
        raise RuntimeError(
            "this SimState was already consumed by a donating run(). Keep "
            "using the state a donating run *returns*; to reuse an input "
            "state, deep-copy it first (sim.copy_state(state)) or build "
            "the simulation with donate=False (see ENGINE_PERF.md).")


def _align_after(t, period):
    """First grid point of ``period`` strictly after ``t``."""
    return (torch.floor(t / period + EPS) + 1.0) * period


def _align_at_or_after(t, period):
    """First grid point of ``period`` at or after ``t``."""
    return torch.ceil(t / period - EPS) * period


@dataclasses.dataclass(frozen=True)
class SimParams:
    """Timing/model parameters of a built topology (DSE.md).

    Structure (topology, port wiring, buffer capacities, kind/instance
    counts) is fixed at build time; the numeric knobs below are tensors
    passed to ``run()``, so one built simulation serves every design point
    that shares a structure.

    Leaves (all shapes are per-topology static):
      * ``conn_latency`` — ``[C]`` f32 connection latencies in cycles
        (must stay >= 1).
      * ``periods`` — dict kind name -> ``[n_instances]`` f32 tick periods.
      * ``kind`` — dict kind name -> that kind's opt-in model-parameter
        tree (``ComponentKind.params``; ``{}`` for kinds without one),
        passed as the 4th argument to a 4-ary ``tick_fn``.
      * ``inst_mask`` — dict kind name -> ``[n_instances]`` bool *activity
        masks* (``None`` = everything active).  A masked-off instance never
        ticks, is pinned to ``next_tick = +inf`` and contributes nothing to
        the tick/progress stats — so a *topology family* built at its
        maximum shape (``SimBuilder.build(pad_shape=...)``) simulates any
        sub-shape by mask alone.
      * ``conn_mask`` — ``[C]`` bool (``None`` = all active).  A masked-off
        connection never delivers and is pinned to ``conn_wake = +inf``.
        ``Simulation.prefix_masks`` derives both masks for a prefix
        sub-shape of a family.
    """

    conn_latency: torch.Tensor  # [C] f32
    periods: dict               # kind name -> [n_k] f32
    kind: dict                  # kind name -> params tree ({} if none)
    inst_mask: Any = None       # kind name -> [n_k] bool, or None (all on)
    conn_mask: Any = None       # [C] bool, or None (all on)


@dataclasses.dataclass(frozen=True)
class Stats:
    epochs: torch.Tensor          # i32 — epochs executed
    ticks: torch.Tensor           # i32 — component ticks executed
    progress_ticks: torch.Tensor  # i32 — ticks that made forward progress
    delivered: torch.Tensor       # i32 — messages moved by connections
    busy: torch.Tensor            # [NC] i32 — per-component progressing ticks

    @staticmethod
    def zero(n_comp, device=None):
        z = lambda: torch.zeros((), dtype=torch.int32, device=device)
        return Stats(z(), z(), z(), z(),
                     torch.zeros((n_comp,), dtype=torch.int32, device=device))


@dataclasses.dataclass(frozen=True)
class SimState:
    """Engine state.  Port tensors are *per-kind segments*: dicts keyed by
    kind name whose values are flat over that kind's ports
    (``[N_k * P_k, ...]``, instance-major).  Flat global views (ordered by
    kind registration, i.e. global port id) are materialized on demand via
    ``Simulation.flat_in_cnt`` and friends."""

    time: torch.Tensor         # f32 scalar — virtual time in cycles
    next_tick: torch.Tensor    # [NC] f32 — per-component wake time (+inf asleep)
    conn_wake: torch.Tensor    # [C] f32 — per-connection wake time
    comp_state: dict           # kind name -> tree with leading [N_k]
    in_buf: dict               # kind name -> [NP_k, CAP, W] i32
    in_head: dict              # kind name -> [NP_k] i32
    in_cnt: dict               # kind name -> [NP_k] i32
    out_buf: dict              # kind name -> [NP_k, CAP, W] i32
    out_head: dict             # kind name -> [NP_k] i32
    out_cnt: dict              # kind name -> [NP_k] i32
    rr: torch.Tensor           # [C] i32 — round-robin pointers
    stats: Stats
    buf_samples: torch.Tensor  # [S, PG] i32 in-buffer levels (1 row if off)
    sample_idx: torch.Tensor   # i32
    next_sample: torch.Tensor  # f32


@dataclasses.dataclass
class _KindConsts:
    """Per-kind constants hoisted out of the hot loop at build time."""

    name: str
    n: int                     # instances
    p: int                     # ports per instance
    np_k: int                  # n * p
    cb: int                    # component base id
    pb: int                    # global port base id
    csl: slice                 # global component slice
    periods: torch.Tensor      # [n] f32
    caps: torch.Tensor         # [n, p] i32
    caps_f: torch.Tensor       # [n*p] i32
    gid: torch.Tensor          # [n, p] i32 global port ids
    peer: torch.Tensor         # [n, p] i32 default peers


@dataclasses.dataclass
class _Graph:
    """A captured block and the static buffers it reads and writes."""

    graph: Any
    state: SimState
    params: SimParams
    until: torch.Tensor
    max_epochs: torch.Tensor
    live: torch.Tensor


class LaneBlock:
    """A lane-batched block of K epochs over static ``[b]``-lane buffers.

    ``load`` copies a batch into the buffers, ``step`` advances every lane
    by one block (on the card a replay of the captured graph, elsewhere
    the same block run eagerly) and leaves in ``live`` whether each lane
    still has events before its horizon and its own ``budget``, and in
    ``more`` whether any lane has not yet stopped at ``max_epochs``.
    ``step`` writes its result back into ``state``, so steps chain; read
    the result out with ``sim.copy_state(block.state)``.  Every copy in,
    step and copy out is enqueued on the current stream in call order, which
    is what lets two in-flight rounds share one block's buffers.
    """

    def __init__(self, sim: "Simulation", states_b: SimState,
                 params_b: SimParams):
        b = int(params_b.conn_latency.shape[0])
        dev = sim.device
        self.sim, self.b = sim, b
        self.state = sim.copy_state(states_b)
        self.params = tree_map(torch.clone, params_b)
        self.until = torch.zeros((b,), dtype=torch.float32, device=dev)
        self.max_epochs = torch.zeros((b,), dtype=torch.int32, device=dev)
        self.budget = torch.zeros((b,), dtype=torch.int32, device=dev)
        self.live = self.more = None
        self.graph = None
        if sim.cuda_graph:
            self._capture()

    def _body(self, k: int):
        sim = self.sim
        out = sim._lane_epochs(self.state, self.params, self.until,
                               self.max_epochs, k)
        tree_map(lambda dst, src: dst.copy_(src), self.state, out)
        live = sim._lane_live(self.state, self.until, self.budget)
        more = torch.any(sim._lane_live(self.state, self.until,
                                        self.max_epochs))
        return live, more

    def _capture(self):
        sim = self.sim
        # one eager epoch of every lane on a side stream first, so that
        # lazy initialisation happens outside the capture; it runs on the
        # buffers, which ``load`` overwrites before any step
        side = torch.cuda.Stream(device=sim.device)
        side.wait_stream(torch.cuda.current_stream(sim.device))
        with torch.cuda.stream(side), sim._device_ctx():
            self._body(1)
        torch.cuda.current_stream(sim.device).wait_stream(side)
        torch.cuda.synchronize(sim.device)
        self.graph = torch.cuda.CUDAGraph()
        with _no_gc(), torch.cuda.graph(self.graph), sim._device_ctx():
            self.live, self.more = self._body(sim.super_epoch)

    def load(self, states_b: SimState, params_b: SimParams, until,
             max_epochs, budget=None) -> None:
        """Copy a batch and its per-lane ``[b]`` horizons (host arrays)
        into the buffers; ``budget`` defaults to ``max_epochs``."""
        copy = lambda dst, src: dst.copy_(src)
        tree_map(copy, self.state, states_b)
        tree_map(copy, self.params, params_b)
        budget = max_epochs if budget is None else budget
        for dst, a in ((self.until, until), (self.max_epochs, max_epochs),
                       (self.budget, budget)):
            dst.copy_(host_tensor(a, self.sim.device), non_blocking=True)

    def step(self) -> None:
        if self.graph is not None:
            self.graph.replay()
            return
        with self.sim._device_ctx():
            self.live, self.more = self._body(self.sim.super_epoch)


class SimBuilder:
    """Builds a static topology: kinds, ports, connections (Akita §3.1)."""

    def __init__(self, msg_words: int = MSG_WORDS):
        assert msg_words == MSG_WORDS
        self.kinds: list[ComponentKind] = []
        self._kind_ix: dict[str, int] = {}
        self.conns: list[tuple[list[tuple[str, int, int]], float]] = []

    def add_kind(self, kind: ComponentKind) -> KindHandle:
        assert kind.name not in self._kind_ix, f"duplicate kind {kind.name}"
        self._kind_ix[kind.name] = len(self.kinds)
        self.kinds.append(kind)
        return KindHandle(kind.name, len(self.kinds) - 1)

    def connect(self, members, latency: float = 1.0):
        """Connect 2+ ports with a round-robin arbitrated crossbar.

        ``latency`` is in cycles and must be >= 1 (a "direct connection" is
        one cycle — no zero-delay loops).
        """
        assert latency >= 1.0 - 1e-6, "connection latency must be >= 1 cycle"
        assert len(members) >= 2
        self.conns.append(([tuple(m) for m in members], float(latency)))
        return len(self.conns) - 1

    # ------------------------------------------------------------------
    def build(self, naive: bool = False, cap_phys: int | None = None,
              sample_period: float = 0.0, max_samples: int = 1024,
              super_epoch: int | None = None, donate: bool = True,
              pad_shape: dict[str, int] | None = None, device=None,
              cuda_graph: bool = True) -> "Simulation":
        """Build the topology on ``device`` (``None``: the card).

        ``super_epoch`` — epochs per block (None = ``CUDA_SUPER_EPOCH`` on
        the card, the reference's heuristic on the CPU; 1 = one epoch per
        host check).
        ``donate`` — ``run()`` consumes its input state (see
        :func:`check_not_consumed`).
        ``pad_shape`` — kind name -> instance count: size every named
        kind's segments to a *topology family* maximum (padded instances
        get zero-filled init rows and repeat the last declared
        period/capacity row), so one build serves every sub-shape via the
        ``SimParams.inst_mask`` / ``conn_mask`` activity masks.
        ``cuda_graph`` — on the card, replay each block as a captured CUDA
        graph (the default); ``False`` launches the same block eagerly, to
        hold the graph against it.
        """
        return Simulation(self, naive=naive, cap_phys=cap_phys,
                          sample_period=sample_period,
                          max_samples=max_samples,
                          super_epoch=super_epoch, donate=donate,
                          pad_shape=pad_shape, device=device,
                          cuda_graph=cuda_graph)


def _pad_kind(k: ComponentKind, n_max: int) -> ComponentKind:
    """Pad a kind's instance axis to a family maximum: zero init rows,
    last-row periods/caps.  Padded rows only ever run when unmasked (a
    degenerate but legal all-active run); under ``inst_mask`` they are
    inert."""
    n = k.n_instances
    assert n_max >= n, f"pad_shape[{k.name!r}]={n_max} < declared {n}"
    if n_max == n:
        return k
    pad = n_max - n

    def grow(a):
        a = _to_device(a, "cpu")
        return torch.cat([a, torch.zeros((pad,) + a.shape[1:],
                                         dtype=a.dtype)])

    init = tree_map(grow, k.init_state)
    periods = np.concatenate([k.periods(), np.repeat(k.periods()[-1:], pad)])
    caps = np.concatenate([k.caps(), np.repeat(k.caps()[-1:], pad, axis=0)])
    return dataclasses.replace(k, n_instances=n_max, init_state=init,
                               period=periods, cap=caps)


class Simulation:
    """A built-topology simulation instance."""

    def __init__(self, b: SimBuilder, naive: bool, cap_phys: int | None,
                 sample_period: float, max_samples: int,
                 super_epoch: int | None = None, donate: bool = True,
                 pad_shape: dict[str, int] | None = None, device=None,
                 cuda_graph: bool = True):
        self.device = resolve_device(device)
        pad_shape = pad_shape or {}
        unknown = set(pad_shape) - {k.name for k in b.kinds}
        assert not unknown, f"pad_shape names unknown kinds {sorted(unknown)}"
        self.kinds = [_pad_kind(k, pad_shape[k.name])
                      if k.name in pad_shape else k for k in b.kinds]
        self.naive = naive
        self.donate = donate
        self._graph_asked = bool(cuda_graph)
        self.cuda_graph = self._graph_asked and self.device.type == "cuda"
        self.sample_period = float(sample_period)
        self.max_samples = int(max_samples) if sample_period > 0 else 0

        # --- component + port numbering ---------------------------------
        self.comp_base, self.port_base = [], []
        nc = pg = 0
        for k in self.kinds:
            self.comp_base.append(nc)
            self.port_base.append(pg)
            nc += k.n_instances
            pg += k.n_ports_total
        self.n_comp, self.n_ports_g = nc, pg

        if super_epoch is None:
            if self.device.type == "cuda":
                super_epoch = CUDA_SUPER_EPOCH
            else:
                # the reference's heuristic (measured on CPU XLA there)
                super_epoch = 2 if pg <= 4096 else 1
        self.super_epoch = max(1, int(super_epoch))

        periods = np.concatenate([k.periods() for k in self.kinds]) \
            if self.kinds else np.zeros((0,), np.float32)
        caps = np.concatenate([k.caps().reshape(-1) for k in self.kinds]) \
            if self.kinds else np.zeros((0,), np.int32)
        self.cap_phys = int(cap_phys or max(4, caps.max(initial=1)))
        assert caps.max(initial=1) <= self.cap_phys

        # --- connections -------------------------------------------------
        def pid(ref):
            name, inst, port = ref
            ki = b._kind_ix[name]
            k = self.kinds[ki]
            assert 0 <= inst < k.n_instances and 0 <= port < k.n_ports, ref
            return self.port_base[ki] + inst * k.n_ports + port

        n_conn = max(1, len(b.conns))
        max_m = max([len(m) for m, _ in b.conns], default=2)
        member = np.full((n_conn, max_m), -1, np.int32)
        latency = np.ones((n_conn,), np.float32)
        port_conn = np.full((pg,), -1, np.int32)
        peer = np.full((pg,), -1, np.int32)
        for c, (members, lat) in enumerate(b.conns):
            pids = [pid(m) for m in members]
            assert len(set(pids)) == len(pids), "port connected twice"
            for j, p in enumerate(pids):
                assert port_conn[p] == -1, "each port is served by one connection"
                member[c, j] = p
                port_conn[p] = c
            latency[c] = lat
            if len(pids) == 2:
                peer[pids[0]], peer[pids[1]] = pids[1], pids[0]
        self.n_conn, self.max_m = n_conn, max_m

        dev = self.device
        on = lambda a: _from_np(a, dev)
        self.c = dict(caps=on(caps), peer=on(peer), port_conn=on(port_conn))
        self._periods_np, self._caps_np = periods, caps
        self._latency_np = latency
        # --- hoisted delivery constants (gather/select formulation) ------
        # slot_of_port: inverse of the member matrix — each port is served
        # by at most one connection slot, so winner pops become static takes.
        CM = n_conn * max_m
        slot = np.full((pg + 1,), CM, np.int64)
        flat_m = member.reshape(-1)
        for sl_ix, g in enumerate(flat_m):
            if g >= 0:
                slot[g] = sl_ix
        self._mps_np = np.maximum(member, 0)
        self._valid_np = member >= 0
        self._slot_of_port = on(slot[:pg])
        self._mps = on(self._mps_np.astype(np.int64))
        self._valid = on(self._valid_np)
        # member matrix with invalid slots pointing past the wake-mask pad
        self._member_sent = on(np.where(member >= 0, member, pg)
                               .astype(np.int64))
        self._apg = on(np.arange(pg, dtype=np.int32))             # [PG]
        self._acap = on(np.arange(self.cap_phys, dtype=np.int32))  # [CAP]
        self._am = on(np.arange(max_m, dtype=np.int32))           # [M]
        self._acm = on(np.arange(CM, dtype=np.int32))             # [C*M]
        self._asamp = on(np.arange(max(self.max_samples, 1), dtype=np.int32))
        self._all_conns = torch.ones((n_conn,), dtype=torch.bool, device=dev)
        self._no_port = torch.zeros((1,), dtype=torch.bool, device=dev)
        self._build_kind_consts()
        self._dp = self.default_params()
        self._graphs: dict[Any, _Graph] = {}
        self._lane_blocks: dict[Any, LaneBlock] = {}
        self._twins: dict[torch.device, Simulation] = {}
        # the captured block of the last run on the card, for profiling:
        # ``last_graph.graph.replay()`` advances its static state one block
        self.last_graph: _Graph | None = None

    # ------------------------------------------------------------------
    def _build_kind_consts(self):
        """Hoist per-kind static index/constant tensors out of the hot loop."""
        self._kc = []
        peer = self.c["peer"].cpu().numpy()
        on = lambda a: _from_np(a, self.device)
        for ki, k in enumerate(self.kinds):
            n, p = k.n_instances, k.n_ports
            np_k = n * p
            cb, pb = self.comp_base[ki], self.port_base[ki]
            self._kc.append(_KindConsts(
                name=k.name, n=n, p=p, np_k=np_k, cb=cb, pb=pb,
                csl=slice(cb, cb + n),
                periods=on(self._periods_np[cb:cb + n]),
                caps=on(self._caps_np[pb:pb + np_k].reshape(n, p)),
                caps_f=on(self._caps_np[pb:pb + np_k]),
                gid=on(np.arange(pb, pb + np_k, dtype=np.int32)
                       .reshape(n, p)),
                peer=on(peer[pb:pb + np_k].reshape(n, p))))

    def default_params(self) -> SimParams:
        """The :class:`SimParams` this topology was built with.

        Running with ``params=None`` is equivalent to running with these
        values; override leaves to explore other design points without
        rebuilding.
        """
        return SimParams(
            conn_latency=_from_np(self._latency_np.copy(), self.device),
            periods={kc.name: kc.periods for kc in self._kc},
            kind={k.name: (tree_map(lambda a: _to_device(a, self.device),
                                    k.params)
                           if k.params is not None else {})
                  for k in self.kinds})

    def prefix_masks(self, counts: dict[str, int]) -> tuple[dict, torch.Tensor]:
        """Activity masks for a *prefix sub-shape* of this topology.

        ``counts`` maps kind names to active instance counts (unnamed
        kinds stay fully active); instances ``0..count-1`` of each kind
        are active.  Returns ``(inst_mask, conn_mask)`` for
        :class:`SimParams`: a connection is active iff any of its member
        ports belongs to an active instance — so per-instance links
        between masked instances go quiet while shared fabrics (a family
        crossbar with masked member ports) stay live.

        The prefix discipline is what keeps masked runs bit-identical to
        an unpadded build of the sub-shape: variable-count members must
        occupy the leading member slots of their connection in instance
        order, fixed members the trailing slots, so round-robin
        arbitration sees the same relative slot order at every shape.
        """
        unknown = set(counts) - {k.name for k in self.kinds}
        assert not unknown, f"unknown kinds {sorted(unknown)}"
        inst, act = {}, []
        for k in self.kinds:
            n = int(counts.get(k.name, k.n_instances))
            assert 0 <= n <= k.n_instances, (k.name, n, k.n_instances)
            m = np.arange(k.n_instances) < n
            inst[k.name] = _from_np(m, self.device)
            act.append(np.repeat(m, k.n_ports))
        port_act = (np.concatenate(act) if act else np.zeros((0,), bool))
        conn = np.any(self._valid_np & port_act[self._mps_np], axis=1)
        return inst, _from_np(conn, self.device)

    def _flat_inst_mask(self, inst_mask: dict) -> torch.Tensor:
        """[NC] bool — per-component activity, ordered by kind
        registration (component id order)."""
        parts = [inst_mask[k.name] for k in self.kinds]
        if not parts:
            return torch.zeros((0,), dtype=torch.bool, device=self.device)
        return parts[0] if len(parts) == 1 else torch.cat(parts)

    def set_default_peers(self, mapping: dict[int, int]):
        """Rewrite default peers (global port id -> peer port id) and refresh
        the hoisted per-kind constants.  Safe at any time: captured graphs,
        which hold the old constants, are dropped."""
        peer = self.c["peer"].cpu().numpy().copy()
        for src, dst in mapping.items():
            peer[src] = dst
        self.c["peer"] = _from_np(peer, self.device)
        self._build_kind_consts()
        self._graphs.clear()
        self._lane_blocks.clear()
        self._twins.clear()
        self.last_graph = None

    def on_device(self, device) -> "Simulation":
        """This simulation on ``device``: ``self`` on its own device,
        elsewhere a cached twin holding a copy of every hoisted constant
        there and no block or graph of its own yet (a placement of the
        sharded lanes and PDES shards, ``core.pdes``).  Twins are dropped
        by ``set_default_peers``."""
        dev = canonical_device(resolve_device(device))
        if dev == canonical_device(self.device):
            return self
        tw = self._twins.get(dev)
        if tw is None:
            tw = copy.copy(self)
            tw.__dict__.update({k: v.to(dev) for k, v in vars(self).items()
                                if isinstance(v, torch.Tensor)})
            tw.device = dev
            tw.cuda_graph = self._graph_asked and dev.type == "cuda"
            tw.c = {k: v.to(dev) for k, v in self.c.items()}
            tw._build_kind_consts()
            tw._dp = tw.default_params()
            tw._graphs, tw._lane_blocks, tw._twins = {}, {}, {}
            tw.last_graph = None
            self._twins[dev] = tw
        return tw

    # ------------------------------------------------------------------
    def port_id(self, kind_name: str, inst: int, port: int = 0) -> int:
        """Global port id for (kind, instance, port) — for explicit addressing."""
        for ki, k in enumerate(self.kinds):
            if k.name == kind_name:
                assert 0 <= inst < k.n_instances and 0 <= port < k.n_ports
                return self.port_base[ki] + inst * k.n_ports + port
        raise KeyError(kind_name)

    def comp_id(self, kind_name: str, inst: int) -> int:
        for ki, k in enumerate(self.kinds):
            if k.name == kind_name:
                return self.comp_base[ki] + inst
        raise KeyError(kind_name)

    # ------------------------------------------------------------------
    def _flat(self, seg: dict) -> torch.Tensor:
        """Flat global view (ordered by kind => global port id) of a
        per-kind segment dict."""
        parts = [seg[k.name] for k in self.kinds]
        if not parts:
            return torch.zeros((0,), dtype=torch.int32, device=self.device)
        return parts[0] if len(parts) == 1 else torch.cat(parts)

    def flat_in_cnt(self, s: SimState) -> torch.Tensor:
        return self._flat(s.in_cnt)

    def flat_out_cnt(self, s: SimState) -> torch.Tensor:
        return self._flat(s.out_cnt)

    def copy_state(self, s: SimState) -> SimState:
        """Deep-copy a state so the original survives a donating ``run()``."""
        return tree_map(torch.clone, s)

    # ------------------------------------------------------------------
    def init_state(self) -> SimState:
        cap, w, dev = self.cap_phys, MSG_WORDS, self.device
        next_tick = []
        for k in self.kinds:
            t0 = INF if k.start_asleep else 0.0
            next_tick.append(torch.full((k.n_instances,), t0,
                                        dtype=torch.float32, device=dev))
        seg = lambda shape_fn: {kc.name: shape_fn(kc) for kc in self._kc}
        zeros_np = lambda kc: torch.zeros((kc.np_k,), dtype=torch.int32,
                                          device=dev)
        zeros_buf = lambda kc: torch.zeros((kc.np_k, cap, w),
                                           dtype=torch.int32, device=dev)
        # copy user-supplied init trees: a run must never alias the
        # builder's tensors
        comp_state = tree_map(
            lambda a: _to_device(a, dev).clone(),
            {k.name: k.init_state for k in self.kinds})
        return SimState(
            time=torch.zeros((), dtype=torch.float32, device=dev),
            next_tick=(torch.cat(next_tick) if next_tick
                       else torch.zeros((0,), dtype=torch.float32,
                                        device=dev)),
            conn_wake=torch.full((self.n_conn,), INF, dtype=torch.float32,
                                 device=dev),
            comp_state=comp_state,
            in_buf=seg(zeros_buf), in_head=seg(zeros_np), in_cnt=seg(zeros_np),
            out_buf=seg(zeros_buf), out_head=seg(zeros_np),
            out_cnt=seg(zeros_np),
            rr=torch.zeros((self.n_conn,), dtype=torch.int32, device=dev),
            stats=Stats.zero(self.n_comp, dev),
            buf_samples=torch.zeros((max(self.max_samples, 1),
                                     self.n_ports_g), dtype=torch.int32,
                                    device=dev),
            sample_idx=torch.zeros((), dtype=torch.int32, device=dev),
            next_sample=torch.full((), self.sample_period
                                   if self.sample_period else INF,
                                   dtype=torch.float32, device=dev),
        )

    def _port_min_to_comp(self, wake_port):
        """Per-port wake times [PG] -> per-component wake times [NC] by a
        min over each component's (contiguous) ports — static reshapes."""
        if not self.kinds:
            return torch.zeros((0,), dtype=torch.float32, device=self.device)
        parts = [torch.amin(wake_port[kc.pb:kc.pb + kc.np_k]
                            .reshape(kc.n, kc.p), dim=1)
                 for kc in self._kc]
        return parts[0] if len(parts) == 1 else torch.cat(parts)

    def _derived(self, P: SimParams) -> dict:
        """Per-run broadcasts of the params: per-connection latency repeated
        over the (static) member axis, per-kind periods over each kind's
        (static) port count, and the flat activity mask."""
        rep = lambda a, n: a.unsqueeze(1).expand(-1, n).reshape(-1)
        pp = [rep(P.periods[kc.name], kc.p) for kc in self._kc]
        return dict(
            lat_f=rep(P.conn_latency, self.max_m),                  # [C*M]
            port_period=(pp[0] if len(pp) == 1 else torch.cat(pp))
            if pp else None,                                        # [PG]
            inst_flat=(self._flat_inst_mask(P.inst_mask)
                       if P.inst_mask is not None else None))

    # ------------------------------------------------------------------
    # Delivery phase: round-robin arbitrated crossbar per connection.
    #
    # Connection membership is static, so source-side pops are static takes
    # through ``slot_of_port``; destination-side state is computed *per
    # port* — round-robin arbitration admits at most one winner per
    # destination port per connection, so a [C*M, PG] one-hot reduces
    # exactly to each port's winning slot, and pushes become masked selects
    # on each kind's segment.  A message's dst must be a port of its
    # serving connection (the crossbar contract).
    def _deliver(self, s: SimState, D: dict, t, active, wake1):
        if not self.kinds:
            return s, torch.zeros((0,), dtype=torch.float32,
                                  device=self.device)
        c = self.c
        lat_f, port_period = D["lat_f"], D["port_period"]
        C, M, PG = self.n_conn, self.max_m, self.n_ports_g
        CM = C * M
        mps, valid = self._mps, self._valid                    # [C, M]
        # flat views of the per-port tensors
        in_head_f, in_cnt_f = self._flat(s.in_head), self._flat(s.in_cnt)
        out_head_f, out_cnt_f = self._flat(s.out_head), self._flat(s.out_cnt)
        out_buf_f = self._flat(s.out_buf)

        have = (out_cnt_f[mps] > 0) & valid & active[:, None]
        head_ix = out_head_f[mps]                        # [C, M]
        head = out_buf_f[mps, head_ix.long()]            # [C, M, W]
        dst = head[:, :, W_DST]
        dsts = torch.clamp(dst, 0, PG - 1)
        OH0 = dsts.reshape(CM)[:, None] == self._apg     # [CM, PG] one-hot
        space_port = in_cnt_f < c["caps"]                # [PG]
        space = torch.any(OH0 & space_port[None, :], dim=1).reshape(C, M)
        req = have & space & (dst >= 0)
        prio = (self._am[None, :] - s.rr[:, None]) % M
        # m loses if some m2 requests the same destination with lower prio.
        beats = (req[:, None, :] & (dst[:, :, None] == dst[:, None, :])
                 & (prio[:, None, :] < prio[:, :, None]))
        win = req & ~torch.any(beats, dim=2)             # [C, M]
        win_f = win.reshape(CM)
        OHwin = OH0 & win_f[:, None]                     # [CM, PG]

        # per destination port: did it receive, and from which member slot
        got = torch.any(OHwin, dim=0)                    # [PG]
        wslot = torch.sum(OHwin.to(torch.int32) * self._acm[:, None], dim=0,
                          dtype=torch.int32).long()      # [PG]
        arrive = t + lat_f                               # [CM]
        msg_f = head.reshape(CM, MSG_WORDS)
        msg_f = torch.cat([msg_f[:, :W_TIME], f2i(arrive)[:, None],
                           msg_f[:, W_TIME + 1:]], dim=1)
        msg_port = msg_f[wslot]                          # [PG, W]
        arr_port = torch.where(got, arrive[wslot], INF)  # [PG]
        t_port = (in_head_f + in_cnt_f) % self.cap_phys
        capOH = (t_port[:, None] == self._acap) & got[:, None]    # [PG, CAP]
        goti = got.to(torch.int32)

        # source-side pops: static take (each port has one member slot)
        win_pad = torch.cat([win_f, self._no_port])
        dec = win_pad[self._slot_of_port].to(torch.int32)         # [PG]
        full_before_out = out_cnt_f == c["caps"]

        # Rule 1: arrival wakes the destination; rule 2 / backprop forward
        # half: freed source out-buffer wakes its owner.  Both computed per
        # port, then min-reduced onto components (ports are owner-major).
        freed_port = (dec > 0) & full_before_out
        wake_port = torch.minimum(
            _align_at_or_after(arr_port, port_period),
            torch.where(freed_port, _align_after(t, port_period), INF))
        wake_comp = self._port_min_to_comp(wake_port)

        # per-kind segment updates (pure where/add on each segment slice)
        out_cnt_seg, out_head_seg = dict(s.out_cnt), dict(s.out_head)
        in_buf_seg, in_cnt_seg = dict(s.in_buf), dict(s.in_cnt)
        for kc in self._kc:
            sl = slice(kc.pb, kc.pb + kc.np_k)
            out_cnt_seg[kc.name] = s.out_cnt[kc.name] - dec[sl]
            out_head_seg[kc.name] = (s.out_head[kc.name]
                                     + dec[sl]) % self.cap_phys
            in_cnt_seg[kc.name] = s.in_cnt[kc.name] + goti[sl]
            in_buf_seg[kc.name] = torch.where(
                capOH[sl][:, :, None], msg_port[sl][:, None, :],
                s.in_buf[kc.name])

        # round-robin pointer: advance past the last-served winner
        gp = torch.where(win, prio, -1)
        any_win = torch.any(win, dim=1)
        last = torch.argmax(gp, dim=1).to(torch.int32)
        rr = torch.where(any_win, (last + 1) % M, s.rr)

        # connection self-scheduling: if it delivered and work remains, wake
        # next cycle; otherwise sleep (backprop / sends will wake it).
        out_cnt_f2 = out_cnt_f - dec
        pending = torch.any(valid & (out_cnt_f2[mps] > 0), dim=1)
        nw = torch.where(any_win & pending, wake1, INF)
        conn_wake = torch.where(active, nw, s.conn_wake)

        delivered = torch.sum(win_f.to(torch.int32), dtype=torch.int32)
        s = dataclasses.replace(
            s, in_buf=in_buf_seg, in_cnt=in_cnt_seg,
            out_cnt=out_cnt_seg, out_head=out_head_seg, rr=rr,
            conn_wake=conn_wake,
            stats=dataclasses.replace(s.stats,
                                      delivered=s.stats.delivered + delivered))
        return s, wake_comp

    # ------------------------------------------------------------------
    # Tick phase: vmap each kind's tick_fn over its instances; with the
    # segmented layout each kind reads/writes only its own segment.
    def _tick_kinds(self, s: SimState, P: SimParams, t, wake1):
        comp_state = dict(s.comp_state)
        in_buf, in_head, in_cnt = dict(s.in_buf), dict(s.in_head), dict(s.in_cnt)
        out_buf, out_head, out_cnt = (dict(s.out_buf), dict(s.out_head),
                                      dict(s.out_cnt))
        total_ticks = s.stats.ticks
        total_prog = s.stats.progress_ticks
        next_parts, busy_parts = [], []
        tf = t.to(torch.float32)
        wake_p_segs = {}           # kind -> [n*p] bool: port wants its conn

        for ki, kind in enumerate(self.kinds):
            kc = self._kc[ki]
            n, p, name = kc.n, kc.p, kc.name
            periods_k = P.periods[name]
            nt_k = s.next_tick[kc.csl]
            if self.naive:
                r = torch.remainder(t, periods_k)
                mask = (torch.abs(r) < EPS) | (torch.abs(r - periods_k) < EPS)
            else:
                mask = nt_k <= t + EPS
            if P.inst_mask is not None:
                # family activity mask: masked-off instances never tick
                # (and therefore never count toward ticks/progress/busy)
                mask = mask & P.inst_mask[name]

            sh = lambda a: a.reshape(n, p, *a.shape[1:])
            # kind params are closed over, not vmapped: every instance of a
            # kind sees the same parameter tree
            kp = P.kind.get(name, {})
            wants_params = kind.params is not None

            def one(st_i, ib, ih, ic, ob, oh, oc, cp, g, pe, kind=kind,
                    kp=kp, wants_params=wants_params):
                ports = Ports(ib, ih, ic, ob, oh, oc, cp, g, pe, tf)
                out = (kind.tick_fn(st_i, ports, tf, kp) if wants_params
                       else kind.tick_fn(st_i, ports, tf))
                st2, ports2, res = normalize_tick_output(out)
                return (st2, ports2.in_buf, ports2.in_head, ports2.in_cnt,
                        ports2.out_buf, ports2.out_head, ports2.out_cnt,
                        res.progress, res.next_time)

            (st2, ib2, ih2, ic2, ob2, oh2, oc2, prog, nxt) = torch.func.vmap(
                one)(comp_state[name], sh(in_buf[name]), sh(in_head[name]),
                     sh(in_cnt[name]), sh(out_buf[name]), sh(out_head[name]),
                     sh(out_cnt[name]), kc.caps, kc.gid, kc.peer)

            def sel(new, old, m=mask):
                mm = m.reshape(m.shape + (1,) * (new.ndim - 1))
                return torch.where(mm, new, old)

            comp_state[name] = tree_map(sel, st2, comp_state[name])
            fl = lambda a: a.reshape(n * p, *a.shape[2:])
            pmask = mask.unsqueeze(1).expand(n, p).reshape(n * p)

            def psel(new, old):
                mm = pmask.reshape(pmask.shape + (1,) * (new.ndim - 1))
                return torch.where(mm, new, old)

            ic_old, oc_old = in_cnt[name], out_cnt[name]
            in_buf[name] = psel(fl(ib2), in_buf[name])
            in_head[name] = psel(fl(ih2), in_head[name])
            in_cnt[name] = psel(fl(ic2), in_cnt[name])
            out_buf[name] = psel(fl(ob2), out_buf[name])
            out_head[name] = psel(fl(oh2), out_head[name])
            out_cnt[name] = psel(fl(oc2), out_cnt[name])

            prog = prog & mask
            if not self.naive:
                # Rule 3: progress => next cycle; no progress => sleep.
                base = torch.where(prog, _align_after(t, periods_k), INF)
                custom = torch.where(nxt > -0.5, torch.maximum(nxt, t + EPS),
                                     base)
                # In-flight arrivals: a ticked component must not sleep past
                # the ready time of a message already in its buffers (rule 1
                # for arrivals whose delivery preceded this tick).  Ready-now
                # messages do NOT re-wake — unblocking is backprop's job.
                hb = in_buf[name][:, :, W_TIME]             # [n*p, CAP]
                hOH = in_head[name][:, None] == self._acap  # one-hot gather
                hr = i2f(torch.sum(hb * hOH.to(torch.int32), dim=1,
                                   dtype=torch.int32))
                pend = (in_cnt[name] > 0) & (hr > t + EPS)
                w = torch.where(pend, hr, INF).reshape(n, p)
                arr = _align_at_or_after(torch.amin(w, dim=1), periods_k)
                custom = torch.minimum(custom, arr)
                nt_k = torch.where(mask, custom, nt_k)
            next_parts.append(nt_k)

            # Availability Backpropagation (backward half): incoming buffer
            # full->not-full wakes the serving connection; any new send wakes
            # the connection too.
            ic_new, oc_new = in_cnt[name], out_cnt[name]
            in_freed = (ic_old == kc.caps_f) & (ic_new < kc.caps_f)
            wake_p_segs[name] = in_freed | (oc_new > oc_old)

            total_ticks = total_ticks + torch.sum(mask.to(torch.int32),
                                                  dtype=torch.int32)
            total_prog = total_prog + torch.sum(prog.to(torch.int32),
                                                dtype=torch.int32)
            busy_parts.append(s.stats.busy[kc.csl] + prog.to(torch.int32))

        # a connection wakes iff any of its (static) member ports asked —
        # static take through the member matrix
        if self.kinds:
            wake_p_f = self._flat(wake_p_segs)
            wake_pad = torch.cat([wake_p_f, self._no_port])
            conn_asked = torch.any(wake_pad[self._member_sent], dim=1)
            wake_conn = torch.where(conn_asked, wake1, INF)
            next_tick = (next_parts[0] if len(next_parts) == 1
                         else torch.cat(next_parts))
            busy = busy_parts[0] if len(busy_parts) == 1 else \
                torch.cat(busy_parts)
        else:
            wake_conn = torch.full((self.n_conn,), INF, dtype=torch.float32,
                                   device=self.device)
            next_tick, busy = s.next_tick, s.stats.busy

        stats = dataclasses.replace(
            s.stats, ticks=total_ticks, progress_ticks=total_prog, busy=busy)
        s = dataclasses.replace(
            s, next_tick=next_tick, comp_state=comp_state, in_buf=in_buf,
            in_head=in_head, in_cnt=in_cnt, out_buf=out_buf,
            out_head=out_head, out_cnt=out_cnt, stats=stats)
        return s, wake_conn

    # ------------------------------------------------------------------
    def _epoch(self, s: SimState, P: SimParams, D: dict):
        if self.naive:
            t = s.time  # process the current cycle, then advance by one
            active = self._all_conns
        else:
            t = torch.min(s.conn_wake)
            if self.n_comp:
                t = torch.minimum(torch.min(s.next_tick), t)
            if self.max_samples:
                t = torch.minimum(t, s.next_sample)
            active = s.conn_wake <= t + EPS
        if P.conn_mask is not None:
            # family activity mask: masked-off connections never deliver
            active = active & P.conn_mask

        wake1 = _align_after(t, 1.0)          # shared next-cycle wake point
        s = dataclasses.replace(s, time=t)
        s, wake_comp = self._deliver(s, D, t, active, wake1)
        s, wake_conn = self._tick_kinds(s, P, t, wake1)
        next_tick = torch.minimum(s.next_tick, wake_comp)
        conn_wake = torch.minimum(s.conn_wake, wake_conn)
        # Masked-off rows are pinned to +inf by broadcast selects so the
        # next-event min never schedules them.
        if D["inst_flat"] is not None:
            next_tick = torch.where(D["inst_flat"], next_tick, INF)
        if P.conn_mask is not None:
            conn_wake = torch.where(P.conn_mask, conn_wake, INF)
        s = dataclasses.replace(
            s, next_tick=next_tick, conn_wake=conn_wake,
            stats=dataclasses.replace(s.stats, epochs=s.stats.epochs + 1))
        if self.max_samples:
            do = s.next_sample <= t + EPS
            row = s.sample_idx % self.max_samples
            s = dataclasses.replace(
                s,
                buf_samples=torch.where(
                    do & (self._asamp == row)[:, None],
                    self._flat(s.in_cnt)[None, :], s.buf_samples),
                sample_idx=s.sample_idx + do.to(torch.int32),
                next_sample=torch.where(do, s.next_sample + self.sample_period,
                                        s.next_sample))
        if self.naive:
            s = dataclasses.replace(s, time=t + 1.0)
        return s

    def _next_event(self, s: SimState):
        t = torch.min(s.conn_wake)
        if self.n_comp:
            t = torch.minimum(torch.min(s.next_tick), t)
        if self.max_samples:
            t = torch.minimum(t, s.next_sample)
        return t

    def _live(self, s: SimState, until, max_epochs):
        """Liveness predicate of the hot loop: events remain before the
        horizon AND the epoch budget is not exhausted.  ``until`` and
        ``max_epochs`` are device tensors."""
        if self.naive:
            more = s.time <= until + EPS
        else:
            more = self._next_event(s) <= until + EPS
        return more & (s.stats.epochs < max_epochs)

    def _block(self, s: SimState, P: SimParams, until, max_epochs, k: int):
        """``k`` epochs, each an exact no-op once the run is not live (the
        identity branch of the reference's ``lax.cond``)."""
        D = self._derived(P)
        for _ in range(k):
            live = self._live(s, until, max_epochs)
            s = tree_map(lambda new, old: torch.where(live, new, old),
                         self._epoch(s, P, D), s)
        return s

    def _lane_epochs(self, s: SimState, P: SimParams, until, max_epochs,
                     k: int) -> SimState:
        """``_block`` of every lane: ``torch.func.vmap`` over the leading
        lane axis of ``(s, P, until, max_epochs)``.  The state and params
        dataclasses enter and leave vmap as their leaves.  ``_tick_kinds``
        vmaps again over instances inside, so the kind params it closes
        over are per lane."""
        def one(s_l, p_l, u, m):
            out = self._block(tree_unflatten(s, s_l), tree_unflatten(P, p_l),
                              u, m, k)
            return tree_leaves(out)

        leaves = torch.func.vmap(one)(tree_leaves(s), tree_leaves(P), until,
                                      max_epochs)
        return tree_unflatten(s, leaves)

    def _lane_live(self, s: SimState, until, max_epochs):
        """``_live`` of every lane: ``[b]`` bool."""
        return torch.func.vmap(
            lambda s_l, u, m: self._live(tree_unflatten(s, s_l), u, m))(
                tree_leaves(s), until, max_epochs)

    def lane_block(self, states_b: SimState,
                   params_b: SimParams) -> tuple[LaneBlock, bool]:
        """The :class:`LaneBlock` for this batch's lane count and structure
        (keys, shapes, dtypes of the batch and its params), and whether it
        was made by this call: captured on first use on the card, run
        eagerly elsewhere.  Capture failures raise: there is no eager
        fallback on the card."""
        key = (_structure(states_b), _structure(params_b))
        blk = self._lane_blocks.get(key)
        if blk is not None:
            return blk, False
        blk = self._lane_blocks[key] = LaneBlock(self, states_b, params_b)
        return blk, True

    def _device_ctx(self):
        # tick functions make their constants with factory calls; on the
        # card these must land there (on the CPU they already do)
        return (torch.device(self.device) if self.device.type == "cuda"
                else contextlib.nullcontext())

    def _run_eager(self, s: SimState, until: float, max_epochs: int,
                   P: SimParams) -> SimState:
        dev = self.device
        until_t = torch.full((), until, dtype=torch.float32, device=dev)
        maxe_t = torch.full((), max_epochs, dtype=torch.int32, device=dev)
        with self._device_ctx():
            while True:
                s = self._block(s, P, until_t, maxe_t, self.super_epoch)
                if not bool(self._live(s, until_t, maxe_t)):
                    return s

    def _capture(self, state: SimState, P: SimParams) -> _Graph:
        """Capture one block of ``super_epoch`` epochs over static buffers:
        it runs the block, copies the result back into the buffers and
        computes ``live`` of the result."""
        static = dict(state=self.copy_state(state), params=tree_map(
            torch.clone, P),
            until=torch.zeros((), dtype=torch.float32, device=self.device),
            max_epochs=torch.zeros((), dtype=torch.int32,
                                   device=self.device))
        # one eager epoch on a throwaway copy first, on a side stream, so
        # that lazy initialisation happens outside the capture
        side = torch.cuda.Stream(device=self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side), self._device_ctx():
            self._block(self.copy_state(state), static["params"],
                        static["until"], static["max_epochs"], 1)
        torch.cuda.current_stream(self.device).wait_stream(side)
        torch.cuda.synchronize(self.device)
        graph = torch.cuda.CUDAGraph()
        with _no_gc(), torch.cuda.graph(graph), self._device_ctx():
            out = self._block(static["state"], static["params"],
                              static["until"], static["max_epochs"],
                              self.super_epoch)
            tree_map(lambda dst, src: dst.copy_(src), static["state"], out)
            live = self._live(static["state"], static["until"],
                              static["max_epochs"])
        del out
        return _Graph(graph=graph, live=live, **static)

    def _run_graph(self, s: SimState, until: float, max_epochs: int,
                   P: SimParams) -> SimState:
        key = _structure(P)
        g = self._graphs.get(key)
        if g is None:
            g = self._graphs[key] = self._capture(s, P)
        self.last_graph = g
        tree_map(lambda dst, src: dst.copy_(src), g.state, s)
        tree_map(lambda dst, src: dst.copy_(src), g.params, P)
        g.until.fill_(until)
        g.max_epochs.fill_(max_epochs)
        while True:
            g.graph.replay()
            if not bool(g.live):
                return self.copy_state(g.state)

    def _run(self, s: SimState, until: float, max_epochs: int,
             params: SimParams | None = None) -> SimState:
        P = self._dp if params is None else params
        if self.cuda_graph:
            return self._run_graph(s, until, max_epochs, P)
        return self._run_eager(s, until, max_epochs, P)

    def run(self, state: SimState, until: float,
            max_epochs: int = 2_000_000,
            params: SimParams | None = None) -> SimState:
        """Advance the simulation to virtual time ``until`` (cycles).

        When the simulation was built with ``donate=True`` (the default),
        ``state`` is consumed and must not be reused afterwards — keep
        using the *returned* state, or pass ``copy_state(state)`` if the
        input must survive.

        ``until`` and ``max_epochs`` are device tensors inside the loop:
        changing either re-runs the same captured graph.

        ``params`` (optional) overrides the timing/model parameters for
        this run (see :class:`SimParams` / ``default_params()``); it is
        never consumed.  ``None`` runs the build-time defaults."""
        assert until < 2 ** 24, "float32 cycle precision bound (DESIGN.md)"
        if self.donate:
            check_not_consumed(state)
        out = self._run(state, until, max_epochs, params)
        if self.donate:
            object.__setattr__(state, "_consumed", True)
        return out

