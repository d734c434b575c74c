"""Sharded conservative PDES (paper §3.3, scaled out).  Counterpart of
``repro.core.pdes``; its states, times, stats and window counts are the
reference's bit for bit.

Akita parallelizes by triggering same-timestamp events on multiple CPU
cores.  The reference shards the *component axis* over devices with
``shard_map``: each shard owns a replica of the shard-local topology plus
one ``_remote`` gateway kind whose ports are cross-shard channels.  Here
the shards are *lanes*: a stacked state ``[D, ...]`` whose shard axis is
the lane axis of the engine's lane-batched block (``core.engine``
``LaneBlock``), so one CUDA graph runs a window for every shard of a
device at once.

Conservative synchronization (Fujimoto [16]; null-message-free because
the lookahead is static), as in the reference:

* all shards agree on the next event time: the reference's ``pmin`` is a
  ``min`` over the shard axis;
* each shard runs a *window* to ``t_end - 2*EPS``, ``t_end = min(t_glob +
  lookahead, horizon)``, on its own: every lane of the block freezes at
  that horizon;
* cross-shard messages ride fixed-capacity mailboxes exchanged at the
  window boundary: the reference's ``ppermute`` by peer offset ``1+p``
  is a roll of the mailbox tensor along the shard axis.

Every time value of the window (``t_glob``, ``t_end``, the block's
horizon, the wake of the ingress connections) is an f32 tensor computed
by the reference's f32 operations, never a Python float.

Placements.  A mesh is a tuple of ``torch.device``s (:func:`lane_mesh`).
It holds the first n cards, or the CPU when the caller asks for it, and
may name one device several times: ``REPRO_TORCH_FORCE_DEVICES=N`` makes
N placements of the default device, the counterpart of XLA's
``--xla_force_host_platform_device_count=N`` that the reference's tests
use.  The variable is read when a mesh is made, never at import.  A
placement changes no result.  Shards are split evenly over the mesh in
order, so each placement holds a contiguous group of ``D / len(mesh)``
shards (the reference needs one shard per device; here several may share
one).  Consecutive placements of one device share one block, whose lanes
are their shards: splitting them would only serialize smaller replays of
the same graph.  Blocks on different devices exchange their mailboxes
with ``.to(device)``.

The host reads ``t_glob`` once per window, and the block's ``more`` once
per block step (on the card a window of ``lookahead`` cycles is one
block of ``ceil(lookahead)`` epochs unless a shard has more event times
in it).

Component code is untouched — the same single-instance ``tick_fn``
written for the single-device engine runs here, which is the paper's
"transparent parallel simulation" claim (DX-3).  ``ShardedSim.lower``
plans a run for the dry run (``repro_torch.launch.dryrun``) without
running it: the per-shard bytes of the stacked state and the collectives
of a window.
"""
from __future__ import annotations

import math
import os

import numpy as np
import torch

from .. import resolve_device
from .component import ComponentKind, TickResult
from .engine import (INF, LaneBlock, SimBuilder, _align_after,
                     canonical_device, tree_leaves, tree_map)
from .message import MSG_WORDS, W_DST, W_TIME, f2i
from .ports import EPS

REMOTE_KIND = "_remote"

LANE_AXIS = "lanes"          # the batched-DSE mesh axis (config lanes)

FORCE_DEVICES_ENV = "REPRO_TORCH_FORCE_DEVICES"

# the reference's per-window epoch budget (``ShardedSim._step_window``)
WINDOW_MAX_EPOCHS = 1_000_000

_MESHES: dict[tuple, tuple] = {}


def _forced() -> int | None:
    v = os.environ.get(FORCE_DEVICES_ENV)
    if not v:
        return None
    n = int(v)
    if n < 1:
        raise ValueError(f"{FORCE_DEVICES_ENV}={v!r}: need at least 1")
    return n


def device_count(device=None) -> int:
    """The number of placements a mesh can span: ``REPRO_TORCH_FORCE_
    DEVICES`` when set, else the visible cards (``device`` on the card or
    ``None`` with CUDA present), else 1 (the CPU).  Counting never
    raises; :func:`lane_mesh` does, through ``resolve_device``."""
    n = _forced()
    if n is not None:
        return n
    kind = (torch.device(device).type if device is not None else
            "cuda" if torch.cuda.is_available() else "cpu")
    return torch.cuda.device_count() if kind == "cuda" else 1


def placements(device=None) -> tuple[torch.device, ...]:
    """Every placement of ``device``'s kind (``None``: the card), in
    order: N placements of the device under ``REPRO_TORCH_FORCE_DEVICES=N``,
    else every card, else the CPU once."""
    base = resolve_device(device)
    if base.type == "cuda":
        base = torch.device("cuda", base.index or 0)
    n = _forced()
    if n is not None:
        return (base,) * n
    if base.type == "cuda":
        return tuple(torch.device("cuda", i)
                     for i in range(torch.cuda.device_count()))
    return (base,)


def lane_mesh(n_devices: int | None = None, axis: str = LANE_AXIS,
              device=None) -> tuple[torch.device, ...]:
    """A cached 1-D mesh over the first ``n_devices`` placements (all of
    them by default), clamped to what there is.

    The shared mesh of every sharded user in the port: the PDES shards
    (:class:`ShardedSim`) and the DSE lane shards (``repro_torch.dse``
    ``shard=``).  One process holds one mesh per (device count, axis) and
    placement list.  ``device=None`` names the cards and raises without
    CUDA."""
    devs = placements(device)
    n = len(devs) if n_devices is None else max(1, min(int(n_devices),
                                                       len(devs)))
    key = (n, axis, devs[:n])
    m = _MESHES.get(key)
    if m is None:
        m = _MESHES[key] = devs[:n]
    return m


def device_groups(mesh, n_items: int) -> list[tuple[torch.device, int, int]]:
    """``n_items`` split evenly over the mesh slots in order, consecutive
    slots of one device merged: ``[(device, lo, hi), ...]``."""
    mesh = tuple(canonical_device(d) for d in mesh)
    if n_items % len(mesh):
        raise ValueError(f"{n_items} shards or lanes do not split evenly "
                         f"over a mesh of {len(mesh)} placements")
    per = n_items // len(mesh)
    groups: list[list] = []
    for i, dev in enumerate(mesh):
        if groups and groups[-1][0] == dev:
            groups[-1][2] += per
        else:
            groups.append([dev, i * per, (i + 1) * per])
    return [tuple(g) for g in groups]


def _gateway_tick(state, ports, t):
    # The gateway never ticks; the PDES wrapper moves its buffers directly.
    return state, ports, TickResult.make(torch.zeros((), dtype=torch.bool))


def add_gateway(builder: SimBuilder, n_peers: int, chan_per_peer: int,
                cap: int = 8) -> "object":
    """Add the cross-shard gateway kind to a shard-local topology.

    Port layout: ``port[p * 2*chan_per_peer + 2*c]`` is the *egress*
    channel c toward peer-shard-offset p (connect local senders to it),
    and ``...+ 2*c + 1`` is the matching *ingress* channel (connect it to
    local receivers).  Peer offset p means "shard (me + 1 + p) % D".
    """
    n_ports = n_peers * chan_per_peer * 2
    kind = ComponentKind(
        REMOTE_KIND, _gateway_tick, n_instances=1, n_ports=n_ports,
        init_state={"_": torch.zeros((1,), dtype=torch.int32)}, cap=cap,
        start_asleep=True)
    return builder.add_kind(kind)


class ShardedSim:
    """Runs a shard-local ``Simulation`` per shard, conservatively synced.

    ``build_fn() -> (SimBuilder, gateway_handle)`` must register the
    gateway via :func:`add_gateway`.  All shards share the topology;
    per-shard state is set by editing the stacked init state.  ``mesh``
    (default: one card) must split the ``n_shards`` evenly.
    """

    def __init__(self, build_fn, n_shards: int, n_peers: int,
                 chan_per_peer: int, mesh=None, axis: str = "sim",
                 lookahead: float = 8.0, mailbox: int = 8):
        if mesh is None:
            mesh = lane_mesh(1, axis)
        self.mesh = tuple(canonical_device(d) for d in mesh)
        self.groups = device_groups(self.mesh, n_shards)
        self.n_shards = n_shards
        self.n_peers, self.chan = n_peers, chan_per_peer
        self.lookahead = float(lookahead)
        self.mailbox = int(mailbox)
        self.axis = axis
        self._build_fn = build_fn
        self.sim = self._build(self.mesh[0])
        ki = [i for i, k in enumerate(self.sim.kinds)
              if k.name == REMOTE_KIND]
        assert ki, "topology must include the gateway (add_gateway)"
        self.gw_port_base = self.sim.port_base[ki[0]]
        assert self.sim.kinds[ki[0]].caps().max() <= self.mailbox, \
            "mailbox must cover gateway buffer capacity"
        self._consts: dict[torch.device, dict] = {}

    def _build(self, device):
        builder, _ = self._build_fn()
        # on the card a window of ceil(lookahead) event times (an integer
        # clock) is one block of that many epochs, so one read of ``more``;
        # on the CPU the engine's short default block wastes fewer epochs
        K = (max(1, math.ceil(self.lookahead))
             if resolve_device(device).type == "cuda" else None)
        return builder.build(device=device, super_epoch=K)

    # ------------------------------------------------------------------
    def init_state(self):
        """Stacked state ``[D, ...]`` for all shards (fresh tensors on the
        mesh's first device)."""
        s0 = self.sim.init_state()
        return tree_map(lambda a: torch.stack([a] * self.n_shards), s0)

    def shard_state(self, stacked):
        """The stacked state on the mesh's first device; :meth:`run`
        hands each placement its group of shards."""
        return tree_map(lambda a: a.to(self.mesh[0]), stacked)

    # ------------------------------------------------------------------
    def _local_next(self, s):
        """``[b]`` — each shard's next event time of a lane-batched
        state."""
        return torch.minimum(torch.amin(s.next_tick, dim=1),
                             torch.amin(s.conn_wake, dim=1))

    def _t_glob(self, blocks):
        """The reference's ``pmin`` of every shard's next event time: an
        f32 0-d tensor on the mesh's first device."""
        mins = [torch.amin(self._local_next(blk.state)).to(self.mesh[0])
                for blk in blocks]
        return mins[0] if len(mins) == 1 else torch.amin(torch.stack(mins))

    def _device_consts(self, sim):
        """The exchange's index tensors on ``sim``'s device, made once a
        run (the default peers may be patched after construction):
        gateway-local egress (2k) and ingress (2k+1) port ids, the ingress
        ports' peers, and which connection serves each ingress port."""
        npc = self.n_peers * self.chan
        eg = torch.arange(npc, device=sim.device) * 2
        ing_g = self.gw_port_base + eg + 1                  # global ids
        conns = sim.c["port_conn"][ing_g].long()
        return dict(eg=eg, ing=eg + 1, peer=sim.c["peer"][ing_g],
                    ar=torch.arange(self.mailbox, dtype=torch.int32,
                                    device=sim.device),
                    hit=conns[:, None] == torch.arange(sim.n_conn,
                                                       device=sim.device))

    def _drain(self, blk):
        """Drain a block's gateway egress in-buffers into its mailboxes
        ``[b, P, C, MB, W]`` (in place: the egress buffers are emptied)."""
        s, sim = blk.state, blk.sim
        k = self._consts[sim.device]
        mb, cap, eg, ar = self.mailbox, sim.cap_phys, k["eg"], k["ar"]
        ib = s.in_buf[REMOTE_KIND][:, eg]                   # [b, PC, CAP, W]
        heads = s.in_head[REMOTE_KIND][:, eg]
        cnts = s.in_cnt[REMOTE_KIND][:, eg]
        idx = (heads[:, :, None] + ar) % cap                # [b, PC, MB]
        msgs = torch.gather(ib, 2, idx.long()[..., None].expand(
            -1, -1, -1, MSG_WORDS))
        vmask = ar < cnts[:, :, None]
        msgs = torch.where(vmask[..., None], msgs, 0)
        s.in_cnt[REMOTE_KIND][:, eg] = 0
        s.in_head[REMOTE_KIND][:, eg] = 0
        return msgs.reshape(msgs.shape[0], self.n_peers, self.chan, mb,
                            MSG_WORDS)

    def _inject(self, blk, in_mail, t_end):
        """Inject a block's incoming mailboxes into its gateway ingress
        out-buffers and wake their serving connections (in place)."""
        s, sim = blk.state, blk.sim
        k = self._consts[sim.device]
        mb, cap, dev, ing = self.mailbox, sim.cap_phys, sim.device, k["ing"]
        b = in_mail.shape[0]
        flat = in_mail.reshape(b, -1, mb, MSG_WORDS)
        valid = flat[..., 0] != 0                           # opcode != 0
        n_new = torch.sum(valid, dim=2, dtype=torch.int32)
        # compact valid messages to the front of each channel (stable)
        order = torch.argsort((~valid).to(torch.int32), dim=2, stable=True)
        flat = torch.gather(flat, 2, order[..., None].expand(
            -1, -1, -1, MSG_WORDS))
        # rewrite dst to the ingress port's local peer; stamp ready time
        flat[..., W_DST] = k["peer"][None, :, None]
        flat[..., W_TIME] = f2i(t_end.to(dev))
        if cap > mb:
            flat = torch.cat([flat, torch.zeros(
                flat.shape[:2] + (cap - mb, MSG_WORDS), dtype=torch.int32,
                device=dev)], dim=2)
        s.out_buf[REMOTE_KIND][:, ing] = flat[:, :, :cap]
        s.out_head[REMOTE_KIND][:, ing] = 0
        s.out_cnt[REMOTE_KIND][:, ing] = torch.clamp(n_new, max=cap)
        # wake the serving connections so the crossbar forwards them; the
        # reference's scatter-min drops channels with nothing new
        wake = _align_after(t_end.to(dev), 1.0)
        cand = torch.where((n_new > 0)[:, :, None] & k["hit"], wake, INF)
        s.conn_wake.copy_(torch.minimum(s.conn_wake,
                                        torch.amin(cand, dim=1)))

    def _exchange(self, blocks, t_end):
        """Drain gateway egress → rotate by peer offset over the shard
        axis → inject gateway ingress, for every block's shards."""
        out = [self._drain(blk).to(self.mesh[0]) for blk in blocks]
        out_mail = out[0] if len(out) == 1 else torch.cat(out)
        # peer offset p on shard i targets shard (i+1+p) % D: shard j
        # receives offset p's slab from shard (j-1-p) % D
        in_mail = torch.stack([torch.roll(out_mail[:, p], 1 + p, dims=0)
                               for p in range(self.n_peers)], dim=1)
        for blk, (_, lo, hi) in zip(blocks, self.groups):
            self._inject(blk, in_mail[lo:hi].to(blk.sim.device), t_end)

    def _step_window(self, blocks, t_glob, horizon):
        """One conservative window: run to ``t_end - 2*EPS``, stamp time,
        exchange."""
        t_end = torch.minimum(t_glob + self.lookahead, horizon)
        u = t_end - 2 * EPS
        for blk in blocks:
            blk.until.copy_(u.to(blk.sim.device).expand(blk.b))
            while True:
                blk.step()
                if not bool(blk.more):
                    break
            blk.state.time.copy_(torch.maximum(
                blk.state.time, t_end.to(blk.sim.device)))
        self._exchange(blocks, t_end)

    def _blocks(self, stacked):
        """A lane-batched block per group loaded with its shards: the
        simulation's cached block of that shape (on the card a graph
        captured once), private where a device holds two groups."""
        blocks, self._consts = [], {}
        for dev, lo, hi in self.groups:
            sim = self.sim.on_device(dev)
            st = tree_map(lambda a: a[lo:hi].to(dev), stacked)
            pb = tree_map(lambda a: torch.stack([a] * (hi - lo)),
                          sim.default_params())
            if sim.device in self._consts:
                blk = LaneBlock(sim, st, pb)
            else:
                blk, _ = sim.lane_block(st, pb)
                self._consts[sim.device] = self._device_consts(sim)
            n = hi - lo
            blk.load(st, pb, np.zeros(n, np.float32),
                     np.full(n, WINDOW_MAX_EPOCHS, np.int32))
            blocks.append(blk)
        return blocks

    def run(self, stacked_state, until: float, max_windows: int = 10_000,
            return_windows: bool = False):
        """Advance all shards to virtual time ``until``; with
        ``return_windows`` also the number of windows run (on any mesh)."""
        blocks = self._blocks(stacked_state)
        dev0 = self.mesh[0]
        horizon = torch.full((), until, dtype=torch.float32, device=dev0)
        # the reference compares with ``until + EPS`` cast to f32
        last = torch.full((), until + EPS, dtype=torch.float32, device=dev0)
        w = 0
        while w < max_windows:
            t_glob = self._t_glob(blocks)
            if not bool(t_glob <= last):
                break
            self._step_window(blocks, t_glob, horizon)
            w += 1
        parts = [blk.sim.copy_state(blk.state) for blk in blocks]
        out = parts[0] if len(parts) == 1 else tree_map(
            lambda *xs: torch.cat([x.to(dev0) for x in xs]), *parts)
        return (out, w) if return_windows else out

    def lower(self, until: float = 1024.0) -> dict:
        """Plan :meth:`run` for the dry run; runs nothing.  The
        reference's AOT lowering, read as its dry run reads it:
        ``argument_bytes`` is one shard's share of the stacked state, and
        ``collectives`` the exchange's ``(op, result bytes a shard, group,
        times)`` each window -- the ``pmin`` of the loop's test and of the
        window an all-reduce of one f32 each, and each peer offset's
        mailbox slab ``[C, MB, W]`` int32 a collective-permute.  ``until``
        bounds the run, not a window, so it changes neither."""
        st = self.init_state()
        nbytes = sum(t.numel() * t.element_size() for t in tree_leaves(st))
        D = self.n_shards
        slab = self.chan * self.mailbox * MSG_WORDS * 4
        return {"argument_bytes": nbytes // D,
                "collectives": [("all-reduce", 4, D, 2),
                                ("collective-permute", slab, D,
                                 self.n_peers)]}
