"""TrioSim: trace-driven multi-GPU DNN-training simulator (paper §5.2).
Counterpart of ``repro.sims.triosim``; it reproduces that simulator's
results bit for bit.

Purely event-driven on the Akita engine: each operator becomes ONE event
(compute ops fast-forward with ``next_time``; the paper: "condenses each
kernel/operator into a single event and fast-forwards without simulating
microarchitectural details").  Data movement uses a flow-based network
component (cf. Narses [17]) instead of cycle-level ports — the paper's
"alternative implementation of ports and connections".

Virtual time unit: 1 µs.  Time is f32, as in the reference, so a step
longer than 2^24 µs (16.8 s) cannot advance by 1 µs any more and cannot be
simulated faithfully.

The reference's ``.at[ix]`` updates of the per-tag tables are one-hot
selects here (:func:`_at`: negative indices count from the end, indices
out of range drop), and its reads go through
:func:`~repro_torch.core.ports.take` (clamped), so an index read from an
empty buffer slot can never fault on the card.  The network kind has one
port per GPU on a single instance (up to 30: members are int32 bitmaps).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import (ComponentKind, SimBuilder, TickResult, msg_new,
                              payload, take)
from repro_torch.core.message import const

from .opgraph import COLL, COMPUTE, DONE, HW, P2P_RECV, P2P_SEND

REQ_COLL, REQ_P2P, DATA = 10, 11, 12

_i32, _f32 = torch.int32, torch.float32

# Epochs in a captured block on the card.  A TrioSim epoch launches 2,489
# kernels at 16 GPUs (the network's tick loops over its ports; H100,
# chip_smoke.py phase 8), four times memsys's, and a step takes tens to
# hundreds of epochs, so a block of the engine's default 64 costs more to
# capture than the whole step takes to replay.  The block length does not
# change results.
CUDA_SUPER_EPOCH = 16


def _at(arr, ix):
    """One-hot mask of row ``ix`` of a 1-D table, with the reference's
    scatter index semantics (negative counts from the end; out of range
    matches no row, so the update is dropped)."""
    n = arr.shape[0]
    ix = torch.where(ix < 0, ix + n, ix)
    return torch.arange(n, device=arr.device) == ix


def gpu_tick(state, ports, t):
    state = dict(state)
    progress = torch.zeros((), dtype=torch.bool)
    msg, got, ports = ports.recv(0)
    tag_in = payload(msg, 1)
    state["got"] = torch.where(got & _at(state["got"], tag_in), 1,
                               state["got"])
    progress = progress | got

    idx = state["idx"]
    op = take(state["ops"], idx)               # [4]
    kind, size, tag, peer = op[0], op[1], op[2], op[3]
    infl = state["in_flight"] > 0

    # COMPUTE: schedule completion, then retire
    start_c = (kind == COMPUTE) & ~infl
    fin_c = (kind == COMPUTE) & infl & (t + 1e-3 >= state["busy_until"])
    state["busy_until"] = torch.where(start_c, t + size.to(_f32),
                                      state["busy_until"])
    # COLL: request once, wait for completion tag
    start_k = (kind == COLL) & ~infl & ports.can_send(0)
    ports, sent_k = ports.send(
        0, msg_new(REQ_COLL, p0=size, p1=tag, p2=peer), when=start_k)
    fin_k = (kind == COLL) & infl & (take(state["got"], tag) > 0)
    # P2P
    can_s = (kind == P2P_SEND) & ports.can_send(0)
    ports, sent_p = ports.send(
        0, msg_new(REQ_P2P, p0=size, p1=tag, p2=peer), when=can_s)
    fin_r = (kind == P2P_RECV) & (take(state["got"], tag) > 0)
    # DONE
    fin_d = (kind == DONE) & (state["done"] == 0)
    state["done"] = torch.where(fin_d, 1, state["done"])
    state["done_time"] = torch.where(fin_d, t, state["done_time"])

    retire = fin_c | fin_k | sent_p | fin_r
    state["idx"] = torch.clamp(state["idx"] + retire.to(_i32), 0,
                               state["ops"].shape[0] - 1)
    state["in_flight"] = torch.where(
        retire | fin_d, 0,
        torch.where(start_c | sent_k, 1, state["in_flight"]))
    progress = progress | retire | start_c | sent_k | fin_d
    nxt = torch.where(start_c, state["busy_until"], -1.0)
    nxt = torch.where(retire, t + 1.0, nxt)    # look at the next op
    return state, ports, TickResult.make(progress, next_time=nxt)


def make_network_tick(n_gpus: int, hw: HW):
    inv_bw_us_per_kb = 1024.0 / hw.link_bw * 1e6

    def network_tick(state, ports, t):
        state = dict(state)
        progress = torch.zeros((), dtype=torch.bool)
        for p in range(n_gpus):
            msg, got, ports = ports.recv(p)
            kb = payload(msg, 0).to(_f32)
            tag = payload(msg, 1)
            grp = payload(msg, 2)
            is_coll = got & (msg[0] == REQ_COLL)
            is_p2p = got & (msg[0] == REQ_P2P)
            progress = progress | got
            hot = _at(state["cnt"], tag)
            # collective bookkeeping
            cnt = state["cnt"] + torch.where(hot, is_coll.to(_i32), 0)
            state["cnt"] = torch.where(got, cnt, state["cnt"])
            state["members"] = torch.where(
                is_coll & hot, state["members"] + const(1 << p, _i32),
                state["members"])
            full = is_coll & (take(state["cnt"], tag) >= grp)
            dur = 2.0 * (grp - 1).to(_f32) / \
                torch.maximum(grp, const(1, _i32)).to(_f32) * kb * \
                inv_bw_us_per_kb + hw.coll_alpha_us
            state["done_t"] = torch.where(full & hot, t + dur,
                                          state["done_t"])
            # p2p: serialize per destination channel (flow model)
            dstp = torch.clamp(grp, 0, n_gpus - 1)
            arr = torch.maximum(t, take(state["chan_free"], dstp)) + \
                kb * inv_bw_us_per_kb + hw.coll_alpha_us
            state["chan_free"] = torch.where(
                is_p2p & _at(state["chan_free"], dstp), arr,
                state["chan_free"])
            state["done_t"] = torch.where(is_p2p & hot, arr,
                                          state["done_t"])
            state["members"] = torch.where(
                is_p2p & hot, torch.bitwise_left_shift(const(1, _i32), dstp),
                state["members"])
        # deliver due completions, one per port per tick
        for p in range(n_gpus):
            bit = const(1 << p, _i32)
            due = ((state["done_t"] <= t + 1e-3)
                   & ((state["members"] & bit) > 0)
                   & ((state["sent"] & bit) == 0))
            tagp = torch.argmin(
                torch.where(due, state["done_t"], float("inf"))).to(_i32)
            have = torch.any(due)
            ports, sent = ports.send(p, msg_new(DATA, p1=tagp), when=have)
            state["sent"] = torch.where(
                sent & _at(state["sent"], tagp), state["sent"] + bit,
                state["sent"])
            progress = progress | sent
        # sleep until the next completion still owed to someone
        owed = (state["done_t"] < float("inf")) & \
            (state["sent"] != state["members"])
        nxt_t = torch.amin(torch.where(
            owed, torch.maximum(state["done_t"], t + 1.0), float("inf")))
        nxt = torch.where(torch.isfinite(nxt_t), nxt_t, -1.0)
        return state, ports, TickResult.make(progress, next_time=nxt)

    return network_tick


def build_triosim(ops: np.ndarray, n_tags: int, hw: HW = HW(), device=None):
    """ops: [n_dev, MAX, 4] from opgraph.build_train_trace."""
    n_dev = ops.shape[0]
    assert n_dev <= 30, "bitmap member encoding limit"
    mt = max(n_tags + 1, 2)
    z = lambda *s: torch.zeros(s, dtype=_i32)
    b = SimBuilder()
    gpus = b.add_kind(ComponentKind(
        "gpu", gpu_tick, n_dev, 1,
        {"ops": torch.from_numpy(np.ascontiguousarray(ops, np.int32)),
         "idx": z(n_dev), "in_flight": z(n_dev),
         "busy_until": torch.zeros(n_dev, dtype=_f32),
         "done": z(n_dev),
         "done_time": torch.zeros(n_dev, dtype=_f32),
         "got": z(n_dev, mt)}, cap=4))
    net = b.add_kind(ComponentKind(
        "net", make_network_tick(n_dev, hw), 1, n_dev,
        {"cnt": z(1, mt), "members": z(1, mt), "sent": z(1, mt),
         "done_t": torch.full((1, mt), float("inf"), dtype=_f32),
         "chan_free": torch.zeros((1, n_dev), dtype=_f32)}, cap=4))
    for g in range(n_dev):
        b.connect([gpus.port(g, 0), net.port(0, g)], latency=1.0)
    dev = resolve_device(device)
    sim = b.build(device=dev, super_epoch=(CUDA_SUPER_EPOCH
                                           if dev.type == "cuda" else None))
    return sim, sim.init_state()


def simulate_step(cfg, batch, seq, dp=1, tp=1, pp=1, micro=4, hw=HW(),
                  until=5e6, device=None, return_state=False):
    """One training step of ``cfg`` under the dp × tp × pp plan.  With
    ``return_state`` the result also holds the simulation's final state
    (``"state"``) and the simulation (``"sim"``)."""
    from .opgraph import build_train_trace
    ops, n_tags = build_train_trace(cfg, batch, seq, dp, tp, pp, micro, hw)
    sim, st = build_triosim(ops, n_tags, hw, device=device)
    out = sim.run(st, until=until, max_epochs=500_000)
    cs = out.comp_state["gpu"]
    done = bool(torch.all(cs["done"] == 1))
    step_us = float(torch.amax(cs["done_time"]))
    res = {"done": done, "step_us": step_us,
           "epochs": int(out.stats.epochs)}
    if return_state:
        res.update(state=out, sim=sim)
    return res
