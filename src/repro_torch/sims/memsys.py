"""GPU-like multi-core memory-system simulator — the Smart-Ticking
evaluation vehicle (paper §4 runs MGPUSim; we build the equivalent
cores + private L1 + shared-DRAM-over-crossbar system on the engine).
Counterpart of ``repro.sims.memsys``, with its sharded-PDES variant
(``build_sharded_memsys`` on ``repro_torch.core.pdes``).

Workload patterns mirror the paper's benchmark behaviours:
  * ``compute``  — long think times, cores mostly busy (FIR/AES-like);
  * ``stream``   — back-to-back sequential misses, memory-bound (S2D-like);
  * ``pointer``  — serialized dependent misses (MLP=1);
  * ``idle_half``— half the cores have no work (ATAX's "limited
    parallelism", where Smart Ticking shines);
  * ``mixed``    — a blend.

Opcodes: 1=READ_REQ, 2=READ_RESP, 3=WRITE_REQ (fire-and-forget).
Payload: p0=address, p1=requester tag.

Sweepable model params (see DSE.md): the ``core`` kind exposes
``think_scale`` (multiplier on per-core think times) and the ``l1`` kind
``extra_hit_rate`` (probability of a forced hit on top of the real tag
match — a stand-in for a bigger/smarter cache).  Both default to values
that reproduce the unparameterized model bit-for-bit (1.0 / 0.0); DRAM
service latency sweeps ride the crossbar connection latency and the
``dram`` kind's tick period.

The workload comes from ``np.random.default_rng(seed)`` in the same order
as the reference, so the initial states of the two packages are equal.
Every builder runs on the card unless given ``device="cpu"``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import (ComponentKind, SimBuilder, TickResult, msg_new,
                              msg_reply, oh_set, opcode, payload)
from repro_torch.core.engine import tree_map

READ_REQ, READ_RESP, WRITE_REQ = 1, 2, 3

CORE_PARAMS = {"think_scale": torch.tensor(1.0, dtype=torch.float32)}
L1_PARAMS = {"extra_hit_rate": torch.tensor(0.0, dtype=torch.float32)}

_i32 = torch.int32


# ---------------------------------------------------------------------------
def core_tick(state, ports, t, params):
    """Issues reads with think-time compute phases; up to 1 outstanding."""
    progress = torch.zeros((), dtype=torch.bool)
    # accept response
    msg, got, ports = ports.recv(0)
    state = dict(state)
    state["outstanding"] = state["outstanding"] - got.to(_i32)
    progress = progress | got
    computing = t + 1e-3 < state["next_issue"]
    can_issue = ((state["remaining"] > 0) & (state["outstanding"] < 1)
                 & ~computing)
    # LCG address stream (int32 arithmetic wraps as in the reference)
    addr = (state["addr"] * 1103515245 + 12345) & 0x7FFFFFFF
    addr_use = torch.where(state["seq"] > 0,
                           state["addr"] + 64, addr)  # sequential vs random
    ports, sent = ports.send(
        0, msg_new(READ_REQ, p0=addr_use, p1=state["tag"]), when=can_issue)
    si = sent.to(_i32)
    state["addr"] = torch.where(sent, addr_use, state["addr"])
    state["remaining"] = state["remaining"] - si
    state["outstanding"] = state["outstanding"] + si
    think = state["think"].to(torch.float32) * params["think_scale"]
    state["next_issue"] = torch.where(sent, t + think, state["next_issue"])
    progress = progress | sent
    # while computing, fast-forward to the next issue time (event-driven)
    nxt = torch.where(computing & (state["remaining"] > 0)
                      & (state["outstanding"] < 1),
                      state["next_issue"], -1.0)
    return state, ports, TickResult.make(progress, next_time=nxt)


def l1_tick(state, ports, t, params):
    """Direct-mapped L1; 1 MSHR; port 0 = core side, port 1 = memory side."""
    state = dict(state)
    progress = torch.zeros((), dtype=torch.bool)
    n_sets = state["tags"].shape[0]

    # 1) fill response from memory
    rmsg, rgot, ports = ports.recv(1, when=ports.can_send(0))
    addr_r = payload(rmsg, 0)
    set_r = (addr_r // 64) % n_sets
    state["tags"] = oh_set(state["tags"], set_r, addr_r // 64, when=rgot)
    # reply to the core (port 0's paired peer), NOT to the fill's sender
    ports, _ = ports.send(0, msg_new(READ_RESP, p0=addr_r,
                                     p1=payload(rmsg, 1)), when=rgot)
    state["mshr_busy"] = torch.where(rgot, 0, state["mshr_busy"])
    progress = progress | rgot

    # 2) new request from the core (only if we could respond / forward)
    can_hit_path = ports.can_send(0)
    can_miss_path = (state["mshr_busy"] == 0) & ports.can_send(1)
    msg, got = ports.peek(0)
    addr = payload(msg, 0)
    set_i = (addr // 64) % n_sets
    # forced probabilistic hit (address-hashed, deterministic): models a
    # larger/associative cache without simulating one; rate 0 == pure tags
    hmix = (addr * 1103515245 + 12345) & 0x7FFFFFFF
    forced = hmix.to(torch.float32) < \
        params["extra_hit_rate"] * 2147483648.0
    hit = (state["tags"][set_i] == addr // 64) | forced
    accept = got & torch.where(hit, can_hit_path, can_miss_path)
    _, _, ports = ports.recv(0, when=accept)
    ports, _ = ports.send(0, msg_reply(msg, READ_RESP, p0=addr,
                                       p1=payload(msg, 1)),
                          when=accept & hit)
    ports, fwd = ports.send(1, msg_new(READ_REQ, p0=addr, p1=payload(msg, 1)),
                            when=accept & ~hit)
    state["mshr_busy"] = torch.where(fwd, 1, state["mshr_busy"])
    state["hits"] = state["hits"] + (accept & hit).to(_i32)
    state["misses"] = state["misses"] + fwd.to(_i32)
    progress = progress | accept
    return state, ports, TickResult.make(progress)


def dram_tick(state, ports, t):
    """One request per cycle; replies ride the connection latency."""
    state = dict(state)
    msg, got, ports = ports.recv(0, when=ports.can_send(0))
    op = opcode(msg)
    is_read = got & (op == READ_REQ)
    ports, _ = ports.send(0, msg_reply(msg, READ_RESP, p0=payload(msg, 0),
                                       p1=payload(msg, 1)), when=is_read)
    state["served"] = state["served"] + got.to(_i32)
    return state, ports, TickResult.make(got)


# ---------------------------------------------------------------------------
def _workload(pattern: str, n_cores: int, n_reqs: int, rng):
    think = np.zeros(n_cores, np.int32)
    seq = np.zeros(n_cores, np.int32)
    remaining = np.full(n_cores, n_reqs, np.int32)
    if pattern == "compute":
        think[:] = 24
    elif pattern == "stream":
        seq[:] = 1
        think[:] = 0
    elif pattern == "pointer":
        think[:] = 2
    elif pattern == "idle_half":
        remaining[n_cores // 2:] = 0
        think[:] = 4
    elif pattern == "mixed":
        think[:] = rng.integers(0, 16, n_cores)
        seq[:] = rng.integers(0, 2, n_cores)
    else:
        raise ValueError(pattern)
    return remaining, think, seq


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def build_memsys(n_cores: int = 8, pattern: str = "mixed",
                 n_reqs: int = 64, dram_latency: float = 30.0,
                 naive: bool = False, seed: int = 0,
                 sample_period: float = 0.0, private_dram: bool = False,
                 super_epoch: int | None = None, donate: bool = True,
                 dram_period: float = 1.0, device=None,
                 cuda_graph: bool = True):
    rng = np.random.default_rng(seed)
    remaining, think, seq = _workload(pattern, n_cores, n_reqs, rng)
    b = SimBuilder()
    cores = b.add_kind(ComponentKind(
        "core", core_tick, n_cores, 1,
        {"remaining": _t(remaining),
         "outstanding": torch.zeros(n_cores, dtype=_i32),
         "addr": _t(rng.integers(0, 1 << 20, n_cores).astype(np.int32)),
         "seq": _t(seq),
         "think": _t(think),
         "tag": torch.arange(n_cores, dtype=_i32),
         "next_issue": torch.zeros(n_cores, dtype=torch.float32)}, cap=2,
        params=CORE_PARAMS))
    n_sets = 64
    l1 = b.add_kind(ComponentKind(
        "l1", l1_tick, n_cores, 2,
        {"tags": torch.full((n_cores, n_sets), -1, dtype=_i32),
         "mshr_busy": torch.zeros(n_cores, dtype=_i32),
         "hits": torch.zeros(n_cores, dtype=_i32),
         "misses": torch.zeros(n_cores, dtype=_i32)}, cap=2,
        params=L1_PARAMS))
    n_dram = n_cores if private_dram else 1
    # dram_period is the service interval (one request per tick): the
    # static default of the sweepable ``period.dram`` axis
    dram = b.add_kind(ComponentKind(
        "dram", dram_tick, n_dram, 1,
        {"served": torch.zeros(n_dram, dtype=_i32)}, cap=4,
        period=dram_period))
    for i in range(n_cores):
        b.connect([cores.port(i, 0), l1.port(i, 0)], latency=1.0)
    if private_dram:
        # independent tiles (no shared-resource contention): the lane-
        # scaling measurement for transparent parallelism (Fig 10 analogue)
        for i in range(n_cores):
            b.connect([l1.port(i, 1), dram.port(i, 0)],
                      latency=dram_latency)
    else:
        # shared crossbar: every L1's memory port + the DRAM port on ONE
        # connection (Akita's multi-port round-robin crossbar)
        b.connect([l1.port(i, 1) for i in range(n_cores)]
                  + [dram.port(0, 0)], latency=dram_latency)
    sim = b.build(naive=naive, sample_period=sample_period,
                  super_epoch=super_epoch, donate=donate, device=device,
                  cuda_graph=cuda_graph)
    st = sim.init_state()
    return sim, st


def finish_stats(sim, st):
    cs = st.comp_state
    total = lambda a: int(torch.sum(a, dtype=torch.int64))
    return {
        "virtual_time": float(st.time),
        "epochs": int(st.stats.epochs),
        "ticks": int(st.stats.ticks),
        "delivered": int(st.stats.delivered),
        "reads_done": total(cs["dram"]["served"]),
        "hits": total(cs["l1"]["hits"]),
        "misses": total(cs["l1"]["misses"]),
        "remaining": total(cs["core"]["remaining"]),
        "outstanding": total(cs["core"]["outstanding"]),
    }


# ---------------------------------------------------------------------------
# topology family: one padded build sweeping n_cores by activity mask
# ---------------------------------------------------------------------------
def build_family(shape=None, n_cores: int = 8, pattern: str = "mixed",
                 n_reqs: int = 64, dram_latency: float = 30.0, seed: int = 0,
                 super_epoch: int | None = None, donate: bool = True,
                 dram_period: float = 1.0, naive: bool = False, device=None):
    """The memsys topology *family* with up to ``n_cores`` cores.

    Built once at the family maximum (``pad_shape`` sizes the core/L1
    segments; the crossbar wires every potential L1 port plus the shared
    DRAM), it simulates any ``core`` count 1..n_cores via
    ``SimParams`` activity masks (DSE.md "Topology families").

    Contractual detail that makes masked runs bit-identical to unpadded
    builds: active crossbar members occupy the leading member slots in
    instance order with the fixed DRAM port last, so round-robin
    arbitration sees the same relative slot order at every shape; and
    ``state_fn`` reseeds the workload RNG per shape, so active rows of
    the padded initial state equal ``build(n_cores=shape)`` exactly.

    Returns a :class:`repro_torch.dse.TopologyFamily` with shape axis
    ``core``.
    """
    from repro_torch.dse.family import TopologyFamily

    if shape:
        # size the padding to the sweep's family maximum
        n_cores = int(shape.get("core", n_cores))
    n_max, n_sets = int(n_cores), 64
    b = SimBuilder()
    # kinds are declared as single-row templates; pad_shape sizes every
    # segment to the family maximum (zero rows — state_fn supplies the
    # per-shape workload, so the templates never reach a run)
    core = b.add_kind(ComponentKind(
        "core", core_tick, 1, 1,
        {"remaining": torch.zeros(1, dtype=_i32),
         "outstanding": torch.zeros(1, dtype=_i32),
         "addr": torch.zeros(1, dtype=_i32),
         "seq": torch.zeros(1, dtype=_i32),
         "think": torch.zeros(1, dtype=_i32),
         "tag": torch.zeros(1, dtype=_i32),
         "next_issue": torch.zeros(1, dtype=torch.float32)}, cap=2,
        params=CORE_PARAMS))
    l1 = b.add_kind(ComponentKind(
        "l1", l1_tick, 1, 2,
        {"tags": torch.full((1, n_sets), -1, dtype=_i32),
         "mshr_busy": torch.zeros(1, dtype=_i32),
         "hits": torch.zeros(1, dtype=_i32),
         "misses": torch.zeros(1, dtype=_i32)}, cap=2,
        params=L1_PARAMS))
    dram = b.add_kind(ComponentKind(
        "dram", dram_tick, 1, 1,
        {"served": torch.zeros(1, dtype=_i32)}, cap=4, period=dram_period))
    for i in range(n_max):
        b.connect([core.port(i, 0), l1.port(i, 0)], latency=1.0)
    b.connect([l1.port(i, 1) for i in range(n_max)] + [dram.port(0, 0)],
              latency=dram_latency)
    sim = b.build(naive=naive, super_epoch=super_epoch, donate=donate,
                  pad_shape={"core": n_max, "l1": n_max}, device=device)
    dram_pid = sim.port_id("dram", 0, 0)
    sim.set_default_peers(
        {sim.port_id("l1", i, 1): dram_pid for i in range(n_max)})

    def state_fn(shape):
        n = int(shape["core"])
        # replay build()'s exact RNG sequence at this shape so active rows
        # of the padded state are bit-identical to an unpadded build
        rng = np.random.default_rng(seed)
        remaining, think, seq = _workload(pattern, n, n_reqs, rng)
        addr = rng.integers(0, 1 << 20, n).astype(np.int32)

        def pad(a):
            a = np.asarray(a)
            return np.concatenate(
                [a, np.zeros((n_max - n,) + a.shape[1:], a.dtype)])

        st = sim.init_state()
        cs = dict(st.comp_state)
        cs["core"] = {
            "remaining": pad(remaining),
            "outstanding": np.zeros(n_max, np.int32),
            "addr": pad(addr), "seq": pad(seq), "think": pad(think),
            "tag": np.arange(n_max, dtype=np.int32),
            "next_issue": np.zeros(n_max, np.float32)}
        cs["l1"] = {
            "tags": np.full((n_max, n_sets), -1, np.int32),
            "mshr_busy": np.zeros(n_max, np.int32),
            "hits": np.zeros(n_max, np.int32),
            "misses": np.zeros(n_max, np.int32)}
        cs["dram"] = {"served": np.zeros(1, np.int32)}
        return dataclasses.replace(
            st, comp_state=tree_map(lambda a: _t(a).to(sim.device), cs))

    return TopologyFamily(
        sim=sim, shape_max={"core": n_max},
        kind_counts=lambda s: {"core": s["core"], "l1": s["core"]},
        state_fn=state_fn)


# ---------------------------------------------------------------------------
# multi-member crossbar needs explicit dst: patch core/l1 states with gids
# ---------------------------------------------------------------------------
def _patch_dsts(sim, st, n_cores):
    dram_pid = sim.port_id("dram", 0, 0)
    # l1 memory-side sends go to the DRAM port; l1 replies use msg src. The
    # l1 tick uses msg_new for forwards (default peer = -1 on the crossbar),
    # so rewrite: default dst for the l1 mem port = dram port id.
    sim.set_default_peers(
        {sim.port_id("l1", i, 1): dram_pid for i in range(n_cores)})
    return sim, st


def build(n_cores=8, pattern="mixed", n_reqs=64, naive=False, seed=0,
          dram_latency=30.0, sample_period=0.0, private_dram=False,
          super_epoch=None, donate=True, dram_period=1.0, device=None,
          cuda_graph=True):
    sim, st = build_memsys(n_cores, pattern, n_reqs, dram_latency, naive,
                           seed, sample_period, private_dram,
                           super_epoch=super_epoch, donate=donate,
                           dram_period=dram_period, device=device,
                           cuda_graph=cuda_graph)
    if private_dram:
        return sim, st          # 1:1 links use default peers
    return _patch_dsts(sim, st, n_cores)


# ---------------------------------------------------------------------------
# sharded-PDES variant (engine-as-workload)
# ---------------------------------------------------------------------------
def remote_writer_tick(state, ports, t):
    want = state["remaining"] > 0
    ports, sent = ports.send(0, msg_new(WRITE_REQ, p0=state["addr"]),
                             when=want)
    state = dict(state)
    state["remaining"] = state["remaining"] - sent.to(_i32)
    state["addr"] = state["addr"] + 64
    return state, ports, TickResult.make(sent)


def build_sharded_memsys(mesh=None, n_shards: int = 1,
                         tiles_per_shard: int = 4, n_reqs: int = 32,
                         lookahead: float = 8.0):
    """Each shard: a memsys tile + a writer streaming to the right-neighbor
    shard's DRAM through the PDES gateway (ring topology, 1 peer).
    ``mesh`` (``core.pdes.lane_mesh``; default one card) places the
    shards."""
    from repro_torch.core.pdes import ShardedSim, add_gateway

    # NB: the gateway ingress cannot share the DRAM's crossbar port (Akita:
    # one connection per port), so the DRAM gets a second port for remote
    # traffic.
    def build_fn():
        n_cores = tiles_per_shard
        b = SimBuilder()
        rng = np.random.default_rng(0)
        remaining, think, seq = _workload("mixed", n_cores, n_reqs, rng)
        cores = b.add_kind(ComponentKind(
            "core", core_tick, n_cores, 1,
            {"remaining": _t(remaining),
             "outstanding": torch.zeros(n_cores, dtype=_i32),
             "addr": _t(rng.integers(0, 1 << 20, n_cores)
                        .astype(np.int32)),
             "seq": _t(seq), "think": _t(think),
             "tag": torch.arange(n_cores, dtype=_i32),
             "next_issue": torch.zeros(n_cores, dtype=torch.float32)},
            cap=2, params=CORE_PARAMS))
        l1 = b.add_kind(ComponentKind(
            "l1", l1_tick, n_cores, 2,
            {"tags": torch.full((n_cores, 64), -1, dtype=_i32),
             "mshr_busy": torch.zeros(n_cores, dtype=_i32),
             "hits": torch.zeros(n_cores, dtype=_i32),
             "misses": torch.zeros(n_cores, dtype=_i32)}, cap=2,
            params=L1_PARAMS))
        dram = b.add_kind(ComponentKind(
            "dram", dram_tick, 1, 2, {"served": torch.zeros(1, dtype=_i32)},
            cap=8))
        writer = b.add_kind(ComponentKind(
            "writer", remote_writer_tick, 1, 1,
            {"remaining": torch.full((1,), n_reqs, dtype=_i32),
             "addr": torch.zeros(1, dtype=_i32)}, cap=2))
        gw = add_gateway(b, n_peers=1, chan_per_peer=1, cap=8)
        for i in range(n_cores):
            b.connect([cores.port(i, 0), l1.port(i, 0)], latency=1.0)
        b.connect([l1.port(i, 1) for i in range(n_cores)]
                  + [dram.port(0, 0)], latency=16.0)
        b.connect([writer.port(0, 0), gw.port(0, 0)], latency=1.0)
        b.connect([gw.port(0, 1), dram.port(0, 1)], latency=1.0)
        return b, gw

    ss = ShardedSim(build_fn, n_shards=n_shards, n_peers=1,
                    chan_per_peer=1, mesh=mesh, lookahead=lookahead,
                    mailbox=8)
    # the l1 crossbar needs explicit DRAM addressing (multi-member conn)
    dram_pid = ss.sim.port_id("dram", 0, 0)
    ss.sim.set_default_peers(
        {ss.sim.port_id("l1", i, 1): dram_pid
         for i in range(tiles_per_shard)})
    return ss
