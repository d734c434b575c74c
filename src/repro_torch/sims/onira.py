"""Onira: an in-order RISC-V-style timing model on the engine (paper §5.1).
Counterpart of ``repro.sims.onira``; it reproduces that model's results bit
for bit.

Five-stage-pipeline timing semantics (single issue, full forwarding,
1-cycle load-use stall via a register scoreboard, 2-cycle taken-branch
flush, non-blocking loads with a 4-entry load queue, one outstanding
store), attached to a memory component over a latency-L connection — the
paper's "single core, 5-cycle memory latency" setup.

The ISA is a micro-subset sufficient for the paper's microbenchmarks:
  ADDI rd, rs1, imm   (op=1)      LOAD rd, [rs1]     (op=2)
  STORE [rs1], rd     (op=3)      BNEZ rs1, +imm     (op=4; taken if !=0)
  HALT                (op=5)
Accuracy is validated against closed-form pipeline CPI (the reference's
stand-in for the paper's Verilator RTL).

Register reads index with :func:`~repro_torch.core.ports.take`, which
clamps as the reference's gathers do; every builder runs on the card
unless given ``device="cpu"``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import (ComponentKind, SimBuilder, TickResult, msg_new,
                              msg_reply, oh_set, payload, take)
from repro_torch.core.engine import tree_map

ADDI, LOAD, STORE, BNEZ, HALT = 1, 2, 3, 4, 5
MAXI = 128

# Sweepable CPU timing params (traced; DSE.md): the taken-branch flush
# penalty in cycles.  Memory latency sweeps ride the cpu<->mem connection
# latency axis.  Defaults reproduce the unparameterized model bit-for-bit.
CPU_PARAMS = {"flush_cycles": torch.tensor(3.0, dtype=torch.float32)}

_i32, _f32 = torch.int32, torch.float32


def cpu_tick(state, ports, t, params):
    state = dict(state)
    progress = torch.zeros((), dtype=torch.bool)
    # load response: p1 = destination register
    msg, got, ports = ports.recv(0)
    reg = payload(msg, 1)
    state["busy"] = oh_set(state["busy"], reg, 0, when=got)
    state["pending"] = state["pending"] - got.to(_i32)
    progress = progress | got

    halted = state["done"] > 0
    flushing = t + 1e-3 < state["stall_until"]
    pc = torch.clamp(state["pc"], 0, MAXI - 1)
    inst = state["prog"][pc]                       # [4]
    op, rd, rs1, imm = inst[0], inst[1], inst[2], inst[3]
    can_issue = ~halted & ~flushing

    src_busy = take(state["busy"], rs1) > 0
    dst_busy = take(state["busy"], rd) > 0         # stores read rd as data

    # ALU
    do_alu = can_issue & (op == ADDI) & ~src_busy
    state["regs"] = oh_set(state["regs"], rd, take(state["regs"], rs1) + imm,
                           when=do_alu)
    # LOAD
    can_load = can_issue & (op == LOAD) & ~src_busy & \
        (state["pending"] < 4) & ports.can_send(0)
    ports, sent_l = ports.send(
        0, msg_new(1, p0=take(state["regs"], rs1), p1=rd), when=can_load)
    state["busy"] = oh_set(state["busy"], rd, 1, when=sent_l)
    state["pending"] = state["pending"] + sent_l.to(_i32)
    # STORE (fire-and-forget, but bounded by buffer space)
    can_store = can_issue & (op == STORE) & ~src_busy & ~dst_busy & \
        ports.can_send(0)
    ports, sent_s = ports.send(
        0, msg_new(3, p0=take(state["regs"], rs1), p1=32), when=can_store)
    # BRANCH (resolve in EX: 2-cycle flush when taken)
    do_br = can_issue & (op == BNEZ) & ~src_busy
    taken = do_br & (take(state["regs"], rs1) != 0)
    # HALT
    do_halt = can_issue & (op == HALT)
    state["done"] = torch.where(do_halt, 1, state["done"])
    state["halt_time"] = torch.where(do_halt, t, state["halt_time"])

    issued = do_alu | sent_l | sent_s | do_br | do_halt
    state["pc"] = torch.where(
        issued, torch.where(taken, pc + imm, pc + 1), state["pc"])
    state["retired"] = state["retired"] + issued.to(_i32)
    state["stall_until"] = torch.where(taken, t + params["flush_cycles"],
                                       state["stall_until"])
    # load-use stall bookkeeping (pure accounting)
    state["stalls"] = state["stalls"] + (can_issue & ~issued).to(_i32)
    progress = progress | issued
    nxt = torch.where(flushing & ~halted, state["stall_until"], -1.0)
    return state, ports, TickResult.make(progress | flushing, next_time=nxt)


def mem_tick(state, ports, t):
    state = dict(state)
    msg, got, ports = ports.recv(0, when=ports.can_send(0))
    is_read = got & (msg[0] == 1)
    ports, _ = ports.send(0, msg_reply(msg, 2, p0=payload(msg, 0),
                                       p1=payload(msg, 1)), when=is_read)
    state["served"] = state["served"] + got.to(_i32)
    return state, ports, TickResult.make(got)


# ---------------------------------------------------------------------------
# assembler + microbenchmarks (paper Fig. 12/13)
# ---------------------------------------------------------------------------
def asm(instrs):
    p = np.zeros((MAXI, 4), np.int32)
    for i, ins in enumerate(instrs):
        p[i] = ins + [0] * (4 - len(ins))
    return p


def prog_alu(n=64):
    return asm([[ADDI, 1, 1, 1] for _ in range(n)] + [[HALT]])


def prog_raw_hzd(n=32):
    # load-use chains: LOAD r2,[r1]; ADDI r3,r2,1 (stalls full latency)
    body = []
    for _ in range(n):
        body += [[LOAD, 2, 1, 0], [ADDI, 3, 2, 1]]
    return asm(body + [[HALT]])


def prog_br_loop(iters=16, body_n=4):
    # r5 = iters; loop: body_n ALUs; ADDI r5,r5,-1; BNEZ r5, -body_n-1
    pre = [[ADDI, 5, 0, iters]]
    body = [[ADDI, 1, 1, 1] for _ in range(body_n)]
    loop = body + [[ADDI, 5, 5, -1], [BNEZ, 5, 5, -(body_n + 1)]]
    return asm(pre + loop + [[HALT]])


def prog_nested_br(outer=4, inner=4):
    pre = [[ADDI, 5, 0, outer]]
    inner_l = [[ADDI, 6, 0, inner], [ADDI, 1, 1, 1], [ADDI, 6, 6, -1],
               [BNEZ, 6, 6, -2]]
    outer_l = inner_l + [[ADDI, 5, 5, -1], [BNEZ, 5, 5, -(len(inner_l) + 1)]]
    return asm(pre + outer_l + [[HALT]])


def prog_st_ld(n=16):
    body = []
    for _ in range(n):
        body += [[STORE, 1, 1, 0], [LOAD, 2, 1, 0], [ADDI, 3, 2, 1]]
    return asm(body + [[HALT]])


def prog_conc_st(n=32):
    return asm([[STORE, 1, 1, 0] for _ in range(n)] + [[HALT]])


def prog_ind_ld(n=32):
    # independent loads into rotating registers (no use: MLP-friendly)
    return asm([[LOAD, 2 + (i % 4), 1, 0] for i in range(n)] + [[HALT]])


def prog_mlp(n_indep: int, reps=None):
    reps = reps or max(1, min(8, (MAXI - 1) // (2 * n_indep)))
    body = []
    for _ in range(reps):
        for i in range(n_indep):
            body.append([LOAD, 2 + (i % 28), 1, 0])
        for i in range(n_indep):
            body.append([ADDI, 1, 2 + (i % 28), 0])  # consume
    return asm(body + [[HALT]])


MICROBENCHES = {
    "ALU": prog_alu, "RAW_HZD": prog_raw_hzd, "BR_LOOP": prog_br_loop,
    "LOOP1": lambda: prog_br_loop(iters=32, body_n=1),
    "NESTED_BR": prog_nested_br, "ST_LD": prog_st_ld,
    "CONC_ST": prog_conc_st, "IND_LD": prog_ind_ld,
}


def _cpu_state(progs: np.ndarray) -> dict:
    """The cpu kind's initial state for a stack of programs [n, MAXI, 4]."""
    n = progs.shape[0]
    z = lambda *s: torch.zeros((n,) + s, dtype=_i32)
    return {"prog": torch.from_numpy(np.ascontiguousarray(progs)),
            "pc": z(), "regs": z(33), "busy": z(33), "pending": z(),
            "retired": z(), "stalls": z(), "done": z(),
            "halt_time": torch.zeros(n, dtype=_f32),
            "stall_until": torch.zeros(n, dtype=_f32)}


def build_onira(progs: list[np.ndarray], mem_latency: float = 5.0,
                naive: bool = False, device=None):
    n = len(progs)
    b = SimBuilder()
    cpu = b.add_kind(ComponentKind(
        "cpu", cpu_tick, n, 1, _cpu_state(np.stack(progs)), cap=4,
        params=CPU_PARAMS))
    mem = b.add_kind(ComponentKind(
        "mem", mem_tick, n, 1, {"served": torch.zeros(n, dtype=_i32)},
        cap=4))
    for i in range(n):
        b.connect([cpu.port(i, 0), mem.port(i, 0)], latency=mem_latency)
    sim = b.build(naive=naive, device=device)
    return sim, sim.init_state()


def build_onira_family(progs: list[np.ndarray], mem_latency: float = 5.0,
                       shape=None, naive: bool = False, device=None):
    """The onira topology family: up to ``len(progs)`` CPU+memory pairs.

    One padded build (``pad_shape`` sizes the cpu/mem segments to the
    family maximum) runs any prefix of the program list via activity
    masks — the ``shape.cpu`` axis sweeps how many pipelines are live
    without recompiling, and each masked run is bit-identical on active
    rows to ``build_onira(progs[:n])``.

    Returns a :class:`repro_torch.dse.TopologyFamily` with shape axis
    ``cpu``.
    """
    from repro_torch.dse.family import TopologyFamily

    n_max = len(progs)
    if shape:
        # size the family to the sweep's maximum (must fit the programs)
        n_max = int(shape.get("cpu", n_max))
        assert n_max <= len(progs), (n_max, len(progs))
    b = SimBuilder()
    cpu = b.add_kind(ComponentKind(
        "cpu", cpu_tick, 1, 1, _cpu_state(np.zeros((1, MAXI, 4), np.int32)),
        cap=4, params=CPU_PARAMS))
    mem = b.add_kind(ComponentKind(
        "mem", mem_tick, 1, 1, {"served": torch.zeros(1, dtype=_i32)},
        cap=4))
    for i in range(n_max):
        b.connect([cpu.port(i, 0), mem.port(i, 0)], latency=mem_latency)
    sim = b.build(naive=naive, pad_shape={"cpu": n_max, "mem": n_max},
                  device=device)

    def state_fn(shape_d):
        n = int(shape_d["cpu"])
        prog = np.zeros((n_max, MAXI, 4), np.int32)
        prog[:n] = np.stack(progs[:n])
        st = sim.init_state()
        cs = dict(st.comp_state)
        cs["cpu"] = dict(cs["cpu"], prog=torch.from_numpy(prog))
        return dataclasses.replace(
            st, comp_state=tree_map(lambda a: a.to(sim.device), cs))

    return TopologyFamily(
        sim=sim, shape_max={"cpu": n_max},
        kind_counts=lambda s: {"cpu": s["cpu"], "mem": s["cpu"]},
        state_fn=state_fn)


def run_microbenches(names=None, mem_latency=5.0, until=20000.0,
                     device=None):
    names = names or list(MICROBENCHES)
    progs = [MICROBENCHES[n]() for n in names]
    sim, st = build_onira(progs, mem_latency, device=device)
    out = sim.run(st, until=until)
    cs = {k: v.cpu() for k, v in out.comp_state["cpu"].items()}
    res = {}
    for i, n in enumerate(names):
        insts = int(cs["retired"][i])
        cycles = float(cs["halt_time"][i])
        res[n] = {"insts": insts, "cycles": cycles,
                  "cpi": cycles / max(insts, 1),
                  "done": bool(cs["done"][i])}
    return res


def run_mlp_sweep(n_values=(1, 2, 4, 8, 16), mem_latency=5.0, device=None):
    progs = [prog_mlp(n) for n in n_values]
    sim, st = build_onira(progs, mem_latency, device=device)
    out = sim.run(st, until=50000.0)
    cs = {k: v.cpu() for k, v in out.comp_state["cpu"].items()}
    return {n: float(cs["halt_time"][i]) / max(int(cs["retired"][i]), 1)
            for i, n in enumerate(n_values)}


# Closed-form pipeline reference (the reference's RTL stand-in)
def analytic_cpi(name: str, mem_latency: float = 5.0) -> float:
    L = mem_latency + 1  # + request wire cycle
    if name == "ALU":
        return 1.0
    if name == "RAW_HZD":
        # per pair: LOAD issues, ADDI waits full round-trip (2L), then 1
        return (1 + 2 * L + 1) / 2
    if name in ("BR_LOOP", "LOOP1"):
        body = 4 if name == "BR_LOOP" else 1
        per_iter = body + 2 + 2  # insts + dec/bnez + flush
        return per_iter / (body + 2)
    if name == "NESTED_BR":
        return 1.6  # mixed flushes, approximate
    if name == "ST_LD":
        return (3 + 2 * L) / 3  # ld-use exposed each triple
    if name == "CONC_ST":
        # fire-and-forget through a 4-deep buffer drained 1/cycle after L
        return 1.25
    if name == "IND_LD":
        # 4-entry load queue, round trip = L (req) + 1 (service) + L (resp)
        return (2 * mem_latency + 1) / 4
    raise KeyError(name)
