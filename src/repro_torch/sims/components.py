"""First-party component library (paper §3: "Akita ships with a wide range
of first-party components, including caches with different write policies,
DRAM modules, TLBs and MMUs, on-chip and off-chip network models").
Counterpart of ``repro.sims.components``.

Every component is a plain ``tick_fn`` against the engine's port protocol —
the protocol-first, open-closed design of DX-1a/DX-1b: policies (write-back
vs write-through, row-buffer management, translation latencies) are
constructor parameters, not code edits.

Protocol opcodes (shared with memsys):
  1 READ_REQ  (p0=addr, p1=tag)     2 READ_RESP (p0=addr, p1=tag)
  3 WRITE_REQ (p0=addr, p1=tag)     4 WRITE_ACK (p0=addr, p1=tag)
  5 XLAT_REQ  (p0=vaddr, p1=tag)    6 XLAT_RESP (p0=paddr, p1=tag)

Dynamic single-row updates of the state tables go through ``oh_set``: the
indices here are always in range, where it equals the reference's
``.at[].set``.
"""
from __future__ import annotations

import torch

from repro_torch.core import (ComponentKind, TickResult, msg_new, msg_reply,
                              oh_set, opcode, payload)

READ_REQ, READ_RESP, WRITE_REQ, WRITE_ACK = 1, 2, 3, 4
XLAT_REQ, XLAT_RESP = 5, 6
PAGE = 4096
LINE = 64

_i32, _f32 = torch.int32, torch.float32


def _false():
    return torch.zeros((), dtype=torch.bool)


# ---------------------------------------------------------------------------
# Cache with configurable write policy (write-through / write-back)
# ---------------------------------------------------------------------------
def make_cache_kind(name: str, n: int, n_sets: int = 64,
                    write_back: bool = True, cap: int = 2) -> ComponentKind:
    """Direct-mapped cache; port 0 = upstream (CPU side), port 1 =
    downstream (memory side).  Write-back keeps dirty bits and evicts with a
    WRITE_REQ; write-through forwards every write immediately."""

    def tick(state, ports, t):
        state = dict(state)
        progress = _false()
        wb = torch.full((), write_back, dtype=torch.bool)

        # downstream fill response
        rmsg, rgot, ports = ports.recv(1, when=ports.can_send(0)
                                       & ports.can_send(1))
        r_is_read = rgot & (opcode(rmsg) == READ_RESP)
        addr_r = payload(rmsg, 0)
        set_r = (addr_r // LINE) % n_sets
        # write-back eviction of the victim line
        victim_dirty = r_is_read & (state["dirty"][set_r] > 0) & \
            (state["tags"][set_r] >= 0)
        ev_addr = state["tags"][set_r] * LINE
        ports, _ = ports.send(1, msg_new(WRITE_REQ, p0=ev_addr, p1=9999),
                              when=victim_dirty & wb)
        state["tags"] = oh_set(state["tags"], set_r, addr_r // LINE,
                               when=r_is_read)
        state["dirty"] = oh_set(state["dirty"], set_r, 0, when=r_is_read)
        ports, _ = ports.send(0, msg_new(READ_RESP, p0=addr_r,
                                         p1=payload(rmsg, 1)), when=r_is_read)
        state["mshr"] = torch.where(r_is_read, 0, state["mshr"])
        progress = progress | rgot

        # upstream request
        msg, got = ports.peek(0)
        op = opcode(msg)
        addr = payload(msg, 0)
        set_i = (addr // LINE) % n_sets
        hit = state["tags"][set_i] == addr // LINE
        is_rd, is_wr = op == READ_REQ, op == WRITE_REQ
        can_rd_hit = is_rd & hit & ports.can_send(0)
        can_rd_miss = is_rd & ~hit & (state["mshr"] == 0) & ports.can_send(1)
        # write policy: WB hits set dirty; WT forwards downstream
        can_wr_hit = is_wr & hit & (wb | ports.can_send(1)) & \
            ports.can_send(0)
        can_wr_miss = is_wr & ~hit & ports.can_send(1) & ports.can_send(0)
        accept = got & (can_rd_hit | can_rd_miss | can_wr_hit | can_wr_miss)
        _, _, ports = ports.recv(0, when=accept)

        ports, _ = ports.send(0, msg_new(READ_RESP, p0=addr,
                                         p1=payload(msg, 1)),
                              when=accept & can_rd_hit)
        ports, fwd = ports.send(1, msg_new(READ_REQ, p0=addr,
                                           p1=payload(msg, 1)),
                                when=accept & can_rd_miss)
        state["mshr"] = torch.where(fwd, 1, state["mshr"])
        state["dirty"] = oh_set(state["dirty"], set_i, 1,
                                when=accept & can_wr_hit & wb)
        ports, _ = ports.send(1, msg_new(WRITE_REQ, p0=addr,
                                         p1=payload(msg, 1)),
                              when=accept & ((can_wr_hit & ~wb)
                                             | can_wr_miss))
        ports, _ = ports.send(0, msg_new(WRITE_ACK, p0=addr,
                                         p1=payload(msg, 1)),
                              when=accept & (can_wr_hit | can_wr_miss))
        state["hits"] = state["hits"] + (accept & hit).to(_i32)
        state["misses"] = state["misses"] + (accept & ~hit).to(_i32)
        state["writes"] = state["writes"] + (accept & is_wr).to(_i32)
        progress = progress | accept
        return state, ports, TickResult.make(progress)

    return ComponentKind(name, tick, n, 2, {
        "tags": torch.full((n, n_sets), -1, dtype=_i32),
        "dirty": torch.zeros((n, n_sets), dtype=_i32),
        "mshr": torch.zeros(n, dtype=_i32),
        "hits": torch.zeros(n, dtype=_i32),
        "misses": torch.zeros(n, dtype=_i32),
        "writes": torch.zeros(n, dtype=_i32)}, cap=cap)


# ---------------------------------------------------------------------------
# TLB (one level) and MMU (page-table walker)
# ---------------------------------------------------------------------------
def make_tlb_kind(name: str, n: int, entries: int = 16,
                  cap: int = 2) -> ComponentKind:
    """Port 0 = upstream (translation requests), port 1 = downstream
    (next TLB level / MMU).  Direct-mapped on virtual page number."""

    def tick(state, ports, t):
        state = dict(state)
        progress = _false()
        rmsg, rgot, ports = ports.recv(1, when=ports.can_send(0))
        r_ok = rgot & (opcode(rmsg) == XLAT_RESP)
        vpn_r = state["pending_vpn"]
        state["vtags"] = oh_set(state["vtags"], vpn_r % entries, vpn_r,
                                when=r_ok)
        state["ptags"] = oh_set(state["ptags"], vpn_r % entries,
                                payload(rmsg, 0), when=r_ok)
        ports, _ = ports.send(0, msg_new(XLAT_RESP, p0=payload(rmsg, 0),
                                         p1=payload(rmsg, 1)), when=r_ok)
        state["busy"] = torch.where(r_ok, 0, state["busy"])
        progress = progress | rgot

        msg, got = ports.peek(0)
        vaddr = payload(msg, 0)
        vpn = vaddr // PAGE
        hit = state["vtags"][vpn % entries] == vpn
        can_hit = hit & ports.can_send(0)
        can_miss = ~hit & (state["busy"] == 0) & ports.can_send(1)
        accept = got & (opcode(msg) == XLAT_REQ) & (can_hit | can_miss)
        _, _, ports = ports.recv(0, when=accept)
        paddr = state["ptags"][vpn % entries]
        ports, _ = ports.send(0, msg_new(XLAT_RESP, p0=paddr,
                                         p1=payload(msg, 1)),
                              when=accept & can_hit)
        ports, fwd = ports.send(1, msg_new(XLAT_REQ, p0=vaddr,
                                           p1=payload(msg, 1)),
                                when=accept & can_miss)
        state["busy"] = torch.where(fwd, 1, state["busy"])
        state["pending_vpn"] = torch.where(fwd, vpn, state["pending_vpn"])
        state["hits"] = state["hits"] + (accept & hit).to(_i32)
        state["misses"] = state["misses"] + fwd.to(_i32)
        progress = progress | accept
        return state, ports, TickResult.make(progress)

    return ComponentKind(name, tick, n, 2, {
        "vtags": torch.full((n, entries), -1, dtype=_i32),
        "ptags": torch.zeros((n, entries), dtype=_i32),
        "busy": torch.zeros(n, dtype=_i32),
        "pending_vpn": torch.zeros(n, dtype=_i32),
        "hits": torch.zeros(n, dtype=_i32),
        "misses": torch.zeros(n, dtype=_i32)}, cap=cap)


def make_mmu_kind(name: str, n: int, walk_latency: float = 20.0,
                  max_vpn: int = 1 << 16, cap: int = 4) -> ComponentKind:
    """Page-table walker: identity-maps VPN->PPN after ``walk_latency``
    cycles; VPNs >= max_vpn fault (drop + count — the paper's Fig-6 'Page
    entry not found' scenario is raised host-side by the driver)."""

    def tick(state, ports, t):
        state = dict(state)
        progress = _false()
        # finish an in-flight walk
        fin = (state["busy"] > 0) & (t + 1e-3 >= state["done_at"]) & \
            ports.can_send(0)
        ports, _ = ports.send(0, msg_new(
            XLAT_RESP, p0=state["walk_vpn"] * PAGE + 0x1000,
            p1=state["walk_tag"]), when=fin)
        state["busy"] = torch.where(fin, 0, state["busy"])
        state["walks"] = state["walks"] + fin.to(_i32)
        progress = progress | fin
        # accept a new walk
        msg, got = ports.peek(0)
        vpn = payload(msg, 0) // PAGE
        fault = vpn >= max_vpn
        accept = got & (opcode(msg) == XLAT_REQ) & (state["busy"] == 0)
        _, _, ports = ports.recv(0, when=accept)
        state["faults"] = state["faults"] + (accept & fault).to(_i32)
        start = accept & ~fault
        state["busy"] = torch.where(start, 1, state["busy"])
        state["walk_vpn"] = torch.where(start, vpn, state["walk_vpn"])
        state["walk_tag"] = torch.where(start, payload(msg, 1),
                                        state["walk_tag"])
        state["done_at"] = torch.where(start, t + walk_latency,
                                       state["done_at"])
        progress = progress | accept
        nxt = torch.where(state["busy"] > 0, state["done_at"], -1.0)
        return state, ports, TickResult.make(progress, next_time=nxt)

    return ComponentKind(name, tick, n, 1, {
        "busy": torch.zeros(n, dtype=_i32),
        "walk_vpn": torch.zeros(n, dtype=_i32),
        "walk_tag": torch.zeros(n, dtype=_i32),
        "done_at": torch.zeros(n, dtype=_f32),
        "walks": torch.zeros(n, dtype=_i32),
        "faults": torch.zeros(n, dtype=_i32)}, cap=cap)


# ---------------------------------------------------------------------------
# Banked DRAM with a row-buffer model (DRAMSim-flavoured timing)
# ---------------------------------------------------------------------------
def make_dram_kind(name: str, n: int, n_banks: int = 8, row_bits: int = 11,
                   t_cas: float = 4.0, t_rcd: float = 8.0,
                   t_rp: float = 8.0, cap: int = 8) -> ComponentKind:
    """Row-buffer hits cost CAS; closed rows cost RP+RCD+CAS.  One request
    per tick; per-bank open-row state."""

    def tick(state, ports, t):
        state = dict(state)
        msg, got, ports = ports.recv(0, when=ports.can_send(0))
        op = opcode(msg)
        addr = payload(msg, 0)
        bank = (addr // LINE) % n_banks
        row = addr >> row_bits
        open_row = state["open_row"][bank]
        row_hit = open_row == row
        lat = torch.where(row_hit, t_cas,
                          torch.where(open_row < 0, t_rcd + t_cas,
                                      t_rp + t_rcd + t_cas))
        state["open_row"] = oh_set(state["open_row"], bank, row, when=got)
        state["row_hits"] = state["row_hits"] + (got & row_hit).to(_i32)
        state["served"] = state["served"] + got.to(_i32)
        # service time is modeled as a deferred reply (event-driven)
        is_read = got & (op == READ_REQ)
        ports, _ = ports.send(0, msg_reply(msg, READ_RESP, p0=addr,
                                           p1=payload(msg, 1)), when=is_read)
        # NB: latency variation is modeled by the bank's busy window; a
        # fully-timed variant would defer the send via next_time — kept
        # simple so the reply latency = connection latency + lat is folded
        # into stats (see test for row-hit accounting).
        state["busy_cycles"] = state["busy_cycles"] + \
            torch.where(got, lat, 0.0)
        return state, ports, TickResult.make(got)

    return ComponentKind(name, tick, n, 1, {
        "open_row": torch.full((n, n_banks), -1, dtype=_i32),
        "row_hits": torch.zeros(n, dtype=_i32),
        "served": torch.zeros(n, dtype=_i32),
        "busy_cycles": torch.zeros(n, dtype=_f32)}, cap=cap)
