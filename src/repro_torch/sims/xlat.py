"""Address-translation case study — the paper's Fig. 6 scenario.
Counterpart of ``repro.sims.xlat``; it reproduces that study's results bit
for bit.

A requester core drives loads through L1 TLB -> L2 TLB -> MMU (page-table
walker) built from the first-party component library.  A virtual address
beyond the mapped region raises the paper's "Page entry not found" panic,
and the enhanced backtrace prints the architectural cause chain
(instruction -> translation -> L1TLB -> L2TLB -> MMU) instead of a bare
Python stack.  Every builder runs on the card unless given
``device="cpu"``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import (ComponentKind, SimBuilder, TickResult, msg_new,
                              payload)
from repro_torch.core.tracing import TracingDomain

from .components import PAGE, XLAT_REQ, make_mmu_kind, make_tlb_kind

_i32 = torch.int32


def requester_tick(state, ports, t):
    state = dict(state)
    progress = torch.zeros((), dtype=torch.bool)
    msg, got, ports = ports.recv(0)
    state["outstanding"] = state["outstanding"] - got.to(_i32)
    state["translated"] = state["translated"] + got.to(_i32)
    state["last_paddr"] = torch.where(got, payload(msg, 0),
                                      state["last_paddr"])
    progress = progress | got
    idx = state["issued"]
    want = (idx < state["n_addrs"]) & (state["outstanding"] < 2)
    vaddr = state["addrs"][torch.clamp(idx, 0, state["addrs"].shape[0] - 1)]
    ports, sent = ports.send(0, msg_new(XLAT_REQ, p0=vaddr, p1=idx),
                             when=want)
    state["issued"] = state["issued"] + sent.to(_i32)
    state["outstanding"] = state["outstanding"] + sent.to(_i32)
    return state, ports, TickResult.make(progress | sent)


def build_xlat(addr_list, max_vpn: int = 1 << 10, naive: bool = False,
               device=None):
    addrs = np.asarray(addr_list, np.int32)
    z = lambda: torch.zeros(1, dtype=_i32)
    b = SimBuilder()
    req = b.add_kind(ComponentKind(
        "core", requester_tick, 1, 1,
        {"addrs": torch.from_numpy(addrs)[None, :],
         "n_addrs": torch.full((1,), len(addrs), dtype=_i32),
         "issued": z(), "outstanding": z(), "translated": z(),
         "last_paddr": z()}, cap=2))
    l1 = b.add_kind(make_tlb_kind("l1tlb", 1, entries=4))
    l2 = b.add_kind(make_tlb_kind("l2tlb", 1, entries=16))
    mmu = b.add_kind(make_mmu_kind("mmu", 1, walk_latency=20.0,
                                   max_vpn=max_vpn))
    b.connect([req.port(0, 0), l1.port(0, 0)], latency=1.0)
    b.connect([l1.port(0, 1), l2.port(0, 0)], latency=1.0)
    b.connect([l2.port(0, 1), mmu.port(0, 0)], latency=1.0)
    sim = b.build(naive=naive, device=device)
    return sim, sim.init_state()


class PageFault(RuntimeError):
    pass


def run_translation_study(addr_list, max_vpn: int = 1 << 10,
                          domain: TracingDomain | None = None,
                          until: float = 10000.0, device=None,
                          return_state: bool = False):
    """Returns stats; raises :class:`PageFault` with an enhanced backtrace
    if the MMU hits an unmapped page (paper Fig. 6b).  With
    ``return_state`` the stats also hold the final state (``"state"``)
    and the simulation (``"sim"``)."""
    dom = domain or TracingDomain("xlat")
    sim, st = build_xlat(addr_list, max_vpn, device=device)
    with dom.task("simulation", "translation-study", "engine"):
        out = sim.run(st, until=until)
        faults = int(out.comp_state["mmu"]["faults"][0])
        if faults:
            bad = [a for a in addr_list if a // PAGE >= max_vpn]
            with dom.task("instruction", f"load 0x{bad[0]:x}", "Core0"):
                with dom.task("translation", f"vaddr 0x{bad[0]:x}",
                              "L1TLB[0]"):
                    with dom.task("translation", "miss -> L2", "L2TLB"):
                        with dom.task("page-walk", f"vpn {bad[0]//PAGE}",
                                      "MMU"):
                            raise PageFault("Page entry not found!")
    cs = out.comp_state
    res = {
        "translated": int(cs["core"]["translated"][0]),
        "l1_hits": int(cs["l1tlb"]["hits"][0]),
        "l1_misses": int(cs["l1tlb"]["misses"][0]),
        "l2_hits": int(cs["l2tlb"]["hits"][0]),
        "l2_misses": int(cs["l2tlb"]["misses"][0]),
        "walks": int(cs["mmu"]["walks"][0]),
        "virtual_time": float(out.time),
    }
    if return_state:
        res.update(state=out, sim=sim)
    return res
