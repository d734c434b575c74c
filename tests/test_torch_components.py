"""The port's first-party components (``repro_torch.sims.components``)
against the JAX package's, in the small topologies of
tests/sims/test_stdlib_components.py: write-through and write-back caches
(with a dirty eviction), the TLB -> TLB -> MMU chain with and without a
page fault, and the banked DRAM's row-buffer accounting.  Each topology
runs in both packages, and the whole final states must be equal."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
import repro.sims.components as jc
import repro_torch.core as T
import repro_torch.sims.components as tc
from repro.sims.xlat import build_xlat
from _torch_sim_parity import assert_same_state

LINE, PAGE = tc.LINE, tc.PAGE


def test_constants_match():
    for k in ("READ_REQ", "READ_RESP", "WRITE_REQ", "WRITE_ACK", "XLAT_REQ",
              "XLAT_RESP", "PAGE", "LINE"):
        assert getattr(tc, k) == getattr(jc, k), k


# ---------------------------------------------------------------------------
# scripted driver and flat memory, in each package
# ---------------------------------------------------------------------------
def _j_driver(ops):
    ops = np.asarray(ops, np.int32)

    def tick(state, ports, t):
        state = dict(state)
        msg, got, ports = ports.recv(0)
        state["waiting"] = jnp.where(got, 0, state["waiting"])
        state["acks"] = state["acks"] + got.astype(jnp.int32)
        idx = state["idx"]
        want = (state["waiting"] == 0) & (idx < ops.shape[0])
        row = state["ops"][jnp.clip(idx, 0, ops.shape[0] - 1)]
        ports, sent = ports.send(0, J.msg_new(row[0], p0=row[1], p1=idx),
                                 when=want)
        state["idx"] = state["idx"] + sent.astype(jnp.int32)
        state["waiting"] = jnp.where(sent, 1, state["waiting"])
        return state, ports, J.TickResult.make(got | sent)

    return J.ComponentKind("driver", tick, 1, 1, {
        "ops": jnp.asarray(ops)[None, :, :],
        "idx": jnp.zeros(1, jnp.int32),
        "waiting": jnp.zeros(1, jnp.int32),
        "acks": jnp.zeros(1, jnp.int32)}, cap=2)


def _t_driver(ops):
    ops = np.asarray(ops, np.int32)

    def tick(state, ports, t):
        state = dict(state)
        msg, got, ports = ports.recv(0)
        state["waiting"] = torch.where(got, 0, state["waiting"])
        state["acks"] = state["acks"] + got.to(torch.int32)
        idx = state["idx"]
        want = (state["waiting"] == 0) & (idx < ops.shape[0])
        row = state["ops"][torch.clamp(idx, 0, ops.shape[0] - 1)]
        ports, sent = ports.send(0, T.msg_new(row[0], p0=row[1], p1=idx),
                                 when=want)
        state["idx"] = state["idx"] + sent.to(torch.int32)
        state["waiting"] = torch.where(sent, 1, state["waiting"])
        return state, ports, T.TickResult.make(got | sent)

    return T.ComponentKind("driver", tick, 1, 1, {
        "ops": torch.from_numpy(ops)[None, :, :],
        "idx": torch.zeros(1, dtype=torch.int32),
        "waiting": torch.zeros(1, dtype=torch.int32),
        "acks": torch.zeros(1, dtype=torch.int32)}, cap=2)


def _j_mem():
    def tick(state, ports, t):
        msg, got, ports = ports.recv(0, when=ports.can_send(0))
        is_read = got & (msg[0] == jc.READ_REQ)
        ports, _ = ports.send(0, J.msg_new(jc.READ_RESP, p0=J.payload(msg, 0),
                                           p1=J.payload(msg, 1)),
                              when=is_read)
        state = {"reads": state["reads"] + is_read.astype(jnp.int32),
                 "writes": state["writes"] +
                 (got & (msg[0] == jc.WRITE_REQ)).astype(jnp.int32)}
        return state, ports, J.TickResult.make(got)

    return J.ComponentKind("mem", tick, 1, 1,
                           {"reads": jnp.zeros(1, jnp.int32),
                            "writes": jnp.zeros(1, jnp.int32)}, cap=4)


def _t_mem():
    def tick(state, ports, t):
        msg, got, ports = ports.recv(0, when=ports.can_send(0))
        is_read = got & (msg[0] == tc.READ_REQ)
        ports, _ = ports.send(0, T.msg_new(tc.READ_RESP, p0=T.payload(msg, 0),
                                           p1=T.payload(msg, 1)),
                              when=is_read)
        state = {"reads": state["reads"] + is_read.to(torch.int32),
                 "writes": state["writes"] +
                 (got & (msg[0] == tc.WRITE_REQ)).to(torch.int32)}
        return state, ports, T.TickResult.make(got)

    return T.ComponentKind("mem", tick, 1, 1,
                           {"reads": torch.zeros(1, dtype=torch.int32),
                            "writes": torch.zeros(1, dtype=torch.int32)},
                           cap=4)


def _run_cache(ops, write_back):
    outs = []
    for core, drv, mem, lib, kw in (
            (J, _j_driver, _j_mem, jc, {}),
            (T, _t_driver, _t_mem, tc, {"device": "cpu"})):
        b = core.SimBuilder()
        d = b.add_kind(drv(ops))
        cache = b.add_kind(lib.make_cache_kind("c", 1, n_sets=16,
                                               write_back=write_back))
        m = b.add_kind(mem())
        b.connect([d.port(0, 0), cache.port(0, 0)], latency=1.0)
        b.connect([cache.port(0, 1), m.port(0, 0)], latency=4.0)
        sim = b.build(**kw)
        outs.append(sim.run(sim.init_state(), until=5000.0))
    assert_same_state(outs[1], outs[0])
    return outs[1].comp_state


A = 0x100


@pytest.mark.parametrize("write_back,mem_writes", [(False, 2), (True, 0)])
def test_write_policy(write_back, mem_writes):
    ops = [(tc.READ_REQ, A), (tc.WRITE_REQ, A), (tc.WRITE_REQ, A),
           (tc.READ_REQ, A)]
    cs = _run_cache(ops, write_back)
    assert int(cs["driver"]["acks"][0]) == 4
    assert int(cs["mem"]["writes"][0]) == mem_writes
    assert int(cs["c"]["hits"][0]) == 3


def test_write_back_evicts_dirty_victim():
    B_ = A + 16 * LINE                                # same set, new tag
    ops = [(tc.READ_REQ, A), (tc.WRITE_REQ, A), (tc.READ_REQ, B_)]
    cs = _run_cache(ops, write_back=True)
    assert int(cs["driver"]["acks"][0]) == 3
    assert int(cs["mem"]["writes"][0]) == 1          # victim written back


# ---------------------------------------------------------------------------
# TLB -> TLB -> MMU (the topology of repro.sims.xlat.build_xlat)
# ---------------------------------------------------------------------------
def _t_requester(state, ports, t):
    state = dict(state)
    progress = torch.zeros((), dtype=torch.bool)
    msg, got, ports = ports.recv(0)
    state["outstanding"] = state["outstanding"] - got.to(torch.int32)
    state["translated"] = state["translated"] + got.to(torch.int32)
    state["last_paddr"] = torch.where(got, T.payload(msg, 0),
                                      state["last_paddr"])
    progress = progress | got
    idx = state["issued"]
    want = (idx < state["n_addrs"]) & (state["outstanding"] < 2)
    vaddr = state["addrs"][torch.clamp(idx, 0, state["addrs"].shape[0] - 1)]
    ports, sent = ports.send(0, T.msg_new(tc.XLAT_REQ, p0=vaddr, p1=idx),
                             when=want)
    state["issued"] = state["issued"] + sent.to(torch.int32)
    state["outstanding"] = state["outstanding"] + sent.to(torch.int32)
    return state, ports, T.TickResult.make(progress | sent)


def _t_xlat(addr_list, max_vpn):
    addrs = np.asarray(addr_list, np.int32)
    z = lambda: torch.zeros(1, dtype=torch.int32)
    b = T.SimBuilder()
    req = b.add_kind(T.ComponentKind(
        "core", _t_requester, 1, 1,
        {"addrs": torch.from_numpy(addrs)[None, :],
         "n_addrs": torch.full((1,), len(addrs), dtype=torch.int32),
         "issued": z(), "outstanding": z(), "translated": z(),
         "last_paddr": z()}, cap=2))
    l1 = b.add_kind(tc.make_tlb_kind("l1tlb", 1, entries=4))
    l2 = b.add_kind(tc.make_tlb_kind("l2tlb", 1, entries=16))
    mmu = b.add_kind(tc.make_mmu_kind("mmu", 1, walk_latency=20.0,
                                      max_vpn=max_vpn))
    b.connect([req.port(0, 0), l1.port(0, 0)], latency=1.0)
    b.connect([l1.port(0, 1), l2.port(0, 0)], latency=1.0)
    b.connect([l2.port(0, 1), mmu.port(0, 0)], latency=1.0)
    sim = b.build(device="cpu")
    return sim, sim.init_state()


@pytest.mark.parametrize("fault", [False, True])
def test_tlb_mmu_chain(fault):
    addrs = [0 * PAGE + 8, 1 * PAGE + 8, 0 * PAGE + 64, 1 * PAGE + 64,
             0 * PAGE + 128]
    if fault:
        addrs.insert(2, (1 << 12) * PAGE)            # beyond max_vpn
    jsim, jst = build_xlat(addrs, max_vpn=1 << 10)
    ref = jsim.run(jst, until=10000.0)
    tsim, tst = _t_xlat(addrs, max_vpn=1 << 10)
    out = tsim.run(tst, until=10000.0)
    assert_same_state(out, ref)
    cs = out.comp_state
    assert int(cs["mmu"]["faults"][0]) == int(fault)
    if not fault:
        assert int(cs["core"]["translated"][0]) == 5
        assert int(cs["l1tlb"]["misses"][0]) == 2
        assert int(cs["mmu"]["walks"][0]) == 2
        assert int(cs["l1tlb"]["hits"][0]) == 3
        assert int(cs["l2tlb"]["misses"][0]) == 2


# ---------------------------------------------------------------------------
# banked DRAM
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("stride,row_hits", [(64, 3), (1 << 11, 0)])
def test_dram_row_buffer(stride, row_hits):
    ops = [(tc.READ_REQ, stride * i) for i in range(4)]
    outs = []
    for core, drv, lib, kw in ((J, _j_driver, jc, {}),
                               (T, _t_driver, tc, {"device": "cpu"})):
        b = core.SimBuilder()
        d = b.add_kind(drv(ops))
        dram = b.add_kind(lib.make_dram_kind("dram", 1, n_banks=1,
                                             row_bits=11))
        b.connect([d.port(0, 0), dram.port(0, 0)], latency=2.0)
        sim = b.build(**kw)
        outs.append(sim.run(sim.init_state(), until=2000.0))
    assert_same_state(outs[1], outs[0])
    cs = outs[1].comp_state
    assert int(cs["dram"]["served"][0]) == 4
    assert int(cs["dram"]["row_hits"][0]) == row_hits
