"""The port's engine against the JAX engine on the topologies of
tests/core/test_engine.py: Smart Ticking rules 1-3, the Availability
Backpropagation chain, round-robin fairness, event-driven sleep,
conservation under tiny buffers, and the smart==naive property.  Every
case runs in both packages and compares the whole final state, leaf by
leaf, bits and dtypes."""
import numpy as np
import pytest

try:                           # optional: only the property test needs it
    from hypothesis import given, settings
    from hypothesis import strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:            # pragma: no cover
    HAVE_HYPOTHESIS = False

from _torch_sim_parity import (KITS, as_np, assert_same_state, make_consumer,
                               make_forwarder, make_producer)


def _basic(kit):
    b = kit.core.SimBuilder()
    p = b.add_kind(make_producer(kit, 1, [5]))
    c = b.add_kind(make_consumer(kit, 1))
    b.connect([p.port(0, 0), c.port(0, 0)], latency=1.0)
    sim = b.build(**kit.build_kw)
    return sim, sim.init_state(), 1000.0


def _rule1(kit):
    b = kit.core.SimBuilder()
    p = b.add_kind(make_producer(kit, 1, [1]))
    c = b.add_kind(make_consumer(kit, 1))
    b.kinds[1].start_asleep = True  # consumer never self-starts
    b.connect([p.port(0, 0), c.port(0, 0)], latency=3.0)
    sim = b.build(**kit.build_kw)
    return sim, sim.init_state(), 100.0


def _rule2(kit):
    b = kit.core.SimBuilder()
    p = b.add_kind(make_producer(kit, 1, [6]))
    b.kinds[0].cap = 1
    c = b.add_kind(make_consumer(kit, 1, period=4.0, cap=1))
    b.connect([p.port(0, 0), c.port(0, 0)], latency=1.0)
    sim = b.build(**kit.build_kw)
    return sim, sim.init_state(), 2000.0


def _backprop_chain(kit):
    b = kit.core.SimBuilder()
    p = b.add_kind(make_producer(kit, 1, [8]))
    b.kinds[0].cap = 1
    f = b.add_kind(make_forwarder(kit, "forwarder", 1, cap=1))
    c = b.add_kind(make_consumer(kit, 1, period=5.0, cap=1))
    b.connect([p.port(0, 0), f.port(0, 0)], latency=1.0)
    b.connect([f.port(0, 1), c.port(0, 0)], latency=1.0)
    sim = b.build(**kit.build_kw)
    return sim, sim.init_state(), 5000.0


def _crossbar(kit):
    b = kit.core.SimBuilder()
    p = b.add_kind(make_producer(kit, 3, [10, 10, 10]))
    c = b.add_kind(make_consumer(kit, 1))
    b.connect([p.port(0, 0), p.port(1, 0), p.port(2, 0), c.port(0, 0)],
              latency=1.0)
    sim = b.build(**kit.build_kw)
    st = sim.init_state()
    # explicit destination: multi-member connections have no default peer
    st.comp_state["producer"]["dst"] = kit.i32(
        np.full((3,), sim.port_id("consumer", 0, 0)))
    return sim, st, 2000.0


def _timer(kit):
    b = kit.core.SimBuilder()
    b.add_kind(kit.core.ComponentKind(
        "timer", kit.timer, 1, 1,
        {"count": kit.i32([0]), "next_fire": kit.f32([0.0])}))
    sim = b.build(**kit.build_kw)
    return sim, sim.init_state(), 1000.0


def _conservation(kit):
    b = kit.core.SimBuilder()
    p = b.add_kind(make_producer(kit, 4, [7, 3, 9, 1]))
    b.kinds[0].cap = 1
    c = b.add_kind(make_consumer(kit, 4, period=3.0, cap=1))
    for i in range(4):
        b.connect([p.port(i, 0), c.port(i, 0)], latency=2.0)
    sim = b.build(**kit.build_kw)
    return sim, sim.init_state(), 3000.0


def _run_both(topo):
    outs = []
    for kit in KITS:
        sim, st, until = topo(kit)
        outs.append(sim.run(st, until=until))
    ref, port = outs
    assert_same_state(port, ref)
    return port


def test_basic_pipeline_and_event_skip():
    s = _run_both(_basic)
    assert int(s.comp_state["consumer"]["received"]) == 5
    assert int(s.comp_state["consumer"]["sum"]) == 0 + 1 + 2 + 3 + 4
    assert int(s.stats.epochs) < 20


def test_rule1_arrival_wakes_sleeping_consumer():
    s = _run_both(_rule1)
    assert int(s.comp_state["consumer"]["received"]) == 1
    assert float(s.comp_state["consumer"]["last_t"]) == 4.0


def test_rule2_backpressure_wakes_producer():
    s = _run_both(_rule2)
    assert int(s.comp_state["consumer"]["received"]) == 6
    assert int(s.comp_state["producer"]["sent"]) == 6
    assert float(s.comp_state["consumer"]["last_t"]) >= 20.0


def test_availability_backprop_chain():
    s = _run_both(_backprop_chain)
    assert int(s.comp_state["consumer"]["received"]) == 8
    assert int(s.comp_state["forwarder"]["seen"]) == 8
    assert int(s.comp_state["consumer"]["sum"]) == sum(range(8))


def test_crossbar_round_robin_fairness():
    s = _run_both(_crossbar)
    assert int(s.comp_state["consumer"]["received"]) == 30
    assert s.comp_state["producer"]["sent"].tolist() == [10, 10, 10]


def test_sleep_until_event_driven():
    s = _run_both(_timer)
    assert int(s.comp_state["timer"]["count"]) == 11
    assert int(s.stats.epochs) <= 12


def test_message_conservation_under_tiny_buffers():
    s = _run_both(_conservation)
    assert s.comp_state["consumer"]["received"].tolist() == [7, 3, 9, 1]
    assert int(s.stats.delivered) == 20


@pytest.mark.parametrize("naive", [False, True])
def test_start_asleep_and_sampling_naive_and_smart(naive):
    """Rule 1's topology with buffer sampling on, in both engines."""
    outs = []
    for kit in KITS:
        b = kit.core.SimBuilder()
        p = b.add_kind(make_producer(kit, 2, [4, 2]))
        c = b.add_kind(make_consumer(kit, 2, period=2.0, cap=2))
        b.kinds[1].start_asleep = True
        for i in range(2):
            b.connect([p.port(i, 0), c.port(i, 0)], latency=3.0)
        sim = b.build(naive=naive, sample_period=5.0, max_samples=8,
                      **kit.build_kw)
        outs.append(sim.run(sim.init_state(), until=60.0))
    assert_same_state(outs[1], outs[0])
    assert outs[1].comp_state["consumer"]["received"].tolist() == [4, 2]
    assert int(outs[1].sample_idx) == 12      # t = 5, 10, ..., 60


# ---------------------------------------------------------------------------
# Property: smart == naive, exactly, in the port; and each equals the JAX
# engine's run of the same topology.
# ---------------------------------------------------------------------------
def _build_random(kit, n_stage, n_lane, counts, caps, cons_period, latency,
                  naive):
    b = kit.core.SimBuilder()
    p = b.add_kind(make_producer(kit, n_lane, counts))
    b.kinds[0].cap = caps[0]
    stages = [b.add_kind(make_forwarder(kit, f"fwd{si}", n_lane, caps[1]))
              for si in range(n_stage)]
    c = b.add_kind(make_consumer(kit, n_lane, period=float(cons_period),
                                 cap=caps[2]))
    for lane in range(n_lane):
        chain = [p.port(lane, 0)]
        for s in stages:
            chain += [s.port(lane, 0), s.port(lane, 1)]
        chain += [c.port(lane, 0)]
        for a, bb in zip(chain[::2], chain[1::2]):
            b.connect([a, bb], latency=float(latency))
    return b.build(naive=naive, **kit.build_kw)


def _check_smart_equals_naive(n_stage, n_lane, seed, cap0, cap1, cap2,
                              cons_period, latency):
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 8, size=n_lane).tolist()
    horizon = 400.0
    res = {}
    for kit in KITS:
        for naive in (False, True):
            sim = _build_random(kit, n_stage, n_lane, counts,
                                (cap0, cap1, cap2), cons_period, latency,
                                naive)
            res[kit.name, naive] = sim.run(sim.init_state(), until=horizon)
    for naive in (False, True):
        assert_same_state(res["torch", naive], res["jax", naive])
    smart, naive_s = res["torch", False], res["torch", True]
    for kname in smart.comp_state:
        for leaf in smart.comp_state[kname]:
            np.testing.assert_array_equal(
                as_np(smart.comp_state[kname][leaf]),
                as_np(naive_s.comp_state[kname][leaf]))
    np.testing.assert_array_equal(as_np(smart.stats.busy),
                                  as_np(naive_s.stats.busy))
    assert int(smart.stats.delivered) == int(naive_s.stats.delivered)
    assert int(smart.stats.progress_ticks) == \
        int(naive_s.stats.progress_ticks)
    assert int(smart.stats.ticks) <= int(naive_s.stats.ticks)


if HAVE_HYPOTHESIS:
    @settings(max_examples=4, deadline=None, derandomize=True)
    @given(
        n_stage=st.integers(0, 3),
        n_lane=st.integers(1, 3),
        seed=st.integers(0, 2 ** 31 - 1),
        cap0=st.integers(1, 3), cap1=st.integers(1, 3),
        cap2=st.integers(1, 3),
        cons_period=st.integers(1, 4),
        latency=st.integers(1, 3),
    )
    def test_smart_equals_naive(n_stage, n_lane, seed, cap0, cap1, cap2,
                                cons_period, latency):
        _check_smart_equals_naive(n_stage, n_lane, seed, cap0, cap1, cap2,
                                  cons_period, latency)
else:
    def test_smart_equals_naive():
        """One fixed example when hypothesis is unavailable; the full
        property run skips."""
        _check_smart_equals_naive(2, 2, 1234, 1, 2, 1, 3, 2)
        pytest.importorskip("hypothesis")

