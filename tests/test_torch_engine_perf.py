"""The port's loop knobs against the JAX engine, on memsys: blocks of K
epochs (K=1 against 2, 3 and 8), donation, ``set_default_peers`` after a
run, ``params=`` overrides, topology families (``pad_shape`` with
``prefix_masks``), buffer sampling and the epoch budget.  Each case
compares the whole final state with the JAX engine's, bits and dtypes."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.sims.memsys as jm
import repro_torch.sims.memsys as tm
from _torch_sim_parity import as_np, assert_same_state


@pytest.mark.parametrize("super_epoch", [2, 3, 8])
def test_block_width_is_observation_invariant(super_epoch):
    kw = dict(n_cores=3, pattern="mixed", n_reqs=8)
    jsim, jst = jm.build(super_epoch=1, donate=False, **kw)
    ref = jsim.run(jst, until=20000.0)
    outs = []
    for k in (1, super_epoch):
        sim, st = tm.build(super_epoch=k, donate=False, device="cpu", **kw)
        assert sim.super_epoch == k
        outs.append(sim.run(st, until=20000.0))
        assert_same_state(outs[-1], ref)
    assert tm.finish_stats(sim, outs[-1])["remaining"] == 0


def test_cpu_block_width_follows_the_reference_heuristic():
    sim, _ = tm.build(n_cores=2, n_reqs=2, device="cpu")
    assert sim.super_epoch == 2


def test_consumed_state_raises_and_returned_state_chains():
    kw = dict(n_cores=2, pattern="mixed", n_reqs=4)
    sim, st = tm.build(device="cpu", **kw)
    out = sim.run(st, until=100.0)
    with pytest.raises(RuntimeError, match="copy_state"):
        sim.run(st, until=200.0)
    with pytest.raises(RuntimeError, match="donate=False"):
        sim.run(st, until=200.0)
    out2 = sim.run(out, until=200.0)
    jsim, jst = jm.build(**kw)
    ref = jsim.run(jsim.run(jst, until=100.0), until=200.0)
    assert_same_state(out2, ref)


def test_copy_state_survives_donation():
    sim, st = tm.build(n_cores=2, pattern="mixed", n_reqs=4, device="cpu")
    keep = sim.copy_state(st)
    out = sim.run(st, until=5000.0)
    out2 = sim.run(keep, until=5000.0)      # the copy is still usable
    assert_same_state(out2, out)
    jsim, jst = jm.build(n_cores=2, pattern="mixed", n_reqs=4)
    assert_same_state(out, jsim.run(jst, until=5000.0))


def test_no_donate_build_keeps_input_reusable():
    sim, st = tm.build(n_cores=2, pattern="mixed", n_reqs=4, donate=False,
                       device="cpu")
    before = sim.copy_state(st)
    out = sim.run(st, until=5000.0)
    assert_same_state(st, before)           # the input was not touched
    assert_same_state(sim.run(st, until=5000.0), out)


def test_set_default_peers_after_a_run():
    n = 3
    sim, st = tm.build_memsys(n_cores=n, pattern="stream", n_reqs=6,
                              donate=False, device="cpu")
    # unpatched peers: the l1 memory ports have no default peer on the
    # crossbar, so misses are never addressed to the DRAM and it stalls
    warm = sim.run(st, until=20000.0)
    assert tm.finish_stats(sim, warm)["remaining"] > 0
    jsim, jst = jm.build_memsys(n_cores=n, pattern="stream", n_reqs=6,
                                donate=False)
    assert_same_state(warm, jsim.run(jst, until=20000.0))
    dram_pid = sim.port_id("dram", 0, 0)
    sim.set_default_peers(
        {sim.port_id("l1", i, 1): dram_pid for i in range(n)})
    out = sim.run(st, until=20000.0)
    ref_sim, ref_st = jm.build(n_cores=n, pattern="stream", n_reqs=6,
                               donate=False)
    assert_same_state(out, ref_sim.run(ref_st, until=20000.0))
    assert tm.finish_stats(sim, out)["remaining"] == 0


OVERRIDES = {
    "conn_latency": lambda P, x: dataclasses.replace(
        P, conn_latency=x.f32([1.0, 1.0, 1.0, 17.0])),
    "periods": lambda P, x: dataclasses.replace(
        P, periods={**P.periods, "core": x.f32([2.0, 3.0, 1.0]),
                    "dram": x.f32([2.0])}),
    "think_scale": lambda P, x: dataclasses.replace(
        P, kind={**P.kind, "core": {"think_scale": x.f32(1.7)}}),
    "extra_hit_rate": lambda P, x: dataclasses.replace(
        P, kind={**P.kind, "l1": {"extra_hit_rate": x.f32(0.35)}}),
}


class _Jax:
    f32 = staticmethod(lambda v: jnp.asarray(v, jnp.float32))


class _Torch:
    f32 = staticmethod(lambda v: torch.as_tensor(np.asarray(v, np.float32)))


@pytest.mark.parametrize("knob", sorted(OVERRIDES))
def test_params_overrides_match_jax(knob):
    kw = dict(n_cores=3, pattern="mixed", n_reqs=8, donate=False)
    sim, st = tm.build(device="cpu", **kw)
    jsim, jst = jm.build(**kw)
    P = OVERRIDES[knob](sim.default_params(), _Torch)
    JP = OVERRIDES[knob](jsim.default_params(), _Jax)
    out = sim.run(st, until=20000.0, params=P)
    assert_same_state(out, jsim.run(jst, until=20000.0, params=JP))
    # the override moved the run, and params=None still runs the defaults
    base = sim.run(st, until=20000.0)
    assert_same_state(base, jsim.run(jst, until=20000.0))
    with pytest.raises(AssertionError):
        assert_same_state(out, base)


@pytest.mark.parametrize("cores", [2, 4])
def test_family_masks_match_jax_and_unpadded_build(cores):
    kw = dict(n_cores=4, pattern="mixed", n_reqs=6)
    fam = tm.build_family(device="cpu", **kw)
    jfam = jm.build_family(**kw)
    shape = {"core": cores}
    inst, conn = fam.sim.prefix_masks({"core": cores, "l1": cores})
    jinst, jconn = jfam.sim.prefix_masks({"core": cores, "l1": cores})
    assert_same_state({"inst": inst, "conn": conn},
                      {"inst": jinst, "conn": jconn})
    st, jst = fam.state_for(shape), jfam.state_for(shape)
    assert_same_state(st, jst)
    out = fam.sim.run(st, until=20000.0, params=fam.params_for(shape))
    assert_same_state(out, jfam.sim.run(jst, until=20000.0,
                                        params=jfam.params_for(shape)))
    # active rows equal an unpadded build of the sub-shape
    sim, st1 = tm.build(n_cores=cores, pattern="mixed", n_reqs=6,
                        device="cpu")
    ref = sim.run(st1, until=20000.0)
    assert float(out.time) == float(ref.time)
    for k in ("core", "l1"):
        for leaf, v in ref.comp_state[k].items():
            np.testing.assert_array_equal(
                as_np(out.comp_state[k][leaf])[:cores], as_np(v))


def test_sampling_matches_jax():
    kw = dict(n_cores=3, pattern="mixed", n_reqs=8, sample_period=25.0)
    sim, st = tm.build(device="cpu", **kw)
    jsim, jst = jm.build(**kw)
    out = sim.run(st, until=3000.0)
    assert_same_state(out, jsim.run(jst, until=3000.0))
    assert int(out.sample_idx) == 120          # t = 25, 50, ..., 3000
    assert as_np(out.buf_samples)[:120].any()


def test_epoch_budget_matches_jax():
    kw = dict(n_cores=3, pattern="stream", n_reqs=8)
    for naive in (False, True):
        sim, st = tm.build(naive=naive, super_epoch=3, device="cpu", **kw)
        jsim, jst = jm.build(naive=naive, super_epoch=3, **kw)
        out = sim.run(st, until=20000.0, max_epochs=50)
        assert int(out.stats.epochs) == 50
        assert_same_state(out, jsim.run(jst, until=20000.0, max_epochs=50))
