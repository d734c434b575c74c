"""The port's TrioSim (``repro_torch.sims.triosim``) and its trace builder
(``repro_torch.sims.opgraph``) against the JAX package's: equal operator
traces and analytic step times for several archs and plans up to 16
devices, and ``simulate_step`` at the plans of
tests/sims/test_sims.py::test_triosim_matches_analytic plus an 8-device
plan (a network kind with 8 ports): step time, epochs and the whole final
state (f32 by bits) equal JAX's."""
import dataclasses

import numpy as np
import pytest
import torch

import repro.sims.opgraph as jg
import repro.sims.triosim as jt
import repro_torch.sims.opgraph as tg
import repro_torch.sims.triosim as tt
from repro.configs import get_config as jcfg
from repro_torch.configs import get_config as tcfg
from _torch_sim_parity import assert_same_state, chip_smoke

TRACES = [  # arch, layers (None: all), batch, seq, (dp, tp, pp), micro
    ("stablelm-1.6b", 8, 4, 512, (2, 1, 1), 2),
    ("stablelm-1.6b", 24, 16, 1024, (1, 2, 2), 4),
    ("phi3-medium-14b", None, 16, 2048, (2, 4, 2), 8),
    ("phi3-medium-14b", None, 16, 2048, (2, 2, 4), 8),
    ("gemma2-27b", None, 8, 4096, (4, 2, 2), 4),
    ("deepseek-67b", 12, 8, 4096, (1, 8, 2), 1),
    ("grok-1-314b", 8, 4, 1024, (2, 2, 2), 3),
    ("mamba2-130m", None, 32, 512, (3, 1, 1), 0),
]


def _cfgs(arch, layers):
    j, t = jcfg(arch), tcfg(arch)
    if layers:
        j = dataclasses.replace(j, n_layers=layers)
        t = dataclasses.replace(t, n_layers=layers)
    return j, t


@pytest.mark.parametrize("arch,layers,batch,seq,plan,micro", TRACES)
def test_trace_and_analytic_equal_jax(arch, layers, batch, seq, plan,
                                      micro):
    jc, tc = _cfgs(arch, layers)
    assert tc.param_count() == jc.param_count()
    tops, tn = tg.build_train_trace(tc, batch, seq, *plan, micro=micro)
    jops, jn = jg.build_train_trace(jc, batch, seq, *plan, micro=micro)
    assert tn == jn
    assert tops.dtype == jops.dtype == np.int32
    assert np.array_equal(tops, jops)
    assert tops.shape[0] == int(np.prod(plan))
    assert tg.analytic_step_us(tc, batch, seq, *plan, micro) == \
        jg.analytic_step_us(jc, batch, seq, *plan, micro)
    hw = tg.HW(flops=300e12, link_bw=100e9)
    jhw = jg.HW(flops=300e12, link_bw=100e9)
    assert np.array_equal(
        tg.build_train_trace(tc, batch, seq, *plan, micro=micro, hw=hw)[0],
        jg.build_train_trace(jc, batch, seq, *plan, micro=micro, hw=jhw)[0])


@pytest.mark.parametrize("plan", [(2, 1, 1), (1, 2, 1), (1, 1, 2),
                                  (2, 2, 2)])
def test_simulate_step_matches_jax(plan):
    """Step time, epochs and the whole final state equal JAX's; the step
    stays within the reference test's band of the analytic model."""
    jc, tc = _cfgs("stablelm-1.6b", 8)
    r = tt.simulate_step(tc, batch=4, seq=512, dp=plan[0], tp=plan[1],
                         pp=plan[2], micro=2, device="cpu",
                         return_state=True)
    ops, n_tags = jg.build_train_trace(jc, 4, 512, *plan, 2)
    jsim, jst = jt.build_triosim(ops, n_tags)
    jout = jsim.run(jst, until=5e6, max_epochs=500_000)
    assert_same_state(r["state"], jout)
    ref = jt.simulate_step(jc, batch=4, seq=512, dp=plan[0], tp=plan[1],
                           pp=plan[2], micro=2)
    assert {k: r[k] for k in ref} == ref
    assert r["done"]
    a = tg.analytic_step_us(tc, 4, 512, *plan, 2)
    assert 0.9 < r["step_us"] / a < 1.15, (plan, r["step_us"], a)
    assert r["sim"].kinds[1].n_ports == int(np.prod(plan))


def test_network_scatters_drop_and_gathers_clamp():
    """The network kind's one-hot updates drop an index past the end (and
    count a negative one from the end), and its reads clamp, as the
    reference's ``.at[]`` and gathers do."""
    a = torch.zeros(5, dtype=torch.int32)
    assert tt._at(a, torch.tensor(7, dtype=torch.int32)).sum() == 0
    assert tt._at(a, torch.tensor(-1, dtype=torch.int32)).nonzero().item() \
        == 4
    from repro_torch.core import take
    b = torch.arange(5, dtype=torch.int32) * 10
    for ix, want in ((7, 40), (-1, 40), (-9, 0), (2, 20)):
        assert int(take(b, torch.tensor(ix, dtype=torch.int32))) == want


def test_build_refuses_more_than_30_devices():
    ops = np.zeros((31, 2, 4), np.int32)
    with pytest.raises(AssertionError, match="bitmap"):
        tt.build_triosim(ops, 1, device="cpu")


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tc = _cfgs("stablelm-1.6b", 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tt.simulate_step(tc, batch=2, seq=64)


@pytest.mark.parametrize("key", list(chip_smoke().TRIOSIM_REF))
def test_triosim_ref_is_the_jax_package_result(key):
    """Each plan of ``chip_smoke.TRIOSIM_REF``, made again from the JAX
    package (the two 16-GPU plans run phi3-medium-14b whole)."""
    arch, layers, batch, seq, micro, dp, tp, pp = key
    jc, _ = _cfgs(arch, layers)
    r = jt.simulate_step(jc, batch, seq, dp, tp, pp, micro)
    assert (r["done"], r["step_us"], r["epochs"]) == \
        chip_smoke().TRIOSIM_REF[key]
