"""The port's Onira model (``repro_torch.sims.onira``) against the JAX
package's: the same programs, and the same whole final states (f32 by
bits, dtypes included) for the microbenchmarks, the MLP sweep, singleton
and flush-cycle batches, the ``shape.cpu`` family and a small
``run_sweep``, at the sizes of the reference's own tests
(tests/sims/test_sims.py, tests/dse/test_equivalence.py,
tests/dse/test_structural.py)."""
import numpy as np
import pytest
import torch

import repro.dse as JD
import repro.sims.onira as jo
import repro_torch.dse as TD
import repro_torch.sims.onira as to
from _torch_sim_parity import assert_same_state, chip_smoke

NAMES = list(jo.MICROBENCHES)


def _progs(names=NAMES):
    return [jo.MICROBENCHES[n]() for n in names]


def test_programs_and_constants_equal_jax():
    assert list(to.MICROBENCHES) == NAMES
    for n in NAMES:
        assert np.array_equal(to.MICROBENCHES[n](), jo.MICROBENCHES[n]()), n
        assert to.analytic_cpi(n) == jo.analytic_cpi(n), n
        assert to.analytic_cpi(n, 9.0) == jo.analytic_cpi(n, 9.0), n
    for n in (1, 2, 3, 4, 8, 16, 40):
        assert np.array_equal(to.prog_mlp(n), jo.prog_mlp(n)), n
    for args in ((3, 2), (7, 1)):
        assert np.array_equal(to.prog_br_loop(*args), jo.prog_br_loop(*args))
        assert np.array_equal(to.prog_nested_br(*args),
                              jo.prog_nested_br(*args))
    for k in ("ADDI", "LOAD", "STORE", "BNEZ", "HALT", "MAXI"):
        assert getattr(to, k) == getattr(jo, k), k
    assert to.CPU_PARAMS["flush_cycles"].dtype == torch.float32
    assert float(to.CPU_PARAMS["flush_cycles"]) == \
        float(jo.CPU_PARAMS["flush_cycles"])


def test_initial_state_and_params_equal_jax():
    tsim, tst = to.build_onira(_progs(), device="cpu")
    jsim, jst = jo.build_onira(_progs())
    assert_same_state(tst, jst)
    assert_same_state(tsim.default_params(), jsim.default_params())


def test_microbenches_match_jax_and_the_cpi_band():
    """tests/sims/test_sims.py::test_onira_cpi_within_paper_band, with the
    whole final state held against the JAX run."""
    tsim, tst = to.build_onira(_progs(), device="cpu")
    jsim, jst = jo.build_onira(_progs())
    out = tsim.run(tst, until=20000.0)
    assert_same_state(out, jsim.run(jst, until=20000.0))
    assert int(out.stats.epochs) == 277 and float(out.time) == 417.0
    res = to.run_microbenches(device="cpu")
    assert res == jo.run_microbenches()
    for name, r in res.items():
        assert r["done"], name
        ref = to.analytic_cpi(name)
        assert abs(r["cpi"] - ref) / ref < 0.20, (name, r["cpi"], ref)


def test_mlp_sweep_matches_jax_and_saturates():
    ns = (1, 4, 16)
    progs = [to.prog_mlp(n) for n in ns]
    tsim, tst = to.build_onira(progs, device="cpu")
    jsim, jst = jo.build_onira(progs)
    assert_same_state(tsim.run(tst, until=50000.0),
                      jsim.run(jst, until=50000.0))
    mlp = to.run_mlp_sweep(n_values=ns, device="cpu")
    assert mlp == jo.run_mlp_sweep(n_values=ns)
    assert mlp[1] > mlp[4] > mlp[16] - 1e-6
    assert mlp[16] < 2.0


def test_singleton_batch_matches_unbatched_and_jax():
    """tests/dse/test_equivalence.py::test_onira_cpi_singleton_matches_
    unbatched: a 1-lane batch equals the single run, and JAX's."""
    tsim, tst = to.build_onira(_progs(), device="cpu")
    ref = tsim.run(tsim.copy_state(tst), until=20000.0)
    out = TD.lane(TD.BatchRunner(tsim).run_batch(
        TD.stack_states(tst, 1), TD.build_param_batch(tsim, [{}]),
        20000.0), 0)
    assert_same_state(out, ref)
    jsim, jst = jo.build_onira(_progs())
    jout = JD.lane(JD.BatchRunner(jsim).run_batch(
        JD.stack_states(jst, 1), JD.build_param_batch(jsim, [{}]),
        20000.0), 0)
    assert_same_state(out, jout)
    assert bool(out.comp_state["cpu"]["done"].all())


def test_flush_cycles_batch_matches_jax():
    """tests/dse/test_equivalence.py::test_onira_flush_cycles_sweep_moves_
    cpi: a costlier flush slows the loop, lane for lane as in JAX."""
    progs = [to.prog_br_loop(iters=16, body_n=4)]
    pts = [{"kind.cpu.flush_cycles": v} for v in (3.0, 9.0)]
    tsim, tst = to.build_onira(progs, device="cpu")
    out = TD.BatchRunner(tsim).run_batch(
        TD.stack_states(tst, 2), TD.build_param_batch(tsim, pts), 20000.0)
    jsim, jst = jo.build_onira(progs)
    jout = JD.BatchRunner(jsim).run_batch(
        JD.stack_states(jst, 2), JD.build_param_batch(jsim, pts), 20000.0)
    assert_same_state(out, jout)
    halt = out.comp_state["cpu"]["halt_time"][:, 0]
    assert halt[1] > halt[0]


@pytest.mark.parametrize("s", [1, 2, 4])
def test_family_matches_jax_and_unpadded_build(s):
    """tests/dse/test_structural.py::test_onira_family_cpi_matches_
    unpadded: the masked family run equals JAX's, and its active rows
    equal an unpadded build of the prefix."""
    names = ["ALU", "RAW_HZD", "BR_LOOP", "IND_LD"]
    progs = _progs(names)
    fam = to.build_onira_family(progs, device="cpu")
    out = fam.sim.run(fam.state_for({"cpu": s}), until=20000.0,
                      params=fam.params_for({"cpu": s}))
    jfam = jo.build_onira_family(progs)
    assert_same_state(out, jfam.sim.run(
        jfam.state_for({"cpu": s}), until=20000.0,
        params=jfam.params_for({"cpu": s})))
    rsim, rst = to.build_onira(progs[:s], device="cpu")
    ref = rsim.run(rst, until=20000.0)
    assert float(out.time) == float(ref.time)
    for f in ("epochs", "ticks", "progress_ticks", "delivered"):
        assert int(getattr(out.stats, f)) == int(getattr(ref.stats, f)), f
    for kind in ("cpu", "mem"):
        for leaf, a in ref.comp_state[kind].items():
            assert torch.equal(out.comp_state[kind][leaf][:s], a), leaf
    cs = out.comp_state["cpu"]
    assert bool(cs["done"][:s].all())
    for i in range(s):
        cpi = float(cs["halt_time"][i]) / max(int(cs["retired"][i]), 1)
        ref_cpi = to.analytic_cpi(names[i])
        assert abs(cpi - ref_cpi) / ref_cpi < 0.35, (names[i], cpi)


def _extract(sim, s):
    cs = s.comp_state["cpu"]
    return dict(virtual_time=float(s.time), epochs=int(s.stats.epochs),
                cycles=sum(np.asarray(cs["halt_time"]).tolist()),
                insts=int(np.asarray(cs["retired"]).sum()))


@pytest.mark.parametrize("family", [False, True])
def test_run_sweep_rows_equal_jax(family):
    """A 2x2 ``run_sweep`` over flush cycles and memory latency (or the
    ``shape.cpu`` family axis): the rows equal JAX's."""
    progs = _progs(["BR_LOOP", "RAW_HZD"])
    if family:
        axes = {"shape.cpu": [1, 2], "kind.cpu.flush_cycles": [1.0, 8.0]}
        tb = lambda shape: to.build_onira_family(progs, shape=shape,
                                                 device="cpu")
        jb = lambda shape: jo.build_onira_family(progs, shape=shape)
    else:
        axes = {"kind.cpu.flush_cycles": [1.0, 8.0],
                "conn_latency": [1.0, 12.0]}
        tb = lambda: to.build_onira(progs, device="cpu")
        jb = lambda: jo.build_onira(progs)
    rows = TD.run_sweep(tb, TD.SweepSpec.grid(axes), until=20000.0,
                        extract=_extract)
    assert rows == JD.run_sweep(jb, JD.SweepSpec.grid(axes), until=20000.0,
                                extract=_extract)
    assert len({r["cycles"] for r in rows}) == 4


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        to.build_onira(_progs(["ALU"]))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        to.build_onira_family(_progs(["ALU"]))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        to.run_microbenches(["ALU"])


def test_onira_refs_are_the_jax_package_results():
    """``chip_smoke.ONIRA_REF`` and the family entry of
    ``ONIRA_SWEEP_REF``, made again from the JAX package."""
    cs = chip_smoke()
    ref = cs.ONIRA_REF
    res = jo.run_microbenches()
    assert {n: (r["insts"], r["cycles"], r["done"])
            for n, r in res.items()} == ref["micro"]
    assert jo.run_mlp_sweep() == ref["mlp"]
    jsim, jst = jo.build_onira(_progs())
    out = jsim.run(jst, until=cs.ONIRA_UNTIL)
    assert (int(out.stats.epochs), float(out.time)) == \
        (ref["epochs"], ref["virtual_time"])
    rows = JD.run_sweep(
        lambda shape: jo.build_onira_family(_progs(), shape=shape),
        JD.SweepSpec.grid(cs.ONIRA_FAMILY_AXES), until=cs.ONIRA_UNTIL,
        extract=cs._onira_extract)
    fam = cs.ONIRA_SWEEP_REF["family"]
    cols = fam["axes"] + cs.DSE_ROW + cs.ONIRA_COLS
    assert len(rows) == fam["n"]
    for i, want in fam["sample"].items():
        assert tuple(rows[i][c] for c in cols) == want, i
    cs._check_rows("onira family", rows, fam, cs.DSE_ROW + cs.ONIRA_COLS)
