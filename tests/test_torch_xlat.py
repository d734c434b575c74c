"""The port's address-translation study (``repro_torch.sims.xlat``)
against the JAX package's: the chain counts and the Fig. 6b backtrace of
tests/sims/test_stdlib_components.py, and a seeded 64-load study whose
whole final state (f32 by bits) equals JAX's."""
import numpy as np
import pytest
import torch

import repro.sims.xlat as jx
import repro_torch.sims.xlat as tx
from repro_torch.sims.components import PAGE
from _torch_sim_parity import assert_same_state, chip_smoke

CHAIN = [0 * PAGE + 8, 1 * PAGE + 8, 0 * PAGE + 64, 1 * PAGE + 64,
         0 * PAGE + 128]


def _seeded(n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, n) * PAGE
            + rng.integers(0, PAGE // 8, n) * 8).tolist()


def test_tlb_mmu_chain_counts():
    stats = tx.run_translation_study(CHAIN, device="cpu")
    assert stats == jx.run_translation_study(CHAIN)
    assert stats["translated"] == 5
    assert stats["l1_misses"] == 2 and stats["walks"] == 2
    assert stats["l1_hits"] == 3
    assert stats["l2_misses"] == 2


def test_page_fault_enhanced_backtrace(capsys):
    addrs = [0 * PAGE + 8, (1 << 12) * PAGE]          # second page unmapped
    with pytest.raises(tx.PageFault):
        tx.run_translation_study(addrs, max_vpn=1 << 10, device="cpu")
    out = capsys.readouterr().out
    # the paper's Fig-6b cause chain, root -> leaf
    for frag in ("@Core0, instruction, load", "@L1TLB[0], translation",
                 "@L2TLB, translation", "@MMU, page-walk"):
        assert frag in out, out


def test_seeded_study_matches_jax():
    addrs = _seeded(64)
    jsim, jst = jx.build_xlat(addrs)
    assert_same_state(tx.build_xlat(addrs, device="cpu")[1], jst)
    r = tx.run_translation_study(addrs, until=1e6, device="cpu",
                                 return_state=True)
    assert_same_state(r["state"], jsim.run(jst, until=1e6))
    assert int(r["state"].stats.epochs) == 567
    ref = jx.run_translation_study(addrs, until=1e6)
    assert {k: r[k] for k in ref} == ref
    assert r["translated"] == 64 and r["walks"] == 61


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tx.build_xlat(CHAIN)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tx.run_translation_study(CHAIN)


def test_xlat_ref_is_the_jax_package_result():
    cs = chip_smoke()
    assert list(cs.XLAT_CHAIN) == CHAIN
    assert jx.run_translation_study(CHAIN) == cs.XLAT_REF["chain"]
    seeded = cs.XLAT_SEEDED
    addrs = _seeded(seeded["n"], seeded["seed"])
    assert max(a // PAGE for a in addrs) < seeded["pages"]
    jsim, jst = jx.build_xlat(addrs)
    got = dict(jx.run_translation_study(addrs, until=seeded["until"]),
               epochs=int(jsim.run(jst, until=seeded["until"]).stats.epochs))
    assert got == cs.XLAT_REF["seeded"]
