"""The port's MoE block against the JAX package's, on seeded numpy inputs.

Weights and tokens are made with numpy and handed to both packages in
f32.  The drops decide which token reaches which expert, so routing and
slots must agree exactly: the port's expert choices equal
``jax.lax.top_k``'s (ties included), its slots equal a plain loop over
the choice-major running count fed with JAX's choices, and its outputs
equal JAX's within 1e-5 of their largest magnitude (the two frameworks
sum matrix products in another order).  ``aux`` sums f32 means in another
order too: within 1e-6 relative.  The last three tests mirror
``tests/models/test_components.py``'s MoE tests on the port alone, with
their tolerances.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models import moe as jmoe
from repro_torch.configs import get_smoke_config
from repro_torch.models import moe as tmoe


def _cfg(**kw):
    return dataclasses.replace(jax_smoke("grok-1-314b"), **kw)


def _params(cfg, seed=0):
    """Seeded numpy weights for ``moe_specs``, 1/sqrt(fan-in) scaled (the
    router at 0.02, as its spec says)."""
    rng = np.random.default_rng(seed)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(t[k]) for k in sorted(t)}
        scale = t.scale if t.scale is not None else t.shape[0] ** -0.5
        return (rng.standard_normal(t.shape) * scale).astype(np.float32)
    return walk(jmoe.moe_specs(cfg))


def _both(tree):
    return (jax.tree.map(jnp.asarray, tree),
            jax.tree.map(torch.from_numpy, tree))


def _x(B, S, d, seed=1, scale=1.0):
    return (np.random.default_rng(seed).standard_normal((B, S, d))
            * scale).astype(np.float32)


def _slots_loop(cfg, eidx, T):
    """Choice-major running count, written as the plain loop it stands
    for: group by group, every first choice before any second choice."""
    E, K = cfg.n_experts, cfg.top_k
    G, Tg, C = tmoe.capacity_of(cfg, T)
    slot = np.full((T, K), E * G * C, np.int64)
    for g in range(G):
        count = [0] * E
        for k in range(K):
            for t in range(Tg):
                e = int(eidx[g * Tg + t, k])
                if count[e] < C:
                    slot[g * Tg + t, k] = e * G * C + g * C + count[e]
                count[e] += 1
    return slot


CASES = {   # name: (config overrides, x shape)
    "no_drops": (dict(moe_capacity=8.0), (2, 16)),
    "groupwise": (dict(moe_capacity=8.0, moe_groups=4), (4, 8)),
    "forced_drops": (dict(moe_capacity=0.5), (2, 32)),
    "forced_drops_groupwise": (dict(moe_capacity=0.5, moe_groups=2),
                               (2, 32)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_moe_block_matches_jax(case):
    kw, (B, S) = CASES[case]
    cfg = _cfg(**kw)
    jp, tp = _both(_params(cfg))
    x = _x(B, S, cfg.d_model)
    out_j, aux_j = jmoe.moe_block(jp, cfg, jnp.asarray(x))
    out_t, aux_t = tmoe.moe_block(tp, cfg, torch.from_numpy(x))
    out_j = np.asarray(out_j)
    err = np.abs(out_t.numpy() - out_j).max()
    assert err <= 1e-5 * np.abs(out_j).max(), err
    np.testing.assert_allclose(float(aux_t), float(aux_j), rtol=1e-6)

    # the same expert choices as jax.lax.top_k, and the same kept slots
    xf = x.reshape(-1, cfg.d_model)
    logits = (jnp.asarray(xf) @ jp["router"]).astype(jnp.float32)
    _, eidx_j = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), cfg.top_k)
    _, _, eidx_t = tmoe._route(tp, torch.from_numpy(xf), cfg.top_k)
    np.testing.assert_array_equal(eidx_t.numpy(), np.asarray(eidx_j))
    slot, keep, C = tmoe.dispatch(cfg, eidx_t, B * S)
    want = _slots_loop(cfg, np.asarray(eidx_j), B * S)
    np.testing.assert_array_equal(slot.numpy(), want)
    assert C == tmoe.capacity_of(cfg, B * S)[0] * \
        tmoe.capacity_of(cfg, B * S)[2]
    dropped = int((~keep).sum())
    assert (dropped > 0) == case.startswith("forced_drops"), dropped


def test_group_fallback_and_capacity_follow_jax():
    """G falls back to 1 when T % G or T // G < 8; C is computed in
    Python floats and capped at the group's tokens."""
    cfg = _cfg(moe_groups=4, moe_capacity=1.25)
    assert tmoe.capacity_of(cfg, 32) == (4, 8, 8)
    assert tmoe.capacity_of(cfg, 28) == (1, 28, 17)   # 28 % 4 == 0, 7 < 8
    assert tmoe.capacity_of(cfg, 30) == (1, 30, 18)   # 30 % 4 != 0
    ds = get_smoke_config("deepseek-v2-236b")
    full = dataclasses.replace(ds, n_experts=160, top_k=6, moe_groups=32,
                               moe_capacity=1.0)
    assert tmoe.capacity_of(full, 384) == (32, 12, 8)
    assert tmoe.capacity_of(full, 200) == (1, 200, 8)  # int(7.5) -> 8
    assert tmoe.capacity_of(full, 4) == (1, 4, 4)      # decode: C = Tg


def test_ties_go_to_the_lower_expert_like_lax_top_k():
    cfg = _cfg()
    params = _params(cfg)
    params["router"][:] = 0.0                      # every expert ties
    jp, tp = _both(params)
    x = _x(1, 8, cfg.d_model)
    xf = x.reshape(-1, cfg.d_model)
    _, _, eidx_t = tmoe._route(tp, torch.from_numpy(xf), cfg.top_k)
    probs = jax.nn.softmax(jnp.zeros((8, cfg.n_experts)), axis=-1)
    _, eidx_j = jax.lax.top_k(probs, cfg.top_k)
    np.testing.assert_array_equal(eidx_t.numpy(), np.asarray(eidx_j))
    np.testing.assert_array_equal(eidx_t.numpy()[0], np.arange(cfg.top_k))
    out_j, _ = jmoe.moe_block(jp, cfg, jnp.asarray(x))
    out_t, _ = tmoe.moe_block(tp, cfg, torch.from_numpy(x))
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j),
                               atol=1e-5 * np.abs(np.asarray(out_j)).max())


@pytest.mark.parametrize("arch", ["grok-1-314b", "deepseek-v2-236b"])
def test_dense_ref_matches_jax(arch):
    """The oracle too (deepseek-v2 brings a shared expert)."""
    cfg = dataclasses.replace(jax_smoke(arch), moe_capacity=8.0)
    jp, tp = _both(_params(cfg))
    x = _x(2, 8, cfg.d_model, scale=0.5)
    ref_j = np.asarray(jmoe.moe_block_dense_ref(jp, cfg, jnp.asarray(x)))
    ref_t = tmoe.moe_block_dense_ref(tp, cfg, torch.from_numpy(x)).numpy()
    assert np.abs(ref_t - ref_j).max() <= 1e-5 * np.abs(ref_j).max()
    out_j, _ = jmoe.moe_block(jp, cfg, jnp.asarray(x))
    out_t, _ = tmoe.moe_block(tp, cfg, torch.from_numpy(x))
    assert np.abs(out_t.numpy() - np.asarray(out_j)).max() <= \
        1e-5 * np.abs(np.asarray(out_j)).max()


def test_moe_bf16_matches_jax():
    """bf16 weights and tokens: the routing is f32 in both, the experts
    run in bf16.  Outputs reach ~15, where one bf16 step is 0.125, so the
    bar is 2e-2 of the largest magnitude (bf16 rounds at other places)."""
    cfg = _cfg(moe_capacity=8.0)
    params = _params(cfg)
    x = _x(2, 16, cfg.d_model, scale=0.5)
    jp = jax.tree.map(lambda a: jnp.asarray(a).astype(jnp.bfloat16), params)
    tp = jax.tree.map(lambda a: torch.from_numpy(a).to(torch.bfloat16),
                      params)
    out_j, _ = jmoe.moe_block(jp, cfg, jnp.asarray(x).astype(jnp.bfloat16))
    out_t, _ = tmoe.moe_block(tp, cfg, torch.from_numpy(x).to(torch.bfloat16))
    assert out_t.dtype == torch.bfloat16
    ref = np.asarray(out_j.astype(jnp.float32))
    assert np.abs(out_t.float().numpy() - ref).max() <= \
        2e-2 * np.abs(ref).max()


# -- the reference's component tests, mirrored on the port -------------------
def _port_params(cfg):
    return jax.tree.map(torch.from_numpy, _params(cfg))


def test_moe_matches_dense_ref_when_no_drops():
    cfg = get_smoke_config("grok-1-314b")
    cfg = dataclasses.replace(cfg, moe_capacity=8.0)   # ample: no drops
    p = _port_params(cfg)
    x = torch.from_numpy(_x(2, 16, cfg.d_model, scale=0.5))
    out, aux = tmoe.moe_block(p, cfg, x)
    ref = tmoe.moe_block_dense_ref(p, cfg, x)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=2e-4,
                               rtol=2e-3)
    assert float(aux) > 0


def test_moe_groupwise_matches_monolithic():
    cfg1 = dataclasses.replace(get_smoke_config("grok-1-314b"),
                               moe_capacity=8.0, moe_groups=1)
    cfg4 = dataclasses.replace(cfg1, moe_groups=4)
    p = _port_params(cfg1)
    x = torch.from_numpy(_x(4, 8, cfg1.d_model, scale=0.5))
    o1, _ = tmoe.moe_block(p, cfg1, x)
    o4, _ = tmoe.moe_block(p, cfg4, x)
    assert tmoe.capacity_of(cfg4, 32)[0] == 4
    np.testing.assert_allclose(o1.numpy(), o4.numpy(), atol=2e-4, rtol=2e-3)


def test_moe_capacity_drops_are_bounded():
    cfg = dataclasses.replace(get_smoke_config("grok-1-314b"),
                              moe_capacity=0.5)
    p = _port_params(cfg)
    out, _ = tmoe.moe_block(p, cfg, torch.from_numpy(_x(2, 32, cfg.d_model)))
    assert torch.isfinite(out).all()
