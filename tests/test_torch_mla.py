"""The port's Multi-head Latent Attention against the JAX package's, on
seeded numpy inputs at deepseek-v2-236b's smoke widths.

Both forms are held: the materialised prefill (K/V per head from the
latent, ``blockwise_attention``) and the absorbed decode against the
latent cache, step by step, with outputs and caches compared after every
step.  f32 throughout unless a case says otherwise: 1e-5 of the largest
magnitude (matrix products summed in another order).  The cache may be
bf16 while the activations are f32, as ``ServeEngine``'s is; the last
test mirrors ``test_mla_absorbed_decode_matches_materialized`` of
``tests/models/test_components.py`` on the port, with its tolerances.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models import mla as jmla
from repro_torch.convert import to_tensor
from repro_torch.models import mla as tmla

CFG = jax_smoke("deepseek-v2-236b")


def _params(seed=0):
    rng = np.random.default_rng(seed)
    out = {}
    for k, ps in sorted(jmla.mla_specs(CFG).items()):
        if ps.init == "zeros":          # the norms: small, not zero
            out[k] = (rng.standard_normal(ps.shape) * 0.1).astype(np.float32)
        else:
            out[k] = (rng.standard_normal(ps.shape)
                      * ps.shape[0] ** -0.5).astype(np.float32)
    return out


def _x(B, S, seed=1):
    return (np.random.default_rng(seed).standard_normal((B, S, CFG.d_model))
            * 0.5).astype(np.float32)


def _close(out, ref, tol=1e-5):
    ref = np.asarray(ref, np.float32)
    err = np.abs(out.float().numpy() - ref).max()
    assert err <= tol * max(np.abs(ref).max(), 1e-30), (err,
                                                         np.abs(ref).max())


@pytest.fixture(scope="module")
def params():
    p = _params()
    return jax.tree.map(jnp.asarray, p), jax.tree.map(torch.from_numpy, p)


def test_projections_match_jax(params):
    jp, tp = params
    x = _x(2, 6)
    pos = np.tile(np.arange(6, dtype=np.int32), (2, 1))
    qn_j, qr_j = jmla._project_q(jp, CFG, jnp.asarray(x), jnp.asarray(pos))
    qn_t, qr_t = tmla._project_q(tp, CFG, torch.from_numpy(x),
                                 torch.from_numpy(pos))
    c_j, kr_j = jmla._project_latent(jp, CFG, jnp.asarray(x),
                                     jnp.asarray(pos))
    c_t, kr_t = tmla._project_latent(tp, CFG, torch.from_numpy(x),
                                     torch.from_numpy(pos))
    for a, b in ((qn_t, qn_j), (qr_t, qr_j), (c_t, c_j), (kr_t, kr_j)):
        assert tuple(a.shape) == b.shape
        _close(a, b)


@pytest.mark.parametrize("S", [7, 12])
def test_materialised_prefill_matches_jax(params, S):
    jp, tp = params
    x = _x(2, S, seed=S)
    pos = np.tile(np.arange(S, dtype=np.int32), (2, 1))
    oj, cj = jmla.mla_block(jp, CFG, jnp.asarray(x), jnp.asarray(pos))
    ot, ct = tmla.mla_block(tp, CFG, torch.from_numpy(x),
                            torch.from_numpy(pos))
    assert cj is None and ct is None
    _close(ot, oj)


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
def test_absorbed_decode_matches_jax(params, cache_dtype):
    """Decode token by token into a latent cache longer than the prompt;
    the port writes the cache in place, JAX returns new arrays: both must
    hold the same latents after every step (bf16 caches bit for bit)."""
    jp, tp = params
    B, S, S_max = 2, 6, 10
    x = _x(B, S, seed=3)
    jdt = jnp.float32 if cache_dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, cache_dtype)
    jc = (jnp.zeros((B, S_max, CFG.kv_lora), jdt),
          jnp.zeros((B, S_max, CFG.qk_rope_dim), jdt))
    tc = (torch.zeros((B, S_max, CFG.kv_lora), dtype=tdt),
          torch.zeros((B, S_max, CFG.qk_rope_dim), dtype=tdt))
    for t in range(S):
        pt = np.full((B, 1), t, np.int32)
        oj, jc = jmla.mla_block(jp, CFG, jnp.asarray(x[:, t:t + 1]),
                                jnp.asarray(pt), cache=jc,
                                cache_len=jnp.asarray(pt + 1))
        ot, tc2 = tmla.mla_block(tp, CFG, torch.from_numpy(x[:, t:t + 1]),
                                 torch.from_numpy(pt), cache=tc,
                                 cache_len=torch.from_numpy(pt + 1))
        assert tc2[0] is tc[0] and tc2[1] is tc[1]        # in place
        _close(ot, oj)
        for a, b in zip(tc, jc):
            if cache_dtype == "bfloat16":
                np.testing.assert_array_equal(
                    a.float().numpy(), np.asarray(b.astype(jnp.float32)))
            else:
                _close(a, b)


def test_absorbed_decode_bf16_activations_match_jax(params):
    """bf16 weights, activations and cache, as on the card: 2e-2 of the
    largest magnitude (bf16 rounds at other places in the two)."""
    jp, tp = params
    jb = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jp)
    tb = jax.tree.map(lambda a: a.to(torch.bfloat16), tp)
    B, S = 2, 5
    x = _x(B, S, seed=4)
    jc = (jnp.zeros((B, S, CFG.kv_lora), jnp.bfloat16),
          jnp.zeros((B, S, CFG.qk_rope_dim), jnp.bfloat16))
    tc = (torch.zeros((B, S, CFG.kv_lora), dtype=torch.bfloat16),
          torch.zeros((B, S, CFG.qk_rope_dim), dtype=torch.bfloat16))
    for t in range(S):
        pt = np.full((B, 1), t, np.int32)
        oj, jc = jmla.mla_block(jb, CFG,
                                jnp.asarray(x[:, t:t + 1]).astype(jnp.bfloat16),
                                jnp.asarray(pt), cache=jc)
        ot, tc = tmla.mla_block(tb, CFG,
                                to_tensor(np.asarray(
                                    jnp.asarray(x[:, t:t + 1]).astype(
                                        jnp.bfloat16))),
                                torch.from_numpy(pt), cache=tc)
        assert ot.dtype == torch.bfloat16
        _close(ot, oj.astype(jnp.float32), tol=2e-2)


def test_mla_absorbed_decode_matches_materialized(params):
    """The reference's component test on the port: decode (absorbed,
    latent cache) equals the train-form attention restricted to the
    causal prefix, position by position."""
    _, tp = params
    B, S = 2, 8
    x = torch.from_numpy(_x(B, S, seed=5))
    pos = torch.arange(S, dtype=torch.int32).expand(B, S)
    full, _ = tmla.mla_block(tp, CFG, x, pos)
    cache = (torch.zeros((B, S, CFG.kv_lora)),
             torch.zeros((B, S, CFG.qk_rope_dim)))
    outs = []
    for t in range(S):
        pt = torch.full((B, 1), t, dtype=torch.int32)
        o, cache = tmla.mla_block(tp, CFG, x[:, t:t + 1], pt, cache=cache,
                                  cache_len=pt + 1)
        outs.append(o)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), full.numpy(),
                               atol=3e-4, rtol=3e-3)
