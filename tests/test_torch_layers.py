"""Port's layers against the JAX package's, on seeded numpy inputs.

Everything runs in f32 unless a case says otherwise; f32 tolerances are
1e-5 for elementwise layers and 1e-4 where matrix products or scans sum in
another order.  bf16 cases use 2e-2 (one bf16 rounding at other places).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import ssm as jssm
from repro_torch.configs import get_smoke_config
from repro_torch.convert import to_tensor
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as ttfm

RNG = np.random.default_rng(0)


def _r(*shape, scale=1.0):
    return (RNG.standard_normal(shape, dtype=np.float32) * scale)


def _close(out, ref, tol=1e-5):
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                               atol=tol, rtol=tol)


def _tree_t(tree):
    return jax.tree.map(to_tensor, tree)


def _cfg():
    return dataclasses.replace(jax_smoke("hymba-1.5b"), window=32)


def _params(specs):
    """Seeded numpy parameters for a spec dict, 1/sqrt(fan-in) scaled."""
    return {k: _r(*ps.shape, scale=ps.shape[0] ** -0.5)
            for k, ps in specs.items()}


def test_smoke_configs_match():
    for arch in ("hymba-1.5b", "stablelm-1.6b", "mamba2-130m"):
        assert dataclasses.asdict(get_smoke_config(arch)) == \
            dataclasses.asdict(jax_smoke(arch))


@pytest.mark.parametrize("dname,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_norms(dname, tol):
    x, w, b = _r(3, 5, 48), _r(48, scale=0.1), _r(48, scale=0.1)
    jd = getattr(jnp, dname)
    td = getattr(torch, dname)
    jx, tx = jnp.asarray(x).astype(jd), torch.from_numpy(x).to(td)
    _close(tlayers.rmsnorm(tx, torch.from_numpy(w)),
           jlayers.rmsnorm(jx, jnp.asarray(w)), tol)
    _close(tlayers.layernorm(tx, torch.from_numpy(w), torch.from_numpy(b)),
           jlayers.layernorm(jx, jnp.asarray(w), jnp.asarray(b)), tol)


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_mlp(act):
    p = {k: _r(*ps.shape, scale=0.2)
         for k, ps in jlayers.mlp_specs(32, 64, act).items()}
    x = _r(2, 7, 32)
    _close(tlayers.mlp(_tree_t(p), torch.from_numpy(x), act),
           jlayers.mlp(jax.tree.map(jnp.asarray, p), jnp.asarray(x), act),
           1e-4)


@pytest.mark.parametrize("tie", [False, True])
def test_embed_unembed_and_softcap(tie):
    cfg = dataclasses.replace(jax_smoke("stablelm-1.6b"), vocab=100,
                              tie_embeddings=tie, final_softcap=30.0,
                              norm="rms")
    p = {k: _r(*ps.shape, scale=0.3)
         for k, ps in jlayers.embed_specs(cfg).items()}
    toks = RNG.integers(0, cfg.vocab, (2, 9)).astype(np.int32)
    e = tlayers.embed(_tree_t(p), cfg, torch.from_numpy(toks).long())
    _close(e, jlayers.embed(jax.tree.map(jnp.asarray, p), cfg,
                            jnp.asarray(toks)))
    x = _r(2, 9, cfg.d_model)
    lt = tlayers.unembed(_tree_t(p), cfg, torch.from_numpy(x))
    lj = jlayers.unembed(jax.tree.map(jnp.asarray, p), cfg, jnp.asarray(x))
    assert lt.shape == (2, 9, cfg.vocab_padded)
    assert bool((lt[..., cfg.vocab:] == -1e30).all())
    _close(lt[..., :cfg.vocab], np.asarray(lj)[..., :cfg.vocab], 1e-4)


def test_rope():
    x = _r(2, 11, 3, 16)
    pos = RNG.integers(0, 500, (2, 11)).astype(np.int32)
    _close(tattn.rope(torch.from_numpy(x), torch.from_numpy(pos), 10_000.0),
           jattn.rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0), 1e-4)


@pytest.mark.parametrize("chunk", [1024, 16])     # softmax / online branch
@pytest.mark.parametrize("window", [0, 12])
@pytest.mark.parametrize("probs_bf16", [False, True])
def test_blockwise_attention_with_invalid_slots(chunk, window, probs_bf16):
    B, Sq, Sk, H, KV, hd = 2, 3, 40, 4, 2, 16
    q, k, v = _r(B, Sq, H, hd), _r(B, Sk, KV, hd), _r(B, Sk, KV, hd)
    q_pos = np.array([[20, 21, 22], [30, 31, 32]], np.int32)
    kv_pos = np.tile(np.arange(Sk, dtype=np.int32), (B, 1))
    kv_pos[0, 23:] = -1          # slots past the cache length are invalid
    kv_pos[1, 33:] = -1
    kw = dict(causal=True, window=window, cap=20.0, chunk=chunk,
              probs_bf16=probs_bf16)
    out = tattn.blockwise_attention(
        *(torch.from_numpy(a) for a in (q, k, v, q_pos, kv_pos)), **kw)
    ref = jattn.blockwise_attention(
        *(jnp.asarray(a) for a in (q, k, v, q_pos, kv_pos)), **kw)
    _close(out, ref, 2e-2 if probs_bf16 else 1e-5)


def test_blockwise_attention_mixed_dtypes_follow_jax():
    """Decode attends f32 queries against a bf16 cache: scores in f32, P
    cast to the cache's dtype before P·V, output in the cache's dtype."""
    B, S, H, KV, hd = 2, 24, 4, 2, 16
    q, k, v = _r(B, 1, H, hd), _r(B, S, KV, hd), _r(B, S, KV, hd)
    q_pos = np.array([[10], [20]], np.int32)
    kv_pos = np.where(np.arange(S)[None] <= q_pos, np.arange(S)[None], -1)
    out = tattn.blockwise_attention(
        torch.from_numpy(q), torch.from_numpy(k).bfloat16(),
        torch.from_numpy(v).bfloat16(), torch.from_numpy(q_pos),
        torch.from_numpy(kv_pos.astype(np.int32)))
    ref = jattn.blockwise_attention(
        jnp.asarray(q), jnp.asarray(k).astype(jnp.bfloat16),
        jnp.asarray(v).astype(jnp.bfloat16), jnp.asarray(q_pos),
        jnp.asarray(kv_pos.astype(np.int32)))
    assert out.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    _close(out, ref, 2e-2)


def test_attention_block_decode_writes_cache():
    cfg = _cfg()
    p = _params(jattn.attn_specs(cfg))
    B, S = 2, 16
    x = _r(B, 1, cfg.d_model)
    ck = _r(B, S, cfg.n_kv_heads, cfg.head_dim)
    cv = _r(B, S, cfg.n_kv_heads, cfg.head_dim)
    pos = np.array([[5], [9]], np.int32)
    oj, (kj, vj) = jattn.attention_block(
        jax.tree.map(jnp.asarray, p), cfg, jnp.asarray(x), jnp.asarray(pos),
        window=cfg.window, cache=(jnp.asarray(ck), jnp.asarray(cv)),
        cache_len=jnp.asarray(pos) + 1)
    tck, tcv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    ot, (kt, vt) = tattn.attention_block(
        _tree_t(p), cfg, torch.from_numpy(x), torch.from_numpy(pos),
        window=cfg.window, cache=(tck, tcv),
        cache_len=torch.from_numpy(pos) + 1)
    assert kt is tck and vt is tcv          # written in place
    _close(ot, oj, 1e-4)
    _close(kt, kj, 1e-5)
    _close(vt, vj, 1e-5)


@pytest.mark.parametrize("S", [16, 13, 5])   # whole chunks, ragged, < chunk
def test_ssm_block_prefill_then_decode(S):
    cfg = _cfg()
    p = _params(jssm.ssm_specs(cfg))
    x = _r(2, S, cfg.d_model)
    jp, tp = jax.tree.map(jnp.asarray, p), _tree_t(p)
    oj, cj = jssm.ssm_block(jp, cfg, jnp.asarray(x), cache="init")
    ot, ct = tssm.ssm_block(tp, cfg, torch.from_numpy(x), cache="init")
    _close(ot, oj, 1e-4)
    _close(ct[0], cj[0], 1e-5)
    _close(ct[1], cj[1], 1e-4)
    x1 = _r(2, 1, cfg.d_model)
    # the engine keeps the conv state in bf16, the SSM state in f32
    conv_j, conv_t = cj[0].astype(jnp.bfloat16), ct[0].bfloat16()
    oj2, (cvj, hj) = jssm.ssm_block(jp, cfg, jnp.asarray(x1),
                                    cache=(conv_j, cj[1]))
    ot2, (cvt, ht) = tssm.ssm_block(tp, cfg, torch.from_numpy(x1),
                                    cache=(conv_t, ct[1]))
    assert cvt.dtype == torch.float32 and cvj.dtype == jnp.float32
    _close(ot2, oj2, 1e-4)
    _close(cvt, cvj, 1e-5)
    _close(ht, hj, 1e-4)


def test_init_params_kinds_and_scales():
    cfg = get_smoke_config("hymba-1.5b")
    g = torch.Generator().manual_seed(0)
    p = tlayers.init_params(ttfm.model_specs(cfg), g, dtype=torch.float32)
    layer = p["layers"]["0"]
    assert torch.equal(layer["ln1"], torch.zeros(cfg.d_model))
    assert torch.equal(layer["ssm"]["D"], torch.ones(cfg.n_ssm_heads))
    assert layer["attn"]["wq"].shape == (cfg.d_model, cfg.n_heads,
                                         cfg.head_dim)
    std = float(p["embed"]["unembed"].std())
    assert abs(std - cfg.d_model ** -0.5) < 0.2 * cfg.d_model ** -0.5
    assert abs(float(p["embed"]["tok"].std()) - 1.0) < 0.1
    assert len(p["layers"]) == cfg.n_layers
