"""Every architecture's smoke config through the port against the JAX
package, on the CPU.

The JAX package makes the parameters (f32; hubert-xlarge in bf16, see
below) and the port takes them through ``from_jax_params``; inputs come
from seeded numpy generators.  Each arch's prefill logits, caches and MoE
``aux`` are compared, then decode steps: the uniform cache through
``forward(mode="decode")``, or, where ``needs_unrolled_decode`` says the
caches are heterogeneous (gemma2's and hymba's smoke windows of 8), a
teacher-forced ``decode_unrolled`` whose ring buffers wrap, as
``tests/models/test_archs_smoke.py`` chooses.  Both sides decode the same
tokens (JAX's greedy choice), and the port's greedy choice must equal it.

Tolerances.  f32: logits within 1e-4 of their largest magnitude (the two
frameworks sum matrix products in another order, about 1e-7 relative an
operation, and the error scales with the hidden state: gemma2's embedding
scale of sqrt(d_model) makes its logits ~20 and its absolute errors
~2e-4); caches within 2e-5 of their largest magnitude.  bf16: the audio
frontend computes in bf16 whatever the params' dtype, and the JAX package
then cannot run f32 params at all (its layer scan refuses the f32 carry
that an f32 MLP makes of the bf16 one), so hubert-xlarge runs on bf16
params in both.  Its hidden states reach ~200, where one bf16 step is 1.0,
and XLA rounds them at other places than PyTorch (JAX's own op-by-op and
fused layer differ by that step), so it is held at the bf16 tolerance,
2e-2, as the norm of the difference over the norm of JAX's result.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as JAX_ARCH_IDS
from repro.configs import cell_list as jax_cell_list
from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke
from repro.models import transformer as jtfm
from repro.models.layers import init_params
from repro_torch.configs import (ARCH_IDS, cell_list, get_config,
                                 get_smoke_config)
from repro_torch.convert import from_jax_params
from repro_torch.models import transformer as ttfm

TOL = 1e-4        # f32 logits, of their largest magnitude
BF16_TOL = 2e-2   # hubert-xlarge, in norm
CAUSAL = [a for a in ARCH_IDS if a != "hubert-xlarge"]


def _models(cfg, seed=0):
    dtype = jnp.bfloat16 if cfg.frontend == "audio" else jnp.float32
    jp = init_params(jtfm.model_specs(cfg), jax.random.PRNGKey(seed),
                     dtype=dtype)
    return jp, from_jax_params(cfg, jax.tree.map(np.asarray, jp))


def _batch(cfg, B, S, seed=1):
    """(JAX batch, port batch) from one numpy generator."""
    rng = np.random.default_rng(seed)
    if cfg.frontend == "audio":
        b = {"features": rng.standard_normal((B, S, cfg.frontend_dim),
                                             dtype=np.float32),
             "mask": (rng.random((B, S)) < 0.3).astype(np.float32)}
    elif cfg.frontend == "vision":
        nv = cfg.n_vision_tokens
        b = {"tokens": rng.integers(0, cfg.vocab, (B, S - nv)),
             "vision": rng.standard_normal((B, nv, cfg.d_model),
                                           dtype=np.float32)}
    else:
        b = {"tokens": rng.integers(0, cfg.vocab, (B, S))}
    jb = {k: jnp.asarray(v, jnp.int32 if k == "tokens" else None)
          for k, v in b.items()}
    return jb, {k: torch.from_numpy(v) for k, v in b.items()}


def _close_scaled(out, ref, tol):
    """max |out - ref| <= tol * max |ref|."""
    ref = np.asarray(ref, np.float32)
    err = np.abs(out.float().numpy() - ref).max()
    assert err <= tol * np.abs(ref).max(), (err, np.abs(ref).max())


def _close_norm(out, ref, tol):
    """|out - ref| <= tol * |ref| in the Frobenius norm (bf16)."""
    ref = np.asarray(ref, np.float32)
    err = np.linalg.norm(out.float().numpy() - ref)
    assert err <= tol * np.linalg.norm(ref), (err, np.linalg.norm(ref))


def _close(cfg, out, ref, tol=TOL):
    if cfg.frontend == "audio":
        _close_norm(out, ref, BF16_TOL)
    else:
        _close_scaled(out, ref, tol)


# -- configs -----------------------------------------------------------------
def test_registry_holds_all_ten_archs():
    assert ARCH_IDS == JAX_ARCH_IDS and len(ARCH_IDS) == 10
    import repro_torch.configs.registry as reg
    assert not hasattr(reg, "NOT_PORTED")
    assert not hasattr(ttfm, "_unported")
    assert cell_list(ARCH_IDS, get_config) == \
        jax_cell_list(JAX_ARCH_IDS, jax_config)
    with pytest.raises(KeyError):
        get_config("llama-7b")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_configs_match_jax(arch):
    assert dataclasses.asdict(get_config(arch)) == \
        dataclasses.asdict(jax_config(arch))
    assert dataclasses.asdict(get_smoke_config(arch)) == \
        dataclasses.asdict(jax_smoke(arch))
    cut = get_config(arch, n_layers=2)
    assert cut.n_layers == 2 and cut.d_model == get_config(arch).d_model


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_counts_match_analytic(arch):
    """The port's init materialises param_count() parameters (tied
    embeddings once; vocab padding excluded), as the JAX package's test
    checks for its own."""
    cfg = get_smoke_config(arch)
    model = ttfm.init_model(cfg, seed=0, device="cpu", dtype=torch.float32)
    n = sum(p.numel() for p in model.parameters())
    pad = (cfg.vocab_padded - cfg.vocab) * cfg.d_model
    n -= pad * (1 if cfg.tie_embeddings else 2)
    expect = cfg.param_count()
    assert abs(n - expect) / expect < 0.02, f"{arch}: {n} vs {expect}"


def test_deepseek_v2_cut_to_six_layers_is_21_billion():
    """The card's main path: layer 0 dense and 5 MoE layers at full width."""
    cfg = get_config("deepseek-v2-236b", n_layers=6)
    assert cfg.param_count() == 21_247_127_552
    assert ttfm.n_scanned(cfg) == 5
    specs = ttfm.model_specs(cfg)
    assert set(specs["layer0"]) == {"ln1", "attn", "ln2", "mlp"}
    assert specs["layer0"]["mlp"]["wi"].shape == (5120, 12288)
    assert specs["layers"]["0"]["moe"]["we_i"].shape == (160, 5120, 1536)


# -- prefill and decode against the JAX package --------------------------------
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_prefill_matches_jax(arch):
    cfg = get_smoke_config(arch)
    jp, tp = _models(cfg)
    jb, tb = _batch(cfg, B=2, S=12)
    lj, cj, aj = jtfm.forward(jp, cfg, jb, mode="prefill")
    with torch.inference_mode():
        lt, ct, at = ttfm.forward(tp, cfg, tb, mode="prefill")
    V = cfg.vocab
    _close(cfg, lt[..., :V], np.asarray(lj, np.float32)[..., :V])
    assert set(ct) == set(cj)
    for k in cj:
        assert tuple(ct[k].shape) == cj[k].shape, k
        _close(cfg, ct[k], np.asarray(cj[k], np.float32), 2e-5)
    if cfg.n_experts:
        assert float(aj) > 0
        np.testing.assert_allclose(float(at), float(aj), rtol=1e-6)
    else:
        assert float(at) == float(aj) == 0.0


def _decode_uniform(cfg, jp, tp, jb, tb, B, S_ctx, S_max):
    lj, pj, _ = jtfm.forward(jp, cfg, jb, mode="prefill")
    with torch.inference_mode():
        lt, pt, _ = ttfm.forward(tp, cfg, tb, mode="prefill")
    jc = jtfm.init_cache(cfg, B, S_max, dtype=jnp.float32)
    tc = ttfm.init_cache(cfg, B, S_max, dtype=torch.float32, device="cpu")
    for k in jc:                      # place the prefill cache
        if k in ttfm.IN_PLACE:
            jc[k] = jc[k].at[:, :, :S_ctx].set(pj[k])
            tc[k][:, :, :S_ctx] = pt[k]
        else:
            jc[k] = pj[k].astype(jc[k].dtype)
            tc[k] = pt[k].to(tc[k].dtype)
    step = jax.jit(lambda p, tok, c, pos: jtfm.forward(
        p, cfg, {"tokens": tok}, mode="decode", cache=c, positions=pos,
        cache_len=pos + 1)[:2])
    steps = []
    for t in range(S_ctx, S_max):
        nxt = np.array(jnp.argmax(lj[:, -1], axis=-1))
        assert np.array_equal(lt[:, -1].argmax(-1).numpy(), nxt), t
        pos = np.full((B, 1), t, np.int32)
        lj, jc = step(jp, jnp.asarray(nxt[:, None], jnp.int32), jc,
                      jnp.asarray(pos))
        with torch.inference_mode():
            lt, tc, _ = ttfm.forward(
                tp, cfg, {"tokens": torch.from_numpy(nxt[:, None])},
                mode="decode", cache=tc, positions=torch.from_numpy(pos),
                cache_len=torch.from_numpy(pos + 1))
        steps.append((lt, lj))
    return steps, tc, jc


def _decode_unrolled(cfg, jp, tp, toks, B, S_max):
    """Teacher-forced over the prompt, then greedy, as the JAX smoke test
    does for heterogeneous caches."""
    jc = jtfm.init_cache_unrolled(cfg, B, S_max, dtype=jnp.float32)
    tc = ttfm.init_cache_unrolled(cfg, B, S_max, dtype=torch.float32,
                                  device="cpu")
    step = jax.jit(lambda p, tok, c, pos: jtfm.decode_unrolled(
        p, cfg, tok, c, pos))
    steps, nxt = [], None
    for t in range(S_max):
        tok = toks[:, t:t + 1] if t < toks.shape[1] else nxt[:, None]
        pos = np.full((B, 1), t, np.int32)
        lj, jc = step(jp, jnp.asarray(tok, jnp.int32), jc, jnp.asarray(pos))
        with torch.inference_mode():
            lt, tc = ttfm.decode_unrolled(tp, cfg, torch.from_numpy(tok), tc,
                                          torch.from_numpy(pos))
        nxt = np.array(jnp.argmax(lj[:, -1], axis=-1))
        assert np.array_equal(lt[:, -1].argmax(-1).numpy(), nxt), t
        steps.append((lt, lj))
    return steps, tc, jc


@pytest.mark.parametrize("arch", CAUSAL)
def test_decode_matches_jax(arch):
    cfg = get_smoke_config(arch)
    jp, tp = _models(cfg)
    B, S_ctx = 2, 8
    S_max = 20 if jtfm.needs_unrolled_decode(cfg, 20) else 12
    jb, tb = _batch(cfg, B, S_ctx)
    if ttfm.needs_unrolled_decode(cfg, S_max):
        steps, tc, jc = _decode_unrolled(cfg, jp, tp, np.asarray(jb["tokens"]),
                                         B, S_max)
        windows = [w for w in cfg.layer_windows() if 0 < w < S_max]
        assert windows and S_max > 2 * min(windows)     # rings wrap twice
        for lt_, lj_ in zip(tc["layers"], jc["layers"]):
            for k in lj_:
                if k == "pos":
                    np.testing.assert_array_equal(lt_[k].numpy(),
                                                  np.asarray(lj_[k]))
                else:
                    _close_scaled(lt_[k], lj_[k], 2e-5)
    else:
        steps, tc, jc = _decode_uniform(cfg, jp, tp, jb, tb, B, S_ctx, S_max)
        for k in jc:
            _close_scaled(tc[k], jc[k], 2e-5)
    assert len(steps) >= 4
    for lt, lj in steps:
        _close(cfg, lt[..., :cfg.vocab], np.asarray(lj)[..., :cfg.vocab])


@pytest.mark.parametrize("arch", ["gemma2-27b", "hymba-1.5b"])
def test_unrolled_decode_equals_uniform_decode(arch):
    """The ring buffers hold exactly the keys the window lets through: the
    unrolled path gives the uniform path's logits (its full cache masked by
    the window) at every position, on the port alone."""
    cfg = get_smoke_config(arch)
    model = ttfm.init_model(cfg, seed=3, device="cpu", dtype=torch.float32)
    B, S_max = 1, 24
    toks = torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg.vocab, (B, S_max)))
    ring = ttfm.init_cache_unrolled(cfg, B, S_max, dtype=torch.float32,
                                    device="cpu")
    full = ttfm.init_cache(cfg, B, S_max, dtype=torch.float32, device="cpu")
    assert min(lc["k"].shape[1] for lc in ring["layers"]) == cfg.window
    with torch.inference_mode():
        for t in range(S_max):
            pos = torch.full((B, 1), t, dtype=torch.int32)
            lr, ring = ttfm.decode_unrolled(model, cfg, toks[:, t:t + 1],
                                            ring, pos)
            lf, full, _ = ttfm.forward(model, cfg,
                                       {"tokens": toks[:, t:t + 1]},
                                       mode="decode", cache=full,
                                       positions=pos, cache_len=pos + 1)
            err = float((lr - lf)[..., :cfg.vocab].abs().max())
            assert err <= 1e-4 * float(lf[..., :cfg.vocab].abs().max()), t


def test_audio_model_runs_f32_params_where_jax_cannot():
    """A reference fault the port does not copy (ROADMAP queue 3): with
    f32 params the audio frontend's bf16 output meets an f32 MLP, which
    turns the layer's carry into f32, and JAX's layer scan refuses that.
    The port's layer loop takes the promotion: layer 0's attention runs in
    bf16, the rest in f32, and the logits are finite."""
    cfg = get_smoke_config("hubert-xlarge")
    jp = init_params(jtfm.model_specs(cfg), jax.random.PRNGKey(0),
                     dtype=jnp.float32)
    jb, tb = _batch(cfg, B=2, S=12)
    with pytest.raises(TypeError, match="carry"):
        jtfm.forward(jp, cfg, jb)
    tp = from_jax_params(cfg, jax.tree.map(np.asarray, jp))
    with torch.inference_mode():
        lt, _, _ = ttfm.forward(tp, cfg, tb)
    assert lt.dtype == torch.float32 and torch.isfinite(lt).all()
