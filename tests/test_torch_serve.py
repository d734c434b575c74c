"""The slice as a whole: the port's model and ServeEngine against the JAX
package's on the CPU.

Parameters are made by the JAX package in f32 and handed to the port by
``from_jax_params``; prompts come from a seeded numpy generator.  The JAX
side runs its XLA path (``attn_impl="xla"``), which honours sliding
windows and any sequence length.  The two frameworks sum matrix products
and scans in another order, so f32 results differ by about 1e-7 relative
per operation, and random weights grow activations layer by layer (the
SSM state reaches ~1e3).  Logit tolerance: 1e-4 absolute and relative.
Cache tolerance: 2e-5 of the tensor's largest magnitude.  Greedy tokens
must be identical.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.core.tracing import current_task
from repro.models import transformer as jtfm
from repro.models.layers import init_params
from repro.serve.engine import ServeEngine as JaxEngine
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.convert import from_jax_params
from repro_torch.launch import serve as launch_serve
from repro_torch.models import transformer as ttfm
from repro_torch.serve.engine import ServeEngine

TOL = 1e-4


def _cfg(arch="hymba-1.5b"):
    cfg = jax_smoke(arch)
    if arch == "hymba-1.5b":   # window >= max_len keeps the uniform cache
        cfg = dataclasses.replace(cfg, window=32)
    return cfg


def _models(cfg, seed=0):
    jp = init_params(jtfm.model_specs(cfg), jax.random.PRNGKey(seed),
                     dtype=jnp.float32)
    return jp, from_jax_params(cfg, jax.tree.map(np.asarray, jp))


def _close(out, ref):
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                               atol=TOL, rtol=TOL)


def _close_scaled(out, ref, tol=2e-5):
    ref = np.asarray(ref, np.float32)
    err = np.abs(out.float().numpy() - ref).max()
    assert err <= tol * np.abs(ref).max(), (err, np.abs(ref).max())


@pytest.fixture(scope="module")
def hymba():
    cfg = _cfg()
    return (cfg,) + _models(cfg)


@pytest.mark.parametrize("S", [16, 12, 40])   # whole chunks, ragged, > window
def test_prefill_logits_and_cache_match_xla(hymba, S):
    cfg, jp, tp = hymba
    toks = np.random.default_rng(S).integers(0, cfg.vocab, (1, S))
    lj, cj, _ = jtfm.forward(jp, cfg, {"tokens": jnp.asarray(toks, jnp.int32)},
                             mode="prefill")
    with torch.inference_mode():
        lt, ct, _ = ttfm.forward(tp, cfg, {"tokens": torch.as_tensor(toks)},
                                 mode="prefill")
    _close(lt[..., :cfg.vocab], np.asarray(lj)[..., :cfg.vocab])
    assert set(ct) == set(cj) == {"k", "v", "conv", "ssm"}
    for k in cj:
        assert tuple(ct[k].shape) == cj[k].shape
        _close_scaled(ct[k], cj[k])


def test_train_logits_match(hymba):
    cfg, jp, tp = hymba
    toks = np.random.default_rng(3).integers(0, cfg.vocab, (2, 24))
    lj, _, _ = jtfm.forward(jp, cfg, {"tokens": jnp.asarray(toks, jnp.int32)})
    with torch.inference_mode():
        lt, cache, _ = ttfm.forward(tp, cfg,
                                    {"tokens": torch.as_tensor(toks)})
    assert cache is None
    _close(lt[..., :cfg.vocab], np.asarray(lj)[..., :cfg.vocab])


def test_sliding_window_reaches_prefill(hymba):
    """A prompt longer than the window: the windowed layer differs from
    full attention, and the port follows the XLA path, not the Pallas
    path's full attention."""
    cfg, jp, tp = hymba
    assert cfg.layer_windows()[1] == cfg.window
    toks = torch.as_tensor(np.random.default_rng(9).integers(0, cfg.vocab,
                                                             (1, 48)))
    full = dataclasses.replace(cfg, window=0)
    with torch.inference_mode():
        lw, _, _ = ttfm.forward(tp, cfg, {"tokens": toks})
        lf, _, _ = ttfm.forward(tp, full, {"tokens": toks})
    assert torch.equal(lw[:, :cfg.window], lf[:, :cfg.window])
    assert not torch.allclose(lw[:, cfg.window:], lf[:, cfg.window:])


@pytest.mark.parametrize("arch", ["hymba-1.5b", "stablelm-1.6b",
                                  "mamba2-130m", "deepseek-v2-236b",
                                  "grok-1-314b"])
def test_serve_engine_tokens_identical_to_jax(arch):
    """Greedy continuous batching, 3 requests on 2 slots (one waits for a
    free slot).  With f32 weights the top-2 logit gaps of these seeded
    runs are far above the 1e-4 logit agreement, so tokens must match.
    deepseek-v2 admits into the MLA latent cache (``ckv``/``kr``) and
    decodes against it in absorbed form; both MoE archs route and drop
    by capacity at every step, as the JAX engine does."""
    cfg = _cfg(arch)
    jp, tp = _models(cfg, seed=1)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, n).tolist() for n in (5, 12, 16)]
    outs = []
    for engine, params in ((JaxEngine, jp), (ServeEngine, tp)):
        eng = engine(cfg, params, max_batch=2, max_len=32)
        for p in prompts:
            eng.submit(p, max_new=6)
        done = eng.run_until_idle()
        assert eng.step() == []          # idle: no device work
        outs.append({r.rid: r.out for r in done})
    assert outs[1] == outs[0]
    assert all(len(o) == 6 for o in outs[1].values())


def test_engine_cache_layout_and_dtypes(hymba):
    cfg, _, tp = hymba
    eng = ServeEngine(cfg, tp, max_batch=2, max_len=32)
    L = cfg.n_layers
    assert eng.cache["k"].shape == (L, 2, 32, cfg.n_kv_heads, cfg.head_dim)
    assert eng.cache["k"].dtype == torch.bfloat16    # even with f32 params
    assert eng.cache["conv"].dtype == torch.bfloat16
    assert eng.cache["ssm"].dtype == torch.float32
    with pytest.raises(ValueError):
        ServeEngine(dataclasses.replace(cfg, window=8), tp, max_len=32)
    with pytest.raises(ValueError):
        eng.submit(list(range(32)))


def test_launch_serve_needs_cuda_unless_cpu(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        launch_serve.main(["--arch", "hymba-1.5b"])
    done = launch_serve.main(["--arch", "stablelm-1.6b", "--smoke",
                              "--device", "cpu", "--max-new", "3",
                              "--prompts", "hi", "there"])
    assert [len(r.out) for r in done] == [3, 3]
    assert "'hi' ->" in capsys.readouterr().out


def test_unported_archs_raise_and_ported_configs_match():
    """Every arch id of the JAX registry resolves in the port; the one
    refusal left is an unknown id's.  (The name dates from when seven of
    the ten ids were still refused.)"""
    for arch in ("deepseek-v2-236b", "gemma2-27b", "hubert-xlarge",
                 "internvl2-26b"):
        assert get_config(arch).name == arch
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("llama-7b")
    hymba = get_config("hymba-1.5b")
    assert (hymba.n_layers, hymba.d_model, hymba.n_heads, hymba.n_kv_heads,
            hymba.d_ff, hymba.n_ssm_heads, hymba.vocab_padded) == \
        (32, 1600, 25, 5, 5504, 50, 32256)
    assert not ttfm.needs_unrolled_decode(hymba, 512)
    assert get_smoke_config("mamba2-130m").ssm_chunk == 8


def test_engine_admits_into_the_mla_latent_cache():
    """The slot engine's cache for an MLA model is the latent one, [L, B,
    S, kv_lora] and [L, B, S, rope]; admission writes a prompt's latents
    along the sequence, and decode writes the next position in place."""
    cfg = _cfg("deepseek-v2-236b")
    _, tp = _models(cfg)
    eng = ServeEngine(cfg, tp, max_batch=2, max_len=16)
    assert set(eng.cache) == {"ckv", "kr"}
    assert eng.cache["ckv"].shape == (cfg.n_layers, 2, 16, cfg.kv_lora)
    assert eng.cache["kr"].shape == (cfg.n_layers, 2, 16, cfg.qk_rope_dim)
    ckv = eng.cache["ckv"]
    eng.submit([3, 1, 4, 1, 5], max_new=3)
    eng.step()                                   # admit (5) + one decode
    assert eng.cache["ckv"] is ckv               # updated in place
    # the idle slot 1 rides along at position 0, as in the JAX engine
    written = ckv[:, 1].abs().sum(-1) != 0
    assert not written[:, 1:].any()
    filled = (ckv[:, 0].abs().sum(-1) != 0).sum(-1)
    assert filled.tolist() == [6] * cfg.n_layers


def test_vision_model_serves_text_prompts():
    """A reference fault the port does not copy: the JAX ServeEngine
    prefills with tokens alone, which the JAX ``embed_inputs`` of a vision
    model refuses (KeyError 'vision').  The port embeds a text-only batch
    as text; with no vision tokens the model is the same function as its
    text-only config, and the JAX package computes that one."""
    cfg = jax_smoke("internvl2-26b")
    jp, tp = _models(cfg, seed=2)
    with pytest.raises(KeyError, match="vision"):
        eng = JaxEngine(cfg, jp, max_batch=1, max_len=16)
        eng.submit([1, 2, 3], max_new=2)
        eng.run_until_idle()
    # the raise leaves the request's task open on the JAX package's
    # thread-local task stack, where a later test in this process would
    # take it as its parent: end it
    left = current_task()
    assert left is not None and left.category == "request"
    eng.dom.end_task(left)
    assert current_task() is None
    text = dataclasses.replace(cfg, frontend="none")
    toks = np.random.default_rng(4).integers(0, cfg.vocab, (1, 9))
    lj, _, _ = jtfm.forward(jp, text, {"tokens": jnp.asarray(toks, jnp.int32)},
                            mode="prefill")
    with torch.inference_mode():
        lt, _, _ = ttfm.forward(tp, cfg, {"tokens": torch.as_tensor(toks)},
                                mode="prefill")
    _close(lt[..., :cfg.vocab], np.asarray(lj)[..., :cfg.vocab])
    outs = []
    for engine, params, c in ((JaxEngine, jp, text), (ServeEngine, tp, cfg)):
        eng = engine(c, params, max_batch=2, max_len=24)
        for n in (5, 9):
            eng.submit(toks[0, :n].tolist(), max_new=4)
        outs.append({r.rid: r.out for r in eng.run_until_idle()})
    assert outs[1] == outs[0]


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "gemma2-27b",
                                  "internvl2-26b"])
def test_launch_serve_runs_new_causal_archs(arch, capsys):
    done = launch_serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                              "--max-new", "2", "--max-len", "8",
                              "--prompts", "hi"])
    assert [len(r.out) for r in done] == [2]
    assert "'hi' ->" in capsys.readouterr().out


def test_launch_serve_refuses_encoder_only():
    with pytest.raises(ValueError, match="encoder-only"):
        launch_serve.main(["--arch", "hubert-xlarge", "--smoke",
                           "--device", "cpu"])


def test_from_jax_params_bf16():
    cfg = _cfg()
    jp = init_params(jtfm.model_specs(cfg), jax.random.PRNGKey(2))
    tp = from_jax_params(cfg, jax.tree.map(np.asarray, jp))
    assert tp.final_norm.dtype == torch.bfloat16
    wq = np.asarray(jp["layers"]["attn"]["wq"][1].astype(jnp.float32))
    np.testing.assert_array_equal(tp.layers[1]["attn"]["wq"].float().numpy(),
                                  wq)
