"""The port's training path against the JAX package, on the CPU.

One ``make_train_step`` step of every smoke config (cut to 2 layers, so
MoE's aux loss, MLA, the dense layer 0, gemma2's and grok's softcaps over
a padded vocab, and the audio and vision branches all take part) from the
reference's own parameters and AdamW state (made from a seeded numpy
generator, handed over by ``convert``), on a batch of the reference's
``synthetic_batch``.  Loss, gnorm, every gradient leaf and every updated
parameter are held against ``repro.train.step.make_train_step``.

Tolerances.  f32: loss within 1e-5 and gnorm within 1e-4 relative;
every gradient leaf within 2e-4 of the largest |g| of the whole tree
(the frameworks sum in other orders, and a gradient sums over every
position: internvl2's ``ln1`` is the worst, at 1.13e-4; gnorm 2.8e-5,
stablelm).  bf16 (the
reference's default init dtype; hubert-xlarge always, since the JAX
package cannot run its audio frontend on f32 params): loss within 2e-2
and gnorm within 5%, the bars of the JAX package's own grad-accumulation
test.  bf16 gradients of the two packages differ by 2.6-17% in norm
(hymba to internvl2), because the two frameworks round activations to
bf16 at other places; each is as far from the f32 gradient of the same
(bf16-valued) parameters (3-68%), so the port's bf16 gradient is held no
farther from that f32 gradient (the port's, which matches JAX's f32 at
1e-4) than 1.5 times the JAX package's distance (the ratio 1.27 at most,
hubert).  Since that bar passes a zero gradient where JAX's distance is
large (internvl2's 0.63), the port's bf16 gradient is also held against
JAX's bf16 gradient itself: within 0.25 in norm over the whole tree
(0.171 at most, internvl2) and within 0.3 of each leaf's norm (0.207 at
most, internvl2's ``wk``); a leaf that JAX gives a zero gradient is zero
in the port too.  Updated parameters:
AdamW's first step is ``g / (|g| + eps)``, a sign, so where a gradient is
within rounding of 0 the two packages can move a parameter by +lr and
-lr.  Each parameter is held within ``2 lr`` (plus, in bf16, each side's
rounding: half a bf16 step of its value), and the elements that differ
by more than 1e-6 are
counted: at most 1% of them in f32 (0.67% at most, phi3-medium), 5% in
bf16 (2.6% at most, deepseek-v2).

Then the loop's behaviour, as ``tests/test_train_loop.py`` pins the
reference's: micro-batches 1, 2 and 4 agree; ``train`` lowers the loss;
kill and resume is bit-exact; SIGTERM drains and saves; ``remat`` none,
block and dots give equal gradients; ``launch.train`` runs on the CPU.
And port faults P2-P4 (ROADMAP.md queue 3), each with its test.
"""
import dataclasses
import math
import os
import signal
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS
from repro.configs import get_smoke_config as jax_smoke
from repro.data import synthetic_batch
from repro.models import transformer as jtfm
from repro.models.layers import PSpec
from repro.optim import adamw_init as jax_adamw_init
from repro.train.step import TrainHParams as JaxHParams
from repro.train.step import make_train_step as jax_make_train_step
from repro_torch.ckpt import list_steps
from repro_torch.configs import get_smoke_config
from repro_torch.convert import (from_jax_opt_state, from_jax_params,
                                 to_jax_tree)
from repro_torch.data import DataPipeline
from repro_torch.kernels.flash_attention import autograd as fa_autograd
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.ssd import autograd as ssd_autograd
from repro_torch.kernels.ssd import kernel as ssd_kernel
from repro_torch.kernels.ssd.ref import ssd_chunked
from repro_torch.models import transformer as tfm
from repro_torch.optim import adamw_init
from repro_torch.serve.engine import ServeEngine
from repro_torch.train.loop import LoopConfig, train
from repro_torch.train.step import (TrainHParams, make_train_step,
                                    value_and_grad)

from _torch_sim_parity import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
LR = 1e-2
BARS = {"float32": dict(loss=1e-5, gnorm=1e-4, grad=2e-4, moved=0.01),
        "bfloat16": dict(loss=2e-2, gnorm=0.05, truth=1.5, cross=0.25,
                         leaf=0.3, moved=0.05)}
CASES = [(a, d) for a in ARCH_IDS for d in BARS
         if not (a == "hubert-xlarge" and d == "float32")]


def _np_params(cfg, seed, dtype):
    """The reference's parameter tree from a seeded numpy generator (its
    init's distributions: N(0, 1) times the spec's scale, zeros, ones)."""
    rng = np.random.default_rng(seed)

    def one(ps):
        if ps.init == "zeros":
            a = np.zeros(ps.shape, np.float32)
        elif ps.init == "ones":
            a = np.ones(ps.shape, np.float32)
        else:
            s = ps.scale if ps.scale is not None else \
                1.0 / math.sqrt(max(ps.shape[0], 1))
            a = rng.standard_normal(ps.shape, dtype=np.float32) * \
                np.float32(s)
        return jnp.asarray(a).astype(dtype)
    return jax.tree.map(one, jtfm.model_specs(cfg),
                        is_leaf=lambda x: isinstance(x, PSpec))


def _norm_rel(a, b):
    """|a - b| / |b| over all leaves of two lists of arrays."""
    return math.sqrt(sum(float(((x - y) ** 2).sum()) for x, y in zip(a, b))
                     / sum(float((y ** 2).sum()) for y in b))


def _leafwise(got_tree, ref_tree):
    """[(path, port leaf as f32 numpy, reference leaf as f32 numpy)]."""
    out = []
    for path, r in jax.tree_util.tree_leaves_with_path(ref_tree):
        g = got_tree
        for k in path:
            g = g[k.key]
        out.append((path, g, np.asarray(r, np.float32)))
    return out


@pytest.mark.parametrize("arch,dname", CASES)
def test_train_step_matches_jax(arch, dname):
    jcfg = dataclasses.replace(jax_smoke(arch), n_layers=2)
    cfg = dataclasses.replace(get_smoke_config(arch), n_layers=2)
    audio = cfg.frontend == "audio"
    jdt = jnp.bfloat16 if (dname == "bfloat16" or audio) else jnp.float32
    jp = _np_params(jcfg, 0, jdt)
    jo = jax_adamw_init(jp)
    b = synthetic_batch(jcfg, 4, 16, seed=0, step=0)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    step = jax_make_train_step(jcfg, JaxHParams(lr=LR, donate=False))

    def grads_and_step(p, o, batch):
        g = jax.grad(lambda p: jtfm.train_loss(p, jcfg, batch))(p)
        return g, step(p, o, batch)
    jg, (jl, jgn, jp2, _) = jax.jit(grads_and_step)(jp, jo, jb)

    model = from_jax_params(cfg, jax.tree.map(np.asarray, jp),
                            requires_grad=True)
    opt = from_jax_opt_state(cfg, jax.tree.map(np.asarray, jo))
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    loss, grads = value_and_grad(cfg, model, tb)
    bars = BARS[dname]
    pairs = _leafwise(to_jax_tree(cfg, grads), jg)
    if dname == "float32":
        gmax = max(np.abs(r).max() for _, _, r in pairs)
        for path, g, r in pairs:
            assert np.abs(g - r).max() <= bars["grad"] * gmax, path
    else:
        m32 = from_jax_params(cfg, jax.tree.map(np.asarray, jp),
                              requires_grad=True).float()
        truth = _leafwise(to_jax_tree(cfg, value_and_grad(cfg, m32, tb)[1]),
                          jg)
        t = [x for _, x, _ in truth]
        g, r = [g for _, g, _ in pairs], [r for _, _, r in pairs]
        assert _norm_rel(g, t) <= bars["truth"] * _norm_rel(r, t)
        assert _norm_rel(g, r) <= bars["cross"]
        for path, g, r in pairs:
            if not np.any(r):
                assert not np.any(g), path
            else:
                assert _norm_rel([g], [r]) <= bars["leaf"], path

    loss2, gnorm, model, _ = make_train_step(
        cfg, TrainHParams(lr=LR))(model, opt, tb)
    assert float(loss2) == float(loss)
    assert abs(float(loss) - float(jl)) <= bars["loss"] * (
        abs(float(jl)) if dname == "float32" else 1.0)
    assert abs(float(gnorm) - float(jgn)) <= bars["gnorm"] * float(jgn)
    moved = total = 0
    for path, p, r in _leafwise(to_jax_tree(cfg, tfm.param_tree(model)),
                                jp2):
        d = np.abs(p - r)
        tol = 2 * LR * 1.001         # a sign flip; in bf16 each side's
        if jdt == jnp.bfloat16:      # rounding too, half a step of its value
            tol = tol + (np.abs(p) + np.abs(r)) * 2.0 ** -8
        assert (d <= tol).all(), path
        moved += int((d > 1e-6).sum())
        total += d.size
    assert moved <= bars["moved"] * total, (moved, total)


def _tiny_cfg():
    return dataclasses.replace(get_smoke_config("stablelm-1.6b"),
                               n_layers=2, d_model=32, n_heads=2,
                               n_kv_heads=2, head_dim=16, d_ff=64, vocab=64)


def _data(cfg):
    return DataPipeline(cfg, batch=4, seq=16, seed=0)


def _loop(path, steps, every=100):
    return LoopConfig(steps=steps, ckpt_every=every, ckpt_dir=str(path),
                      log_every=1000)


def test_grad_accumulation_matches_full_batch():
    cfg = _tiny_cfg()
    batch = {k: torch.from_numpy(v) for k, v in _data(cfg)(0).items()}
    outs = []
    for mb in (1, 2, 4):
        model = tfm.init_model(cfg, 0, device="cpu", requires_grad=True)
        opt = adamw_init(tfm.param_tree(model))
        loss, gnorm, _, _ = make_train_step(
            cfg, TrainHParams(lr=1e-2, micro_batches=mb))(
                model, opt, batch)
        outs.append((float(loss), float(gnorm)))
    for l, g in outs[1:]:
        assert abs(l - outs[0][0]) < 2e-2
        assert abs(g - outs[0][1]) / outs[0][1] < 0.05


def test_loss_decreases(tmp_path):
    cfg = _tiny_cfg()
    _, _, hist = train(cfg, _data(cfg), _loop(tmp_path, 30),
                       TrainHParams(lr=1e-2), device="cpu")
    first = np.mean([h["loss"] for h in hist[:5]])
    last = np.mean([h["loss"] for h in hist[-5:]])
    assert last < first - 0.1, (first, last)


def test_kill_resume_bit_exact(tmp_path):
    cfg = _tiny_cfg()
    hp = TrainHParams(lr=1e-2)
    pa, oa, _ = train(cfg, _data(cfg), _loop(tmp_path / "a", 20), hp,
                      device="cpu")
    train(cfg, _data(cfg), _loop(tmp_path / "b", 10, every=10), hp,
          device="cpu")
    pb, ob, hist = train(cfg, _data(cfg), _loop(tmp_path / "b", 20), hp,
                         device="cpu")
    assert [h["step"] for h in hist] == list(range(10, 20))
    for a, b in zip(pa.parameters(), pb.parameters()):
        assert torch.equal(a, b)
    assert torch.equal(oa["count"], ob["count"])


def test_sigterm_drains_and_saves(tmp_path):
    cfg = _tiny_cfg()
    data = _data(cfg)

    def data_fn(step):
        if step == 3:             # arrives while step 3 is in flight
            os.kill(os.getpid(), signal.SIGTERM)
        return data(step)

    before = signal.getsignal(signal.SIGTERM)
    _, opt, hist = train(cfg, data_fn, _loop(tmp_path, 50),
                         TrainHParams(lr=1e-2), device="cpu")
    assert [h["step"] for h in hist] == [0, 1, 2, 3]
    assert list_steps(str(tmp_path)) == [3]
    assert int(opt["count"]) == 4
    assert signal.getsignal(signal.SIGTERM) is before


def test_remat_modes_give_equal_gradients():
    """hymba's smoke config runs both kernel Functions; block recomputes
    every layer, dots keeps the matmul outputs and recomputes the rest."""
    base = get_smoke_config("hymba-1.5b")
    tb = {k: torch.from_numpy(v)
          for k, v in DataPipeline(base, batch=2, seq=16)(0).items()}
    grads = {}
    for remat in ("none", "block", "dots"):
        cfg = dataclasses.replace(base, remat=remat)
        model = tfm.init_model(cfg, 1, device="cpu", dtype=torch.float32,
                               requires_grad=True)
        _, g = value_and_grad(cfg, model, tb)
        grads[remat] = to_jax_tree(cfg, g)
    for remat in ("block", "dots"):
        for a, b in zip(jax.tree.leaves(grads["none"]),
                        jax.tree.leaves(grads[remat])):
            np.testing.assert_array_equal(a, b)


def test_launch_train_runs_on_the_cpu(tmp_path):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "hymba-1.5b", "--smoke", "--device", "cpu", "--steps", "3",
         "--batch", "2", "--seq", "16", "--ckpt", str(tmp_path),
         "--no-resume"], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("arch=hymba-1.5b-smoke params=")
    assert "done: loss" in out.stdout and "(3 steps this process)" in \
        out.stdout
    assert list_steps(str(tmp_path)) == [2]


# --- port faults P2-P4 ------------------------------------------------------
def test_p2_params_take_gradients_and_serving_builds_no_graph():
    # a window past max_len keeps the engine's uniform cache
    cfg = dataclasses.replace(get_smoke_config("hymba-1.5b"), window=64)
    model = tfm.init_model(cfg, 0, device="cpu", dtype=torch.float32,
                           requires_grad=True)
    assert all(p.requires_grad for p in model.parameters())
    assert not any(p.requires_grad for p in
                   tfm.init_model(cfg, 0, device="cpu").parameters())
    seen = []
    orig = tfm.forward

    def spy(*a, **kw):
        out = orig(*a, **kw)
        seen.append(out[0].requires_grad or out[0].grad_fn is not None)
        return out
    tfm.forward = spy
    try:
        eng = ServeEngine(cfg, model, max_batch=2, max_len=32)
        eng.submit([1, 2, 3, 4, 5], max_new=4)
        assert len(eng.run_until_idle()) == 1
    finally:
        tfm.forward = orig
    assert seen and not any(seen)
    assert all(p.grad is None for p in model.parameters())


def test_p3_card_entries_carry_the_gradient(monkeypatch):
    """On a card tensor that requires grad, each entry goes through its
    Function: the launcher is replaced by a stand-in that, like the
    ctypes launch, returns a result without a graph, and every tensor is
    routed as if it were on the card.  The gradients still equal the
    plain path's, and the launches are two a layer (forward and the
    block remat's recompute)."""
    cfg = get_smoke_config("hymba-1.5b")
    tb = {k: torch.from_numpy(v)
          for k, v in DataPipeline(cfg, batch=2, seq=16)(0).items()}
    model = tfm.init_model(cfg, 2, device="cpu", dtype=torch.float32,
                           requires_grad=True)
    _, plain = value_and_grad(cfg, model, tb)
    calls = {"fa": 0, "ssd": 0}

    def fake_fa(q, k, v, **kw):
        calls["fa"] += 1
        with torch.no_grad():
            return flash_attention_ref(q, k, v, **kw)

    def fake_ssd(xs, dt, A, B_, C_, chunk=128):
        calls["ssd"] += 1
        with torch.no_grad():
            return ssd_chunked(xs, dt, A, B_, C_, chunk)
    q = torch.ones(1, 4, 2, 8, requires_grad=True)
    assert fake_fa(q, q, q).grad_fn is None     # a launch has no graph
    calls["fa"] = 0
    for mod in (fa_autograd, ssd_autograd):
        monkeypatch.setattr(mod, "on_card", lambda t: True)
    monkeypatch.setattr(fa_kernel, "flash_attention", fake_fa)
    monkeypatch.setattr(ssd_kernel, "ssd", fake_ssd)
    _, card = value_and_grad(cfg, model, tb)
    assert calls == {"fa": 2 * cfg.n_layers, "ssd": 2 * cfg.n_layers}
    for a, b in zip(jax.tree.leaves(to_jax_tree(cfg, plain)),
                    jax.tree.leaves(to_jax_tree(cfg, card))):
        np.testing.assert_array_equal(a, b)
    for name in ("wq", "wk", "wv"):
        assert card["layers"]["0"]["attn"][name].abs().max() > 0
    for name in ("A_log", "dt_bias", "in_proj"):
        assert card["layers"]["0"]["ssm"][name].abs().max() > 0


def test_p4_unused_leaf_decays_as_in_jax():
    """hubert's ``embed.tok`` is not on its loss's path: JAX gives it a
    zero gradient, so AdamW decays it and its moments stay 0.  (lr 0.1:
    a decay of 1% shows in bf16, where 0.1% would round away.)"""
    lr = 0.1
    jcfg = dataclasses.replace(jax_smoke("hubert-xlarge"), n_layers=2)
    cfg = dataclasses.replace(get_smoke_config("hubert-xlarge"), n_layers=2)
    jp = _np_params(jcfg, 0, jnp.bfloat16)
    jo = jax_adamw_init(jp)
    b = synthetic_batch(jcfg, 2, 16, seed=1, step=0)
    _, _, jp2, jo2 = jax.jit(jax_make_train_step(
        jcfg, JaxHParams(lr=lr, donate=False)))(
            jp, jo, {k: jnp.asarray(v) for k, v in b.items()})
    model = from_jax_params(cfg, jax.tree.map(np.asarray, jp),
                            requires_grad=True)
    opt = from_jax_opt_state(cfg, jax.tree.map(np.asarray, jo))
    _, grads = value_and_grad(cfg, model, {k: torch.from_numpy(v)
                                           for k, v in b.items()})
    assert not grads["embed"]["tok"].any()
    _, _, model, opt = make_train_step(cfg, TrainHParams(lr=lr))(
        model, opt, {k: torch.from_numpy(v) for k, v in b.items()})
    tok = model.embed.tok.detach()
    np.testing.assert_array_equal(tok.float().numpy(),
                                  np.asarray(jp2["embed"]["tok"], np.float32))
    before = np.asarray(jp["embed"]["tok"], np.float32)
    assert (tok.float().numpy() != before).mean() > 0.9
    for k in ("m", "v"):
        assert not opt[k]["embed"]["tok"].any()
        assert not np.asarray(jo2[k]["embed"]["tok"]).any()


# --- convert ----------------------------------------------------------------
@pytest.mark.parametrize("moments", ["float32", "int8"])
def test_opt_state_converts_per_layer(moments):
    jcfg = dataclasses.replace(jax_smoke("hymba-1.5b"), n_layers=3)
    cfg = dataclasses.replace(get_smoke_config("hymba-1.5b"), n_layers=3)
    jp = _np_params(jcfg, 4, jnp.float32)
    rng = np.random.default_rng(9)
    m = jax.tree.map(lambda p: jnp.asarray(
        rng.standard_normal(p.shape, dtype=np.float32)), jp)
    from repro.optim.adamw import _q8 as jax_q8
    state = {"m": m, "v": m, "count": jnp.int32(7)}
    if moments == "int8":
        q8 = jax.tree.map(lambda a: dict(zip(("q", "s"), jax_q8(a))), m)
        state = {"m": q8, "v": q8, "count": jnp.int32(7)}
    opt = from_jax_opt_state(cfg, jax.tree.map(np.asarray, state))
    assert opt["count"].dtype == torch.int32 and int(opt["count"]) == 7
    if moments == "float32":
        for a, b in zip(jax.tree.leaves(to_jax_tree(cfg, opt["m"])),
                        jax.tree.leaves(m)):
            np.testing.assert_array_equal(a, np.asarray(b))
        return
    from repro_torch.optim.adamw import _dq8
    for i in range(3):
        for name, per in opt["m"]["layers"][str(i)]["ssm"].items():
            full = np.asarray(m["layers"]["ssm"][name])[i]
            got = _dq8(per["q"], per["s"], full.shape).numpy()
            step = np.abs(full).max() / 127
            assert np.abs(got - full).max() <= step, name
    # in_proj (64 x 208 a layer) owns whole blocks: sliced exactly
    q = opt["m"]["layers"]["1"]["ssm"]["in_proj"]["q"]
    nb = q.shape[0]
    np.testing.assert_array_equal(
        q.numpy(), np.asarray(state["m"]["layers"]["ssm"]["in_proj"]["q"])
        [nb:2 * nb])
