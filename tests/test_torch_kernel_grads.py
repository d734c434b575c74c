"""Gradients through the port's two kernel Functions, on the CPU.

``FlashAttentionFn`` and ``SSDFn`` (``repro_torch/kernels/*/autograd.py``)
carry the gradient through the hand-written kernels: the forward is the
kernel (on the CPU, the plain version without a graph), the backward the
plain version's autograd.  Here (1) ``torch.autograd.gradcheck`` in f64
holds each Function's backward against finite differences of its own
forward (causal or not, sliding window, softcap, GQA, ragged S), (2) both
Functions' gradients equal ``jax.grad`` of the JAX package's
``blockwise_attention`` and ``ssd_chunked`` on the same seeded numpy
inputs, within 1e-5 of the largest gradient (f32; both sides compute the
same blockwise sums in another order), and (3) a ``None`` gradient for
the SSD state works.  The CUDA kernels' forward inside these Functions is
held on the card by ``chip_smoke.py`` phase 10a.

On the card, bf16 gradients of ``FlashAttentionFn`` come from a backward
kernel; its plain counterpart, ``flash_attention_bwd_ref`` (the same
algebra from the forward's log-sum-exp, ``attention_lse_ref``), is held
here against autograd of the plain version in f64 and against
``jax.grad`` of the JAX package's ``blockwise_attention`` in f32, and
the Function is shown to keep the plain autograd on the CPU.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.attention import blockwise_attention as jax_blockwise
from repro.models.ssm import ssd_chunked as jax_ssd_chunked
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.autograd import FlashAttentionFn
from repro_torch.kernels.flash_attention import autograd as fa_autograd
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention.ref import (attention_lse_ref,
                                                     flash_attention_bwd_ref,
                                                     flash_attention_ref)
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.kernels.ssd.autograd import SSDFn
from repro_torch.kernels.ssd.ref import ssd_chunked

from _torch_sim_parity import one_torch_thread  # noqa: F401

GRAD_TOL = 1e-5   # f32, of the largest |grad|

FA_CASES = [  # B, S, H, KV, hd, causal, window, cap
    (1, 10, 2, 2, 8, True, 0, 0.0),
    (1, 9, 4, 2, 8, False, 0, 0.0),       # bidirectional, GQA, ragged
    (2, 11, 4, 1, 4, True, 4, 0.0),       # sliding window, MQA
    (1, 8, 2, 2, 8, True, 0, 5.0),        # softcap
    (1, 12, 4, 2, 4, True, 5, 3.0),       # window + softcap + GQA
]
SSD_CASES = [  # B, S, H, P, N, chunk
    (1, 8, 2, 3, 4, 4),
    (1, 11, 2, 2, 3, 4),                  # ragged last chunk
    (2, 6, 1, 2, 2, 8),                   # one partial chunk
]


def _qkv(B, S, H, KV, hd, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, H, hd), dtype=np.float32),
            rng.standard_normal((B, S, KV, hd), dtype=np.float32),
            rng.standard_normal((B, S, KV, hd), dtype=np.float32))


def _ssd_inputs(B, S, H, P, N, seed=0):
    rng = np.random.default_rng(seed)
    xs = rng.standard_normal((B, S, H, P), dtype=np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H), dtype=np.float32)
                         - 1.0)).astype(np.float32)
    A = (-np.exp(rng.standard_normal(H, dtype=np.float32) * 0.3)) \
        .astype(np.float32)
    B_ = rng.standard_normal((B, S, N), dtype=np.float32)
    C_ = rng.standard_normal((B, S, N), dtype=np.float32)
    return xs, dt, A, B_, C_


def _leaf(a, dtype=torch.float64):
    return torch.from_numpy(a).to(dtype).requires_grad_()


def _close_scaled(got, ref, tol):
    """Every gradient within ``tol`` of the largest |ref| of all."""
    scale = max(float(np.abs(np.asarray(r)).max()) for r in ref)
    for g, r in zip(got, ref):
        err = np.abs(g.detach().float().numpy() - np.asarray(r)).max()
        assert err <= tol * scale, (err, tol * scale)


@pytest.mark.parametrize("B,S,H,KV,hd,causal,window,cap", FA_CASES)
def test_flash_fn_gradcheck_f64(B, S, H, KV, hd, causal, window, cap):
    q, k, v = (_leaf(a) for a in _qkv(B, S, H, KV, hd))
    assert torch.autograd.gradcheck(
        lambda q, k, v: FlashAttentionFn.apply(q, k, v, causal, window, cap,
                                               None),
        (q, k, v), eps=1e-6, atol=1e-7, rtol=1e-5)


@pytest.mark.parametrize("B,S,H,P,N,chunk", SSD_CASES)
def test_ssd_fn_gradcheck_f64(B, S, H, P, N, chunk):
    ins = [_leaf(a) for a in _ssd_inputs(B, S, H, P, N)]
    assert torch.autograd.gradcheck(
        lambda *a: SSDFn.apply(*a, chunk), ins, eps=1e-6, atol=1e-7,
        rtol=1e-5)


def _loss_weights(shape, seed=3):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


@pytest.mark.parametrize("B,S,H,KV,hd,causal,window,cap",
                         FA_CASES + [(1, 1040, 2, 1, 8, True, 300, 0.0)])
def test_flash_fn_grads_match_jax(B, S, H, KV, hd, causal, window, cap):
    """S=1040 takes the blockwise branch (keys in chunks of 1024)."""
    arrs = _qkv(B, S, H, KV, hd, seed=1)
    w = _loss_weights((B, S, H, hd))
    pos = jnp.broadcast_to(jnp.arange(S), (B, S))

    def jloss(q, k, v):
        o = jax_blockwise(q, k, v, pos, pos, causal=causal, window=window,
                          cap=cap)
        return jnp.sum(o * w) + 0.5 * jnp.sum(o * o)

    ref = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(
        *map(jnp.asarray, arrs))
    q, k, v = (_leaf(a, torch.float32) for a in arrs)
    o = fa_ops.flash_attention(q, k, v, None, None, causal=causal,
                               window=window, cap=cap)
    (torch.sum(o * torch.from_numpy(w)) + 0.5 * torch.sum(o * o)).backward()
    _close_scaled([q.grad, k.grad, v.grad], ref, GRAD_TOL)


@pytest.mark.parametrize("B,S,H,P,N,chunk", [(1, 16, 2, 4, 4, 8),
                                             (2, 32, 3, 8, 4, 8)])
def test_ssd_fn_grads_match_jax(B, S, H, P, N, chunk):
    """Both outputs in the loss; S a multiple of the chunk, which the JAX
    package's ``ssd_chunked`` asserts."""
    arrs = _ssd_inputs(B, S, H, P, N, seed=2)
    wy = _loss_weights((B, S, H, P))
    wh = _loss_weights((B, H, P, N), seed=4)

    def jloss(*a):
        y, h = jax_ssd_chunked(*a, chunk)
        return jnp.sum(y * wy) + jnp.sum(h * wh)

    ref = jax.jit(jax.grad(jloss, argnums=tuple(range(5))))(
        *map(jnp.asarray, arrs))
    ins = [_leaf(a, torch.float32) for a in arrs]
    y, h = ssd_ops.ssd(*ins, chunk)
    (torch.sum(y * torch.from_numpy(wy)) +
     torch.sum(h * torch.from_numpy(wh))).backward()
    _close_scaled([t.grad for t in ins], ref, GRAD_TOL)


def test_ssd_fn_without_a_state_gradient():
    """Training uses y alone: the state's gradient is None, and the
    result equals autograd of the plain chunked form."""
    arrs = _ssd_inputs(1, 12, 2, 3, 4, seed=5)
    ins = [_leaf(a, torch.float32) for a in arrs]
    y, _ = SSDFn.apply(*ins, 4)
    y.sum().backward()
    plain = [_leaf(a, torch.float32) for a in arrs]
    ssd_chunked(*plain, 4)[0].sum().backward()
    for a, b in zip(ins, plain):
        torch.testing.assert_close(a.grad, b.grad, rtol=0, atol=0)


def test_entries_use_the_functions_only_when_a_gradient_is_wanted():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 6, 2, 2, 4))
    assert fa_ops.flash_attention(q, k, v, None, None).grad_fn is None
    q.requires_grad_()
    o = fa_ops.flash_attention(q, k, v, None, None)
    assert type(o.grad_fn).__name__ == "FlashAttentionFnBackward"
    with torch.no_grad():
        assert fa_ops.flash_attention(q, k, v, None, None).grad_fn is None
    torch.testing.assert_close(o.detach(), flash_attention_ref(q, k, v)
                               .detach(), rtol=0, atol=0)
    ins = [torch.from_numpy(a) for a in _ssd_inputs(1, 8, 2, 3, 4)]
    assert ssd_ops.ssd(*ins, 4)[0].grad_fn is None
    ins[2].requires_grad_()                       # A alone
    y, _ = ssd_ops.ssd(*ins, 4)
    assert type(y.grad_fn).__name__ == "SSDFnBackward"


# ---------------------------------------------------------------------------
# the backward kernel's plain counterpart
# ---------------------------------------------------------------------------
def _bwd_ref_inputs(B, S, H, KV, hd, causal, window, cap, dtype, seed=1):
    """q, k, v, the plain forward's output and log-sum-exp, and an
    upstream gradient, all detached, in ``dtype``."""
    q, k, v = (torch.from_numpy(a).to(dtype)
               for a in _qkv(B, S, H, KV, hd, seed=seed))
    kw = dict(causal=causal, window=window, cap=cap)
    out = flash_attention_ref(q, k, v, **kw)
    lse = attention_lse_ref(q, k, **kw)
    g = torch.from_numpy(_loss_weights((B, S, H, hd), seed=seed + 7)) \
        .to(dtype)
    return q, k, v, out, lse, g, kw


@pytest.mark.parametrize("B,S,H,KV,hd,causal,window,cap", FA_CASES)
def test_flash_bwd_ref_equals_autograd_of_the_plain_version_f64(
        B, S, H, KV, hd, causal, window, cap):
    """The FA2 algebra from lse and D gives autograd's gradient of the
    plain version, in f64, to rounding (1e-10 of the largest)."""
    q, k, v, out, lse, g, kw = _bwd_ref_inputs(B, S, H, KV, hd, causal,
                                               window, cap, torch.float64)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    ref = torch.autograd.grad(flash_attention_ref(*leaves, **kw), leaves, g)
    got = flash_attention_bwd_ref(q, k, v, out, lse, g, **kw)
    scale = max(float(r.abs().max()) for r in ref)
    for a, r in zip(got, ref):
        assert a.dtype == torch.float64
        assert float((a - r).abs().max()) <= 1e-10 * scale


@pytest.mark.parametrize("B,S,H,KV,hd,causal,window,cap",
                         FA_CASES + [(1, 1040, 2, 1, 8, True, 300, 0.0)])
def test_flash_bwd_ref_matches_jax(B, S, H, KV, hd, causal, window, cap):
    """Against ``jax.grad`` of the JAX package's ``blockwise_attention``
    through the same loss as ``test_flash_fn_grads_match_jax`` (upstream
    gradient w + o), f32, within GRAD_TOL; S=1040 takes its blockwise
    branch and the reference's query chunks of 1024."""
    arrs = _qkv(B, S, H, KV, hd, seed=1)
    w = _loss_weights((B, S, H, hd))
    pos = jnp.broadcast_to(jnp.arange(S), (B, S))

    def jloss(q, k, v):
        o = jax_blockwise(q, k, v, pos, pos, causal=causal, window=window,
                          cap=cap)
        return jnp.sum(o * w) + 0.5 * jnp.sum(o * o)

    ref = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(
        *map(jnp.asarray, arrs))
    q, k, v = (torch.from_numpy(a) for a in arrs)
    kw = dict(causal=causal, window=window, cap=cap)
    out = flash_attention_ref(q, k, v, **kw)
    got = flash_attention_bwd_ref(q, k, v, out, attention_lse_ref(q, k, **kw),
                                  torch.from_numpy(w) + out, **kw)
    _close_scaled(got, ref, GRAD_TOL)


def test_attention_lse_ref_is_the_log_normaliser_of_the_output():
    """exp(s - lse) over the kept keys sums to 1 in every row, and weights
    v into the plain version's output (f64, window, softcap, GQA)."""
    B, S, H, KV, hd = 1, 12, 4, 2, 4
    q, k, v, out, lse, _, kw = _bwd_ref_inputs(B, S, H, KV, hd, True, 5,
                                               3.0, torch.float64)
    s = torch.einsum("bqhd,bshd->bhqs", q,
                     k.repeat_interleave(H // KV, dim=2)) / np.sqrt(hd)
    s = 3.0 * torch.tanh(s / 3.0)
    i = torch.arange(S)
    keep = (i[None, :] <= i[:, None]) & (i[:, None] - i[None, :] < 5)
    p = torch.where(keep, torch.exp(s - lse[..., None]), 0.0)
    torch.testing.assert_close(p.sum(-1), torch.ones(B, H, S, dtype=p.dtype))
    o = torch.einsum("bhqs,bshd->bqhd", p, v.repeat_interleave(H // KV,
                                                               dim=2))
    torch.testing.assert_close(o, out)


def test_flash_fn_backward_on_the_cpu_is_the_plain_autograd(monkeypatch):
    """On the CPU, f32 and bf16 alike, FlashAttentionFn saves q, k, v and
    backpropagates through autograd of the plain version, bit for bit; the
    log-sum-exp forward and the backward kernel are never called, and
    ``meta`` takes the same route."""
    def refuse(*a, **k):
        raise AssertionError("the kernel route was taken on the CPU")
    monkeypatch.setattr(fa_kernel, "flash_attention_lse", refuse)
    monkeypatch.setattr(fa_kernel, "flash_attention_bwd", refuse)
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, _, _, g, kw = _bwd_ref_inputs(1, 12, 4, 2, 8, True, 5, 3.0,
                                               dtype)
        assert not fa_autograd.kernel_backward(q)
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        o = FlashAttentionFn.apply(*leaves, True, 5, 3.0, None)
        assert len(o.grad_fn.saved_tensors) == 3
        got = torch.autograd.grad(o, leaves, g)
        plain = [t.clone().requires_grad_() for t in (q, k, v)]
        ref = torch.autograd.grad(flash_attention_ref(*plain, **kw), plain,
                                  g)
        for a, b in zip(got, ref):
            assert a.dtype == dtype
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not fa_autograd.kernel_backward(
        torch.empty((1, 4, 2, 8), dtype=torch.bfloat16, device="meta"))


def test_backward_kernel_entries_refuse_the_cpu():
    """The log-sum-exp forward and the backward kernel are C entry points
    of the bf16 library; their launchers take bf16 on the card alone, and
    refuse a CPU tensor without counting a launch."""
    from repro_torch.kernels import _build
    src = (_build.CSRC / f"{fa_kernel.BWD_ENTRY[0]}.cu").read_text()
    for lib, fn in (fa_kernel.LSE_ENTRY, fa_kernel.BWD_ENTRY):
        assert lib == fa_kernel.entry(torch.bfloat16)[0]
        assert f'extern "C" int {fn}(' in src
    q, k, v, out, lse, g, kw = _bwd_ref_inputs(1, 8, 2, 1, 16, True, 0, 0.0,
                                               torch.bfloat16)
    before = fa_kernel.launches, fa_kernel.bwd_launches
    with pytest.raises(ValueError, match="CUDA"):
        fa_kernel.flash_attention_lse(q, k, v)
    with pytest.raises(ValueError, match="CUDA"):
        fa_kernel.flash_attention_bwd(q, k, v, out, lse, g)
    assert (fa_kernel.launches, fa_kernel.bwd_launches) == before


def test_bf16_card_route_saves_lse_and_calls_the_backward_kernel(
        monkeypatch):
    """With ``on_card`` true, bf16 under a gradient takes the kernel route:
    the forward that returns the log-sum-exp, q, k, v, the output and the
    log-sum-exp saved, and the backward kernel called once with them, the
    upstream gradient and the options.  Stand-ins that run the plain
    versions give autograd's f32 gradients within the bf16 rounding of
    the inputs and outputs (2e-2 of the largest)."""
    calls = []

    def lse_fwd(q, k, v, **kw):
        calls.append(("lse", kw))
        return (flash_attention_ref(q, k, v, **kw),
                attention_lse_ref(q, k, **kw))

    def bwd(q, k, v, out, lse, g, **kw):
        calls.append(("bwd", kw))
        assert lse.dtype == torch.float32 and lse.shape == (1, 4, 12)
        return flash_attention_bwd_ref(q, k, v, out, lse, g, **kw)
    monkeypatch.setattr(fa_autograd, "on_card", lambda t: True)
    monkeypatch.setattr(fa_kernel, "flash_attention_lse", lse_fwd)
    monkeypatch.setattr(fa_kernel, "flash_attention_bwd", bwd)
    q, k, v, _, _, g, kw = _bwd_ref_inputs(1, 12, 4, 2, 8, True, 5, 3.0,
                                           torch.bfloat16)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    o = FlashAttentionFn.apply(*leaves, True, 5, 3.0, None)
    assert len(o.grad_fn.saved_tensors) == 5
    got = torch.autograd.grad(o, leaves, g)
    opts = dict(causal=True, window=5, cap=3.0, scale=None)
    assert calls == [("lse", opts), ("bwd", opts)]
    wide = [t.float().requires_grad_() for t in (q, k, v)]
    ref = torch.autograd.grad(flash_attention_ref(*wide, **kw), wide,
                              g.float())
    scale = max(float(r.abs().max()) for r in ref)
    for a, r in zip(got, ref):
        assert a.dtype == torch.bfloat16
        assert float((a.float() - r).abs().max()) <= 2e-2 * scale
