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
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
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
