"""Port's flash attention (plain version, CPU) against the JAX package.

The same seeded numpy inputs go through the JAX kernel in interpret mode,
the JAX pure-jnp oracle and the XLA ``blockwise_attention``, and through
the port's CPU path.  Tolerances are the JAX kernel tests': 2e-5 in f32,
2e-2 in bf16 (bf16 inputs are rounded the same way in both frameworks; the
two frameworks round the bf16 P·V product at different places).  The CUDA
kernel itself is held against this plain version on the card by
``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _tf32 import mm_tf32
from repro.kernels.flash_attention import kernel as jax_fa
from repro.kernels.flash_attention.ref import \
    flash_attention_ref as jax_fa_ref
from repro.models.attention import blockwise_attention as jax_blockwise
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

CASES = [
    # B, S, H, KV, hd, causal, window, cap  (tests/kernels/test_flash_attention.py)
    (1, 128, 2, 2, 32, True, 0, 0.0),
    (2, 256, 4, 2, 16, True, 0, 0.0),
    (1, 256, 4, 1, 32, True, 64, 0.0),
    (2, 128, 2, 2, 64, True, 0, 50.0),
    (1, 128, 4, 4, 32, False, 0, 0.0),
    (1, 512, 8, 2, 64, True, 128, 30.0),
    # head dim 80 (hubert-xlarge: non-causal, H == KV), and causal with a
    # window and softcap
    (2, 128, 4, 4, 80, False, 0, 0.0),
    (1, 256, 4, 2, 80, True, 64, 50.0),
]
DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _mk(B, S, H, KV, hd, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, H, hd), dtype=np.float32),
            rng.standard_normal((B, S, KV, hd), dtype=np.float32),
            rng.standard_normal((B, S, KV, hd), dtype=np.float32))


def _both(arrs, dname):
    jd, td, _ = DTYPES[dname]
    return ([jnp.asarray(a).astype(jd) for a in arrs],
            [torch.from_numpy(a).to(td) for a in arrs])


def _close(out, ref, tol):
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dname", list(DTYPES))
def test_plain_matches_jax_kernel_and_oracle(case, dname):
    B, S, H, KV, hd, causal, window, cap = case
    (jq, jk, jv), (q, k, v) = _both(_mk(B, S, H, KV, hd), dname)
    tol = DTYPES[dname][2]
    pos = torch.arange(S).expand(B, S)
    out = fa_ops.flash_attention(q, k, v, pos, pos, causal=causal,
                                 window=window, cap=cap)
    assert out.dtype == q.dtype and out.shape == q.shape
    kern = jax_fa.flash_attention(jq, jk, jv, n_kv_heads=KV, causal=causal,
                                  window=window, cap=cap, interpret=True)
    oracle = jax_fa_ref(jq, jk, jv, causal=causal, window=window, cap=cap)
    _close(out, kern, tol)
    _close(out, oracle, tol)


@pytest.mark.parametrize("S,window", [(200, 0), (200, 64), (1100, 300)])
@pytest.mark.parametrize("dname", list(DTYPES))
def test_ragged_and_windowed_against_xla(S, window, dname):
    """Lengths the JAX kernel refuses (S % 128 != 0) and S > window (and
    S > the 1024 chunk, the online-softmax branch) against the XLA path,
    which honours the window."""
    B, H, KV, hd = 1, 4, 2, 32
    (jq, jk, jv), (q, k, v) = _both(_mk(B, S, H, KV, hd, seed=S), dname)
    tol = DTYPES[dname][2]
    jpos = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32), (B, S))
    ref = jax_blockwise(jq, jk, jv, jpos, jpos, causal=True, window=window)
    pos = torch.arange(S).expand(B, S)
    out = fa_ops.flash_attention(q, k, v, pos, pos, causal=True,
                                 window=window)
    _close(out, ref, tol)


def test_window_changes_the_result():
    """The window reaches the computation (the JAX kernel's ops.py drops a
    traced window to 0; the port takes it as a plain int)."""
    (_, (q, k, v)) = _both(_mk(1, 96, 2, 1, 16, seed=5), "float32")
    full = flash_attention_ref(q, k, v, window=0)
    win = flash_attention_ref(q, k, v, window=16)
    assert torch.equal(full[:, :16], win[:, :16])
    assert not torch.allclose(full[:, 16:], win[:, 16:])


def test_cpu_path_never_launches_and_kernel_refuses_cpu():
    (_, (q, k, v)) = _both(_mk(1, 32, 2, 1, 16), "float32")
    before = fa_kernel.launches, dict(fa_kernel.launches_by_dtype)
    pos = torch.arange(32).expand(1, 32)
    fa_ops.flash_attention(q, k, v, pos, pos)
    with pytest.raises(ValueError, match="CUDA"):
        fa_kernel.flash_attention(q, k, v)
    assert (fa_kernel.launches, fa_kernel.launches_by_dtype) == before


def _tc_rounding(q, k, v, *, causal=True, window=0, cap=0.0, split=False):
    """The bf16 tensor-core kernel's arithmetic in plain PyTorch: f32
    scores from the bf16 inputs, kept in the log2 domain (times scale and
    log2 e), the softcap as cap (1 - 2 / (2^(2 x log2 e) + 1)), masked
    scores -1e30; online softmax over 64-key tiles, each tile's f32
    probabilities summed before they join the denominator; P rounded to
    bf16 only as the operand of P.V (f32 accumulator), O rescaled after
    each tile's P.V.  With ``split`` (``kernel.plan``: blocks fewer than
    the SMs) the even and the odd tiles run two softmax states, merged at
    the end."""
    B, S, H, hd = q.shape
    G = H // k.shape[2]
    scale = 1.0 / np.sqrt(hd)
    log2e = 1.4426950408889634
    qf = q.float().transpose(1, 2)                             # [B,H,S,hd]
    kf = k.float().repeat_interleave(G, 2).transpose(1, 2)
    vf = v.float().repeat_interleave(G, 2).transpose(1, 2)
    qp = torch.arange(S)[:, None]
    states = [[torch.full((B, H, S), -1e30), torch.zeros((B, H, S)),
               torch.zeros((B, H, S, hd))] for _ in range(2 if split else 1)]
    for t, k0 in enumerate(range(0, S, 64)):
        st = states[t % len(states)]
        kp = torch.arange(k0, min(S, k0 + 64))[None, :]
        s = qf @ kf[:, :, k0:k0 + 64].transpose(-1, -2)
        if cap:
            x2 = s * (2 * scale / cap * log2e)
            s = (1 - 2 / (torch.exp2(x2) + 1)) * (cap * log2e)
        else:
            s = s * (scale * log2e)
        ok = torch.ones_like(s, dtype=torch.bool)
        if causal:
            ok = ok & (kp <= qp)
        if window > 0:
            ok = ok & (qp - kp < window)
        s = torch.where(ok, s, -1e30)
        m, l, acc = st
        m2 = torch.maximum(m, s.amax(-1))
        p = torch.exp2(s - m2[..., None])
        c = torch.exp2(m - m2)
        st[1] = l * c + p.sum(-1)
        pv = p.to(torch.bfloat16).float() @ vf[:, :, k0:k0 + 64]
        st[2] = acc * c[..., None] + pv
        st[0] = m2
    m, l, acc = states[0]
    if split:
        m1, l1, acc1 = states[1]
        mm = torch.maximum(m, m1)
        a, b = torch.exp2(m - mm), torch.exp2(m1 - mm)
        l, acc = l * a + l1 * b, acc * a[..., None] + acc1 * b[..., None]
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)


@pytest.mark.parametrize("S,window,block", [(200, 0, 200), (1100, 300, 275)])
def test_tc_rounding_holds_bf16_tolerance(S, window, block):
    """The bf16 kernel's rounding points, at hymba's widths (25 query and
    5 KV heads of 64) and the split its plan takes on an H100's 132 SMs,
    against the JAX kernel in interpret mode at 2e-2.  The JAX kernel
    asserts S % block == 0, so its blocks divide S; the function does not
    depend on them."""
    H, KV, hd = 25, 5, 64
    (jq, jk, jv), (q, k, v) = _both(_mk(1, S, H, KV, hd, seed=S), "bfloat16")
    kern = jax_fa.flash_attention(jq, jk, jv, n_kv_heads=KV, causal=True,
                                  window=window, block_q=block,
                                  block_k=block, interpret=True)
    split = fa_kernel.plan(1, S, H, KV, 132)["split"]
    out = _tc_rounding(q, k, v, causal=True, window=window, split=split)
    assert out.dtype == torch.bfloat16
    _close(out, kern, DTYPES["bfloat16"][2])


def _tf32x3(q, k, v, *, causal=True, window=0, cap=0.0, passes=3):
    """The f32 kernel's arithmetic in plain PyTorch: Q.K^T and P.V in
    ``passes`` TF32 passes (``mm_tf32``) over key tiles of 64 (32 at head
    dim 128); scores in the log2 domain (times scale * log2 e, an f32
    product; the softcap as tanh(s scale (1 / cap)) cap log2 e), masked scores
    -1e30; online softmax with f32 running max, denominator and
    accumulator; output acc / max(l, 1e-30).  The kernel's split mode (two
    halves of each key tile, their softmax states merged at the end)
    changes only the order of f32 sums."""
    B, S, H, hd = q.shape
    G = H // k.shape[2]
    bk = 64 if hd <= 80 else 32
    scale = 1.0 / np.sqrt(hd)
    sl2 = float(np.float32(scale) * np.float32(1.4426950408889634))
    qf = q.float().transpose(1, 2)                             # [B,H,S,hd]
    kf = k.float().repeat_interleave(G, 2).transpose(1, 2)
    vf = v.float().repeat_interleave(G, 2).transpose(1, 2)
    qp = torch.arange(S)[:, None]
    m = torch.full((B, H, S), -1e30)
    l, acc = torch.zeros((B, H, S)), torch.zeros((B, H, S, hd))
    for k0 in range(0, S, bk):
        kp = torch.arange(k0, min(S, k0 + bk))[None, :]
        s = mm_tf32(qf, kf[:, :, k0:k0 + bk].transpose(-1, -2), passes)
        if cap:
            s = torch.tanh(s * np.float32(scale) * np.float32(1 / cap)) \
                * cap * 1.4426950408889634
        else:
            s = s * sl2
        ok = torch.ones_like(s, dtype=torch.bool)
        if causal:
            ok = ok & (kp <= qp)
        if window > 0:
            ok = ok & (qp - kp < window)
        s = torch.where(ok, s, -1e30)
        m2 = torch.maximum(m, s.amax(-1))
        p = torch.exp2(s - m2[..., None])
        c = torch.exp2(m - m2)
        l = l * c + p.sum(-1)
        acc = acc * c[..., None] + mm_tf32(p, vf[:, :, k0:k0 + bk], passes)
        m = m2
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.transpose(1, 2)


# the JAX kernel tests' cases, and hymba's widths (25 query and 5 KV heads
# of 64) at a ragged S (block 200, the JAX kernel's S % block rule) and with
# a window
TF32X3_CASES = [(c, 128) for c in CASES] + [
    ((1, 200, 25, 5, 64, True, 0, 0.0), 200),
    ((1, 384, 25, 5, 64, True, 100, 0.0), 128)]


@pytest.mark.parametrize("case,block", TF32X3_CASES)
def test_tf32x3_rounding_holds_f32_tolerance(case, block):
    """The f32 kernel's three TF32 passes, emulated, against the JAX kernel
    in interpret mode at the f32 tolerance 2e-5."""
    B, S, H, KV, hd, causal, window, cap = case
    (jq, jk, jv), (q, k, v) = _both(_mk(B, S, H, KV, hd, seed=S + hd),
                                    "float32")
    kern = jax_fa.flash_attention(jq, jk, jv, n_kv_heads=KV, causal=causal,
                                  window=window, cap=cap, block_q=block,
                                  block_k=block, interpret=True)
    out = _tf32x3(q, k, v, causal=causal, window=window, cap=cap)
    _close(out, kern, DTYPES["float32"][2])


def test_one_tf32_pass_misses_f32_tolerance():
    """Why three passes: one TF32 pass (big.big alone) at hymba's widths
    misses the f32 tolerance by far more than the three passes' margin."""
    (jq, jk, jv), (q, k, v) = _both(_mk(1, 256, 25, 5, 64, seed=7),
                                    "float32")
    kern = np.asarray(jax_fa.flash_attention(
        jq, jk, jv, n_kv_heads=5, causal=True, window=1024, interpret=True))
    tol = DTYPES["float32"][2]

    def ratio(out):   # largest |out - kern| / (tol + tol |kern|)
        return float(np.max(np.abs(out.numpy() - kern)
                            / (tol + tol * np.abs(kern))))
    assert ratio(_tf32x3(q, k, v, window=1024, passes=1)) > 4.0
    assert ratio(_tf32x3(q, k, v, window=1024)) < 0.5


def test_dtype_alone_routes_to_a_kernel():
    """bf16 goes to the wgmma kernel and f32 to the three-pass TF32 one;
    each entry names a C function that its source exports.  Both dtypes
    are still refused on the CPU, and nothing launches."""
    from repro_torch.kernels import _build
    assert fa_kernel.entry(torch.bfloat16) == ("flash_attention_tc",
                                               "fa_forward_tc")
    assert fa_kernel.entry(torch.float32) == ("flash_attention",
                                              "fa_forward")
    with pytest.raises(TypeError):
        fa_kernel.entry(torch.float16)
    for dtype in fa_kernel.DTYPES:
        lib, fn = fa_kernel.entry(dtype)
        assert lib in _build.KERNELS
        assert f'extern "C" int {fn}(' in \
            (_build.CSRC / f"{lib}.cu").read_text()
        (_, (q, k, v)) = _both(_mk(1, 32, 2, 1, 16),
                               "bfloat16" if dtype == torch.bfloat16
                               else "float32")
        before = fa_kernel.launches, dict(fa_kernel.launches_by_dtype)
        with pytest.raises(ValueError, match="CUDA"):
            fa_kernel.flash_attention(q, k, v)
        assert (fa_kernel.launches, fa_kernel.launches_by_dtype) == before
    assert set(fa_kernel.launches_by_dtype) == \
        {str(d).removeprefix("torch.") for d in fa_kernel.DTYPES}


def test_head_dim_80_is_built_by_both_kernels():
    """hubert-xlarge's head dim: the launcher takes it, and both sources
    instantiate it (the f32 kernel in k-steps of 8, as mma.sync m16n8k8
    takes them, so every built head dim is a multiple of 8); other head
    dims still raise, with no fallback."""
    from repro_torch.kernels import _build
    assert 80 in fa_kernel.HEAD_DIMS and 48 not in fa_kernel.HEAD_DIMS
    for dtype in fa_kernel.DTYPES:
        src = (_build.CSRC / f"{fa_kernel.entry(dtype)[0]}.cu").read_text()
        assert "case 80:" in src and "launch_hd<80>" in src
    assert all(d % 8 == 0 for d in fa_kernel.HEAD_DIMS)
    assert "KS = HD / 8" in (_build.CSRC / "flash_attention.cu").read_text()


# head dims the kernels are not built for run zero-padded to the next one
PAD_HDS = (4, 12, 24, 40, 100)
PAD_MASKS = [  # causal, window, cap
    (True, 0, 0.0), (False, 0, 0.0), (True, 24, 0.0), (False, 0, 30.0),
    (True, 16, 50.0)]


@pytest.mark.parametrize("hd", PAD_HDS)
@pytest.mark.parametrize("causal,window,cap", PAD_MASKS)
def test_padded_head_dim_gives_the_unpadded_result(hd, causal, window,
                                                   cap):
    """The launcher's padding, then the plain version at the unpadded
    scale, sliced back: within 1e-6 of the plain version unpadded, and
    the padded columns of the output are zeros."""
    (_, (q, k, v)) = _both(_mk(2, 80, 4, 2, hd, seed=hd), "float32")
    qp, kp, vp = fa_kernel.pad_head_dim(q, k, v)
    hdp = fa_kernel.padded_head_dim(hd)
    assert hdp in fa_kernel.HEAD_DIMS and hdp > hd
    assert qp.shape[-1] == kp.shape[-1] == vp.shape[-1] == hdp
    assert torch.equal(qp[..., :hd], q) and not qp[..., hd:].any()
    out = flash_attention_ref(qp, kp, vp, causal=causal, window=window,
                              cap=cap, scale=1.0 / np.sqrt(hd))
    ref = flash_attention_ref(q, k, v, causal=causal, window=window,
                              cap=cap)
    assert float((out[..., :hd] - ref).abs().max()) <= 1e-6
    assert not out[..., hd:].any()


def test_every_head_dim_up_to_128_maps_to_a_built_one():
    from repro_torch.kernels import _build
    srcs = [(_build.CSRC / f"{fa_kernel.entry(d)[0]}.cu").read_text()
            for d in fa_kernel.DTYPES]
    for d in fa_kernel.HEAD_DIMS:
        assert all(f"case {d}:" in src and f"launch_hd<{d}>" in src
                   for src in srcs), d
    for hd in range(1, 129):
        hdp = fa_kernel.padded_head_dim(hd)
        assert hdp in fa_kernel.HEAD_DIMS and hdp >= hd
        assert [d for d in fa_kernel.HEAD_DIMS if hd <= d][0] == hdp
    (_, (q, k, v)) = _both(_mk(1, 8, 2, 1, 64), "float32")
    assert fa_kernel.pad_head_dim(q, k, v)[0] is q     # built: no copy


def test_head_dim_above_128_raises():
    for hd in (129, 256):
        with pytest.raises(ValueError, match="take 1 to 128"):
            fa_kernel.padded_head_dim(hd)
        (_, (q, k, v)) = _both(_mk(1, 8, 2, 1, hd), "float32")
        with pytest.raises(ValueError, match="take 1 to 128"):
            fa_kernel.pad_head_dim(q, k, v)
    with pytest.raises(ValueError):
        fa_kernel.padded_head_dim(0)
