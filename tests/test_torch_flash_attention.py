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
    before = fa_kernel.launches
    pos = torch.arange(32).expand(1, 32)
    fa_ops.flash_attention(q, k, v, pos, pos)
    with pytest.raises(ValueError, match="CUDA"):
        fa_kernel.flash_attention(q, k, v)
    assert fa_kernel.launches == before
