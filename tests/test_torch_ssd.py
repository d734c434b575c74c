"""Port's SSD chunk scan (plain versions, CPU) against the JAX package.

The same seeded numpy inputs go through the JAX kernel in interpret mode,
the JAX chunked form and the sequential oracle, and through the port's CPU
path.  Tolerances are the JAX kernel tests': 1e-4 in f32, 5e-2 in bf16.
The CUDA kernel itself is held against ``ssd_chunked`` on the card by
``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _tf32 import mm_tf32
from repro.kernels.ssd import kernel as jax_ssd
from repro.kernels.ssd.ref import ssd_chunked as jax_chunked
from repro.kernels.ssd.ref import ssd_ref as jax_seq
from repro_torch.kernels.ssd import kernel as ssd_kernel
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.kernels.ssd.ref import ssd_chunked, ssd_ref

CASES = [  # B, S, H, P, N, chunk  (tests/kernels/test_ssd.py)
    (1, 64, 2, 16, 8, 16),
    (2, 128, 3, 32, 16, 32),
    (1, 256, 2, 64, 64, 64),
]
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-4),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 5e-2)}


def _mk(B, S, H, P, N, seed=0):
    rng = np.random.default_rng(seed)
    xs = rng.standard_normal((B, S, H, P), dtype=np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H), dtype=np.float32)
                         - 1.0)).astype(np.float32)
    A = (-np.exp(rng.standard_normal(H, dtype=np.float32) * 0.3)) \
        .astype(np.float32)
    B_ = rng.standard_normal((B, S, N), dtype=np.float32)
    C_ = rng.standard_normal((B, S, N), dtype=np.float32)
    return xs, dt, A, B_, C_


def _both(arrs, dname):
    """xs, B, C in the working dtype; dt and A stay f32, as in the model."""
    jd, td, _ = DTYPES[dname]
    xs, dt, A, B_, C_ = arrs
    j = [jnp.asarray(xs).astype(jd), jnp.asarray(dt), jnp.asarray(A),
         jnp.asarray(B_).astype(jd), jnp.asarray(C_).astype(jd)]
    t = [torch.from_numpy(xs).to(td), torch.from_numpy(dt),
         torch.from_numpy(A), torch.from_numpy(B_).to(td),
         torch.from_numpy(C_).to(td)]
    return j, t


def _close(out, ref, tol):
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("B,S,H,P,N,chunk", CASES)
@pytest.mark.parametrize("dname", list(DTYPES))
def test_plain_matches_jax_kernel_and_oracles(B, S, H, P, N, chunk, dname):
    j, t = _both(_mk(B, S, H, P, N), dname)
    tol = DTYPES[dname][2]
    y, hT = ssd_ops.ssd(*t, chunk)
    assert y.dtype == t[0].dtype and hT.dtype == torch.float32
    for ref in (jax_ssd.ssd(*j, chunk=chunk, interpret=True),
                jax_chunked(*j, chunk), jax_seq(*j)):
        _close(y, ref[0], tol)
        _close(hT, ref[1], tol)


@pytest.mark.parametrize("dname", list(DTYPES))
def test_sequential_oracle_matches(dname):
    j, t = _both(_mk(2, 48, 3, 16, 8, seed=1), dname)
    y, hT = ssd_ref(*t)
    yj, hj = jax_seq(*j)
    tol = DTYPES[dname][2]
    _close(y, yj, tol)
    _close(hT, hj, tol)


@pytest.mark.parametrize("S,chunk", [(100, 32), (20, 32), (129, 128)])
@pytest.mark.parametrize("dname", list(DTYPES))
def test_ragged_length_against_recurrence(S, chunk, dname):
    """S % chunk != 0 and S < chunk, which the JAX kernel refuses and the
    XLA path sends to the sequential oracle."""
    j, t = _both(_mk(1, S, 2, 16, 8, seed=S), dname)
    tol = DTYPES[dname][2]
    y, hT = ssd_ops.ssd(*t, chunk)
    yj, hj = jax_seq(*j)
    assert y.shape == (1, S, 2, 16)
    _close(y, yj, tol)
    _close(hT, hj, tol)


def test_chunk_size_independence():
    _, t = _both(_mk(1, 128, 2, 16, 8, seed=3), "float32")
    outs = [ssd_chunked(*t, c)[0].numpy() for c in (16, 32, 48, 128)]
    for o in outs[1:]:
        np.testing.assert_allclose(o, outs[0], atol=1e-4, rtol=1e-4)


def test_cpu_path_never_launches_and_kernel_refuses_cpu():
    _, t = _both(_mk(1, 16, 2, 16, 8), "float32")
    before = ssd_kernel.launches
    ssd_ops.ssd(*t, 8)
    with pytest.raises(ValueError, match="CUDA"):
        ssd_kernel.ssd(*t, chunk=8)
    assert ssd_kernel.launches == before


def _split(v):
    """v as the kernel feeds it to a product: hi and lo, both bf16."""
    hi = v.to(torch.bfloat16).float()
    return hi, (v - hi).to(torch.bfloat16).float()


def _tc_rounding(xs, dt, A, B_, C_, chunk):
    """The bf16 tensor-core kernel's arithmetic in plain PyTorch: x, B and
    C enter the products as they are (bf16); the decayed scores, B o w and
    the state entering a chunk enter as two bf16 terms (``_split``) whose
    products are summed apart (the y accumulators of the hi and the lo
    scores, the state's parts) and added in f32; the chunk's cumsum is
    taken in f64 and rounded once; y is rounded to bf16 once, at the end
    of the chunk."""
    Bb, S, H, P = xs.shape
    N = B_.shape[-1]
    x, Bm, Cm = xs.float(), B_.float(), C_.float()
    y = torch.empty((Bb, S, H, P))
    h = torch.zeros((Bb, H, P, N))
    for c0 in range(0, S, chunk):
        sl = slice(c0, min(S, c0 + chunk))
        cum = torch.cumsum((dt[:, sl] * A).double(), 1).float()  # [B,l,H]
        l = cum.shape[1]
        causal = torch.tril(torch.ones(l, l, dtype=torch.bool))[None, :, :,
                                                                None]
        seg = cum[:, :, None, :] - cum[:, None, :, :]         # [B,i,j,H]
        L = torch.where(causal, torch.exp(torch.where(causal, seg, 0.0)),
                        0.0)
        cb = torch.einsum("bin,bjn->bij", Cm[:, sl], Bm[:, sl])
        s_hi, s_lo = _split(cb[..., None] * L * dt[:, sl][:, None])
        h_hi, h_lo = _split(h)
        inter = (torch.einsum("bin,bhpn->bihp", Cm[:, sl], h_hi)
                 + torch.einsum("bin,bhpn->bihp", Cm[:, sl], h_lo))
        y[:, sl] = (torch.einsum("bijh,bjhp->bihp", s_hi, x[:, sl])
                    + torch.einsum("bijh,bjhp->bihp", s_lo, x[:, sl])
                    + inter * torch.exp(cum)[..., None])
        w = dt[:, sl] * torch.exp(cum[:, -1:] - cum)          # [B,l,H]
        w_hi, w_lo = _split(Bm[:, sl][:, :, None, :] * w[..., None])
        h = h * torch.exp(cum[:, -1])[:, :, None, None] + (
            torch.einsum("bjhp,bjhn->bhpn", x[:, sl], w_hi)
            + torch.einsum("bjhp,bjhn->bhpn", x[:, sl], w_lo))
    return y.to(xs.dtype), h


@pytest.mark.parametrize("S,N,chunk,jax_chunk", [(200, 16, 128, 100),
                                                 (300, 128, 256, 150)])
def test_tc_rounding_holds_bf16_tolerance(S, N, chunk, jax_chunk):
    """The bf16 kernel's rounding points at hymba's widths (P=64, N=16,
    chunk 128, S ragged) and at N=128, chunk 256, against the JAX kernel
    in interpret mode at 5e-2.  The JAX kernel asserts S % chunk == 0, so
    its chunk divides S; the function does not depend on the chunk."""
    j, t = _both(_mk(1, S, 4, 64, N, seed=S), "bfloat16")
    y, hT = _tc_rounding(*t, chunk)
    yj, hj = jax_ssd.ssd(*j, chunk=jax_chunk, interpret=True)
    assert y.dtype == torch.bfloat16 and y.shape == (1, S, 4, 64)
    _close(y, yj, DTYPES["bfloat16"][2])
    _close(hT, hj, DTYPES["bfloat16"][2])


def _tf32x3(xs, dt, A, B_, C_, chunk, passes=3):
    """The f32 kernel's arithmetic in plain PyTorch, chunk by chunk: the
    cumsum of dt*A in f64, rounded once; w = dt exp(cum_end - cum); the
    state's x^T (B o w), C.B^T, the decayed scores' product with x and
    C.h_prev each in ``passes`` TF32 passes (``mm_tf32``); the decay
    exp(cum_i - cum_j) and dt_j applied to C.B^T, zero above the diagonal;
    y = scores.x + exp(cum) C.h_prev; h = h exp(cum_end) + x^T (B o w)."""
    Bb, S, H, P = xs.shape
    N = B_.shape[-1]
    x = xs.float().permute(0, 2, 1, 3)                         # [B,H,S,P]
    y = torch.empty((Bb, H, S, P))
    h = torch.zeros((Bb, H, P, N))
    for c0 in range(0, S, chunk):
        sl = slice(c0, min(S, c0 + chunk))
        cum = torch.cumsum((dt[:, sl] * A).double(), 1).float() \
            .transpose(1, 2)                                    # [B,H,l]
        l = cum.shape[-1]
        Bc, Cc, xc = B_[:, sl].float(), C_[:, sl].float(), x[:, :, sl]
        dtc = dt[:, sl].transpose(1, 2)                         # [B,H,l]
        w = dtc * torch.exp(cum[..., -1:] - cum)
        hc = mm_tf32(xc.transpose(-1, -2), Bc[:, None] * w[..., None],
                      passes)                                   # [B,H,P,N]
        cb = mm_tf32(Cc, Bc.transpose(-1, -2), passes)[:, None]  # [B,1,l,l]
        causal = torch.tril(torch.ones(l, l, dtype=torch.bool))
        seg = cum[..., :, None] - cum[..., None, :]
        sc = torch.where(causal, cb * torch.exp(torch.where(causal, seg, 0.0))
                         * dtc[..., None, :], 0.0)
        inter = mm_tf32(Cc[:, None].expand(-1, H, -1, -1),
                         h.transpose(-1, -2), passes)           # [B,H,l,P]
        y[:, :, sl] = mm_tf32(sc, xc, passes) + \
            torch.exp(cum)[..., None] * inter
        h = h * torch.exp(cum[..., -1])[..., None, None] + hc
    return y.permute(0, 2, 1, 3), h


# the JAX kernel tests' cases, hymba's widths (P=64, N=16, chunk 128; 4 of
# its 50 heads) at a ragged S (the JAX kernel's chunk divides S; the
# function does not depend on it), and mamba2-130m's N=128, chunk 256
TF32X3_CASES = [(c, c[-1]) for c in CASES] + [
    ((1, 300, 4, 64, 16, 128), 100),
    ((1, 256, 2, 64, 128, 256), 256)]


@pytest.mark.parametrize("case,jax_chunk", TF32X3_CASES)
def test_tf32x3_rounding_holds_f32_tolerance(case, jax_chunk):
    """The f32 kernel's three TF32 passes, emulated, against the JAX kernel
    in interpret mode at the f32 tolerance 1e-4."""
    B, S, H, P, N, chunk = case
    j, t = _both(_mk(B, S, H, P, N, seed=S + N), "float32")
    y, hT = _tf32x3(*t, chunk)
    yj, hj = jax_ssd.ssd(*j, chunk=jax_chunk, interpret=True)
    assert y.shape == (B, S, H, P) and hT.shape == (B, H, P, N)
    _close(y, yj, DTYPES["float32"][2])
    _close(hT, hj, DTYPES["float32"][2])


def test_one_tf32_pass_misses_f32_tolerance():
    """Why three passes: one TF32 pass (big.big alone) at hymba's widths
    misses the f32 tolerance by far more than the three passes' margin."""
    j, t = _both(_mk(1, 256, 4, 64, 16, seed=11), "float32")
    yj, hj = (np.asarray(a) for a in jax_ssd.ssd(*j, chunk=128,
                                                  interpret=True))
    tol = DTYPES["float32"][2]

    def ratio(out):   # largest |out - ref| / (tol + tol |ref|) of y, state
        return max(float(np.max(np.abs(o.numpy() - r)
                                / (tol + tol * np.abs(r))))
                   for o, r in zip(out, (yj, hj)))
    assert ratio(_tf32x3(*t, 128, passes=1)) > 4.0
    assert ratio(_tf32x3(*t, 128)) < 0.5


def test_dtype_alone_routes_to_a_kernel():
    """bf16 goes to the wgmma kernel and f32 to the three-pass TF32 one;
    each entry names a C function that its source exports.  Both dtypes
    are still refused on the CPU, and nothing launches."""
    from repro_torch.kernels import _build
    assert ssd_kernel.entry(torch.bfloat16) == ("ssd_tc", "ssd_forward_tc")
    assert ssd_kernel.entry(torch.float32) == ("ssd", "ssd_forward")
    with pytest.raises(TypeError):
        ssd_kernel.entry(torch.float16)
    for dtype in ssd_kernel.DTYPES:
        lib, fn = ssd_kernel.entry(dtype)
        assert lib in _build.KERNELS
        assert f'extern "C" int {fn}(' in \
            (_build.CSRC / f"{lib}.cu").read_text()
        _, t = _both(_mk(1, 16, 2, 16, 8),
                     "bfloat16" if dtype == torch.bfloat16 else "float32")
        before = ssd_kernel.launches
        with pytest.raises(ValueError, match="CUDA"):
            ssd_kernel.ssd(*t, chunk=8)
        assert ssd_kernel.launches == before
