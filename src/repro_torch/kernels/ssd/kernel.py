"""Launcher of the CUDA SSD chunk-scan kernel (``csrc/ssd.cu``).

The port's counterpart of ``repro.kernels.ssd.kernel``: it takes tensors
on the card only, checks what the kernel accepts, allocates the outputs and
launches on the current stream.  ``launches`` counts the launches, so a run
can show that its prefill went through the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build

launches = 0

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_P, MAX_N, MAX_CHUNK = 64, 128, 1024

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = [_P] * 7 + [_I] * 7 + [_L] * 10 + [_P]


def _fn():
    fn = _build.load("ssd").ssd_forward
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    return fn


def _check(xs, dt, A, B_, C_, chunk):
    if xs.device.type != "cuda":
        raise ValueError(f"ssd kernel needs CUDA tensors, got {xs.device}")
    if not all(t.device == xs.device for t in (dt, A, B_, C_)):
        raise ValueError("xs, dt, A, B_, C_ must be on one device")
    if xs.dtype not in DTYPES or not (B_.dtype == C_.dtype == xs.dtype):
        raise TypeError(f"xs, B_, C_ must share a dtype in {list(DTYPES)}: "
                        f"{xs.dtype}, {B_.dtype}, {C_.dtype}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise TypeError(f"dt and A must be float32: {dt.dtype}, {A.dtype}")
    if xs.dim() != 4:
        raise ValueError(f"want xs [B,S,H,P], got {tuple(xs.shape)}")
    B, S, H, P = xs.shape
    N = B_.shape[-1]
    if (tuple(dt.shape) != (B, S, H) or tuple(A.shape) != (H,)
            or tuple(B_.shape) != (B, S, N) or tuple(C_.shape) != (B, S, N)):
        raise ValueError(f"shape mismatch: xs {tuple(xs.shape)}, dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, B "
                         f"{tuple(B_.shape)}, C {tuple(C_.shape)}")
    if not (1 <= P <= MAX_P and 1 <= N <= MAX_N and S >= 1):
        raise ValueError(f"want P <= {MAX_P}, N <= {MAX_N}, S >= 1: "
                         f"P={P}, N={N}, S={S}")
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"chunk {chunk} not in [1, {MAX_CHUNK}]")
    if not (xs.stride(-1) == B_.stride(-1) == C_.stride(-1) == 1
            and A.is_contiguous()):
        raise ValueError("xs, B_, C_ need a contiguous last dim and A must "
                         "be contiguous")


def ssd(xs, dt, A, B_, C_, chunk: int = 128):
    """xs: [B,S,H,P], dt: [B,S,H] f32, A: [H] f32, B_/C_: [B,S,N] on the
    card.  Returns (y [B,S,H,P] in xs's dtype, final state [B,H,P,N] f32).
    Any S; the last chunk may be partial."""
    global launches
    _check(xs, dt, A, B_, C_, chunk)
    B, S, H, P = xs.shape
    N = B_.shape[-1]
    y = torch.empty((B, S, H, P), dtype=xs.dtype, device=xs.device)
    state = torch.empty((B, H, P, N), dtype=torch.float32, device=xs.device)
    stream = torch.cuda.current_stream(xs.device).cuda_stream
    rc = _fn()(xs.data_ptr(), dt.data_ptr(), A.data_ptr(), B_.data_ptr(),
               C_.data_ptr(), y.data_ptr(), state.data_ptr(),
               DTYPES[xs.dtype], B, S, H, P, N, int(chunk),
               *xs.stride()[:3], *dt.stride(), *B_.stride()[:2],
               *C_.stride()[:2], stream)
    _build.check(rc, "ssd")
    launches += 1
    return y, state
