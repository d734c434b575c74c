"""Launcher of the CUDA SSD chunk-scan kernels.

The port's counterpart of ``repro.kernels.ssd.kernel``: it takes tensors
on the card only, checks what the kernels accept, allocates the outputs
and launches on the current stream.  The dtype of xs, B and C
alone chooses the kernel (:func:`entry`): bf16 runs on the tensor cores by
wgmma (``csrc/ssd_tc.cu``), f32 on the tensor cores in three TF32 passes
of mma.sync (``csrc/ssd.cu``), which keep the f32 tolerance that one TF32
pass misses; each is one launch per call.  There is no fallback from one
to the other, nor to the plain version.  ``launches`` counts the calls
that launched, so a run can show that its prefill went through the
kernels.

The bf16 kernel reads x, B and C and writes y by TMA, which needs 16-byte
aligned bases and strides (``_tma``): a view that breaks the rule is
copied, and a P or N that is not a multiple of 8 is zero-padded to one
(``_tma.copies`` counts both); y is then written [B,S,H,round8(P)] and
returned sliced to P.  The f32 kernel reads any view in place (by
cp.async, 16 bytes at a time where the rows are 16-byte aligned, else 4).
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build, _tma

launches = 0

# dtype -> (library in csrc/, C entry point); the bf16 entry takes one
# more pointer, a scratch that its single pass no longer uses (NULL)
ENTRIES = {torch.bfloat16: ("ssd_tc", "ssd_forward_tc"),
           torch.float32: ("ssd", "ssd_forward")}
DTYPES = tuple(ENTRIES)
MAX_P, MAX_N, MAX_CHUNK = 64, 128, 1024

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def entry(dtype: torch.dtype) -> tuple[str, str]:
    """The kernel that computes ``dtype``: (library, C function)."""
    if dtype not in ENTRIES:
        raise TypeError(f"ssd kernels take {list(ENTRIES)}, not {dtype}")
    return ENTRIES[dtype]


def _fn(dtype, n_ptrs):
    lib, name = entry(dtype)
    fn = getattr(_build.load(lib), name)
    fn.argtypes = [_P] * n_ptrs + [_I] * 6 + [_L] * 10 + [_P]
    fn.restype = ctypes.c_int
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
    Py = P
    if xs.dtype == torch.bfloat16:    # TMA reads x, B, C and writes y
        Py = _tma.round_up(P)
        xs = _tma.operand(xs, Py)
        B_, C_ = (_tma.operand(t, _tma.round_up(N)) for t in (B_, C_))
    y = torch.empty((B, S, H, Py), dtype=xs.dtype, device=xs.device)
    state = torch.empty((B, H, P, N), dtype=torch.float32, device=xs.device)
    ptrs = [t.data_ptr() for t in (xs, dt, A, B_, C_, y, state)]
    if xs.dtype == torch.bfloat16:
        ptrs.append(None)
    stream = torch.cuda.current_stream(xs.device).cuda_stream
    rc = _fn(xs.dtype, len(ptrs))(
        *ptrs, B, S, H, P, N, int(chunk), *xs.stride()[:3], *dt.stride(),
        *B_.stride()[:2], *C_.stride()[:2], stream)
    _build.check(rc, "ssd")
    launches += 1
    return (y if Py == P else y[..., :P]), state
