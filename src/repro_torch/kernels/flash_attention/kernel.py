"""Launcher of the CUDA flash-attention kernels.

The port's counterpart of ``repro.kernels.flash_attention.kernel``: it
takes tensors on the card only, checks what the kernels accept, allocates
the output and launches on the current stream.  The dtype alone chooses
the kernel (:func:`entry`): bf16 runs on the tensor cores by wgmma
(``csrc/flash_attention_tc.cu``), f32 on the tensor cores in three TF32
passes of mma.sync (``csrc/flash_attention.cu``), which keep the f32
tolerance that one TF32 pass misses.  There is no fallback from one to the
other, nor to the plain version.  ``launches`` counts the calls that
launched, so a run can show that its prefill went through the kernels;
``launches_by_dtype`` splits the same count by the dtype (the kernel) that
launched.

The kernels are built for the head dims in ``HEAD_DIMS``; any other head
dim up to the largest runs on the next one up (:func:`pad_head_dim`): q, k
and v are zero-padded along the head dim, the scale stays
``1/sqrt(hd)`` of the unpadded dim, and the output is sliced back.  Zero
columns add nothing to q·k, so the scores, the softcap and the softmax
are unchanged, and the padded columns of v come out as zeros.

The bf16 kernel reads q, k and v and writes the output by TMA, which needs
16-byte aligned bases and strides (``_tma``): a view that breaks the rule
is copied (``_tma.copies`` counts it); nothing else changes route.  The
f32 kernel reads any view in place (by cp.async, 16 bytes at a time where
k's and v's rows are 16-byte aligned, else 4).  Its
grid is chosen by the C launcher (``fa_plan`` in the source); :func:`plan`
is that rule's mirror for tests and logs, and launches nothing
(``chip_smoke.py`` holds it to the C rule on the card).
"""
from __future__ import annotations

import ctypes
import math

import torch

from .. import _build, _tma

launches = 0
launches_by_dtype = {"bfloat16": 0, "float32": 0}

# dtype -> (library in csrc/, C entry point); both take the same arguments
ENTRIES = {torch.bfloat16: ("flash_attention_tc", "fa_forward_tc"),
           torch.float32: ("flash_attention", "fa_forward")}
DTYPES = tuple(ENTRIES)
HEAD_DIMS = (16, 32, 64, 80, 128)   # 80: hubert-xlarge

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
_ARGTYPES = [_P] * 4 + [_I] * 6 + [_L] * 12 + [_I, _I, _F, _F, _P]


# the bf16 kernel's block: 128 query rows, (position, head) pairs of up to
# MAX_PACKED query heads of one KV group
BLOCK_ROWS, MAX_PACKED = 128, 16


def plan(B: int, Sq: int, H: int, KV: int, sms: int) -> dict:
    """The bf16 kernel's grid for these shapes on a card of ``sms`` SMs, a
    mirror of ``fa_plan`` in ``csrc/flash_attention_tc.cu`` (which is what
    launches) for tests and logs: ``heads`` query heads of one KV group a
    block (the largest divisor of H/KV up to MAX_PACKED), ``positions``
    positions of them (its BLOCK_ROWS rows), and ``split`` when those
    blocks are fewer than the SMs: then a block takes half the rows and
    its two consumer warpgroups split the key tiles."""
    if B < 1 or Sq < 1 or KV < 1 or H % KV:
        raise ValueError(f"no plan for B={B} Sq={Sq} H={H} KV={KV}")
    G = H // KV
    heads = max(d for d in range(1, min(G, MAX_PACKED) + 1) if G % d == 0)

    def blocks(rows):
        npos = rows // heads
        return B * KV * (G // heads) * -(-Sq // npos), npos
    n, npos = blocks(BLOCK_ROWS)
    split = n < sms
    if split:
        n, npos = blocks(BLOCK_ROWS // 2)
    return dict(split=split, heads=heads, positions=npos, blocks=n)


def padded_head_dim(hd: int) -> int:
    """The smallest head dim in ``HEAD_DIMS`` that holds ``hd``."""
    for d in HEAD_DIMS:
        if 1 <= hd <= d:
            return d
    raise ValueError(f"head dim {hd}: the flash-attention kernels take 1 to "
                     f"{HEAD_DIMS[-1]}")


def pad_head_dim(q, k, v):
    """q, k and v zero-padded along their last (head) dim to
    :func:`padded_head_dim`; tensors already at a built head dim are
    returned as they are."""
    hd = q.shape[-1]
    pad = padded_head_dim(hd) - hd
    if not pad:
        return q, k, v
    return tuple(torch.nn.functional.pad(x, (0, pad)) for x in (q, k, v))


def entry(dtype: torch.dtype) -> tuple[str, str]:
    """The kernel that computes ``dtype``: (library, C function)."""
    if dtype not in ENTRIES:
        raise TypeError(f"flash_attention kernels take {list(ENTRIES)}, "
                        f"not {dtype}")
    return ENTRIES[dtype]


def _fn(dtype):
    lib, name = entry(dtype)
    fn = getattr(_build.load(lib), name)
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    return fn


def _check(q, k, v):
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention kernel needs CUDA tensors, got "
                         f"{q.device}")
    if not (k.device == v.device == q.device):
        raise ValueError("q, k, v must be on one device")
    if q.dtype not in DTYPES or not (k.dtype == v.dtype == q.dtype):
        raise TypeError(f"q, k, v must share a dtype in "
                        f"{list(DTYPES)}: {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"want q [B,Sq,H,hd], k/v [B,Sk,KV,hd]: "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, Sq, H, hd = q.shape
    Bk, Sk, KV, hdk = k.shape
    if Bk != B or hdk != hd or KV == 0 or H % KV:
        raise ValueError(f"batch/head mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}")
    padded_head_dim(hd)
    if Sq < 1 or Sk < 1:
        raise ValueError("empty sequence")
    if not (q.stride(-1) == k.stride(-1) == v.stride(-1) == 1):
        raise ValueError("the head dim must be contiguous")


def flash_attention(q, k, v, *, causal=True, window=0, cap=0.0, scale=None):
    """q: [B,Sq,H,hd]; k, v: [B,Sk,KV,hd] on the card -> [B,Sq,H,hd].

    Self-attention positions (iota).  ``window`` > 0 is a sliding window,
    ``cap`` > 0 a tanh logit softcap; ``scale`` defaults to 1/sqrt(hd).
    A head dim outside ``HEAD_DIMS`` runs padded (:func:`pad_head_dim`).
    """
    global launches
    _check(q, k, v)
    hd = q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    q, k, v = pad_head_dim(q, k, v)
    if q.dtype == torch.bfloat16:     # TMA reads them
        q, k, v = (_tma.operand(t) for t in (q, k, v))
    B, Sq, H, hdp = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    out = torch.empty((B, Sq, H, hdp), dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _fn(q.dtype)(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      out.data_ptr(), B, Sq, Sk, H, KV, hdp,
                      *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                      *out.stride()[:3], int(bool(causal)), int(window),
                      float(scale), float(cap), stream)
    _build.check(rc, "flash_attention")
    launches += 1
    launches_by_dtype[str(q.dtype).removeprefix("torch.")] += 1
    return out[..., :hd]
