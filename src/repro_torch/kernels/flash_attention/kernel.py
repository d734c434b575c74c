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

Training's bf16 path has a backward kernel too (``fa_tc_bwd`` in
``csrc/flash_attention_tc.cu``): :func:`flash_attention_lse` is the
forward that also returns each row's log-sum-exp (a second C entry point,
``fa_forward_tc_lse``, that launches a compile-time variant of the
forward, so serving's kernel is untouched), and
:func:`flash_attention_bwd` computes dq, dk and dv from it.
``bwd_launches`` counts the backward calls that launched; the forward
with the log-sum-exp counts in ``launches`` as any forward.
"""
from __future__ import annotations

import ctypes
import math

import torch

from .. import _build, _tma

launches = 0
launches_by_dtype = {"bfloat16": 0, "float32": 0}
bwd_launches = 0

# dtype -> (library in csrc/, C entry point); both take the same arguments
ENTRIES = {torch.bfloat16: ("flash_attention_tc", "fa_forward_tc"),
           torch.float32: ("flash_attention", "fa_forward")}
DTYPES = tuple(ENTRIES)
HEAD_DIMS = (16, 32, 64, 80, 128)   # 80: hubert-xlarge

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
_ARGTYPES = [_P] * 4 + [_I] * 6 + [_L] * 12 + [_I, _I, _F, _F, _P]
# bf16 alone: the forward that also writes the log-sum-exp, the backward
LSE_ENTRY = ("flash_attention_tc", "fa_forward_tc_lse")
BWD_ENTRY = ("flash_attention_tc", "fa_backward_tc")
_LSE_ARGTYPES = _ARGTYPES[:-1] + [_P, _P]
_BWD_ARGTYPES = [_P] * 11 + [_I] * 6 + [_L] * 15 + [_I, _I, _F, _F, _P]


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


def _fn(which, argtypes=_ARGTYPES):
    lib, name = which
    fn = getattr(_build.load(lib), name)
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
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
    return _forward(q, k, v, causal, window, cap, scale, False)[0]


def flash_attention_lse(q, k, v, *, causal=True, window=0, cap=0.0,
                        scale=None):
    """:func:`flash_attention` in bf16 that also returns each row's
    log-sum-exp, f32 [B,H,Sq] (natural log, over the scaled, capped and
    masked scores): the state :func:`flash_attention_bwd` takes."""
    if q.dtype != torch.bfloat16:
        raise TypeError(f"the log-sum-exp forward takes bfloat16, not "
                        f"{q.dtype}")
    return _forward(q, k, v, causal, window, cap, scale, True)


def _forward(q, k, v, causal, window, cap, scale, with_lse):
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
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Sq,
            Sk, H, KV, hdp, *q.stride()[:3], *k.stride()[:3],
            *v.stride()[:3], *out.stride()[:3], int(bool(causal)),
            int(window), float(scale), float(cap))
    lse = None
    if with_lse:
        lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
        rc = _fn(LSE_ENTRY, _LSE_ARGTYPES)(*args, lse.data_ptr(), stream)
    else:
        rc = _fn(entry(q.dtype))(*args, stream)
    _build.check(rc, "flash_attention")
    launches += 1
    launches_by_dtype[str(q.dtype).removeprefix("torch.")] += 1
    return out[..., :hd], lse


def flash_attention_bwd(q, k, v, out, lse, dout, *, causal=True, window=0,
                        cap=0.0, scale=None):
    """The bf16 backward kernel: (dq, dk, dv) of :func:`flash_attention`
    at q, k, v for the upstream gradient ``dout``, from its output
    ``out`` and log-sum-exp ``lse`` (:func:`flash_attention_lse`).
    Takes what the bf16 forward takes (any S, window, softcap, GQA, the
    head dims of ``HEAD_DIMS``, others padded and the gradients sliced
    back) and raises on anything else; there is no fallback."""
    global bwd_launches
    _check(q, k, v)
    B, Sq, H, hd = q.shape
    if q.dtype != torch.bfloat16:
        raise TypeError(f"the backward kernel takes bfloat16, not {q.dtype}")
    for name, t in (("out", out), ("dout", dout)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} must be a {tuple(q.shape)} "
                             f"{q.dtype} tensor on {q.device}: "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
    if (lse.shape != (B, H, Sq) or lse.dtype != torch.float32
            or lse.device != q.device or not lse.is_contiguous()):
        raise ValueError(f"lse must be a contiguous float32 [{B},{H},{Sq}] "
                         f"tensor on {q.device}: {tuple(lse.shape)} "
                         f"{lse.dtype}")
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    Sk, KV = k.shape[1], k.shape[2]
    q, k, v = pad_head_dim(q, k, v)
    hdp = q.shape[-1]
    if hdp != hd:
        out, dout = (torch.nn.functional.pad(t, (0, hdp - hd))
                     for t in (out, dout))
    q, k, v, dout = (_tma.operand(t) for t in (q, k, v, dout))
    if out.stride(-1) != 1:
        out = out.contiguous()
    f32, dev = torch.float32, q.device
    dsum = torch.empty((B, H, Sq), dtype=f32, device=dev)
    dq_sum = torch.empty((B, Sq, H, hdp), dtype=f32, device=dev)
    dq = torch.empty((B, Sq, H, hdp), dtype=q.dtype, device=dev)
    dk = torch.empty((B, Sk, KV, hdp), dtype=q.dtype, device=dev)
    dv = torch.empty_like(dk)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _fn(BWD_ENTRY, _BWD_ARGTYPES)(
        *(t.data_ptr() for t in (q, k, v, out, dout, lse, dsum, dq_sum, dq,
                                 dk, dv)),
        B, Sq, Sk, H, KV, hdp, *q.stride()[:3], *k.stride()[:3],
        *v.stride()[:3], *out.stride()[:3], *dout.stride()[:3],
        int(bool(causal)), int(window), float(scale), float(cap), stream)
    _build.check(rc, "flash_attention backward")
    bwd_launches += 1
    return dq[..., :hd], dk[..., :hd], dv[..., :hd]
