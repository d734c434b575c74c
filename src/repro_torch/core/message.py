"""Fixed-width message records (Akita §3.1 'Message').
Counterpart of ``repro.core.message``.

Messages are pure-data int32 records of ``MSG_WORDS`` words:

  w0  opcode      user-defined message/opcode id (0 is reserved: empty slot)
  w1  src port    global port id (filled by ``Ports.send``)
  w2  dst port    global port id (-1 = "use the port's default peer")
  w3  ready time  f32 virtual time, bitcast into i32 (stamped by the connection)
  w4..w7          payload words (user-defined; bitcast floats if needed)

Constants are made with ``torch.full``, never ``torch.tensor``: a fill is a
kernel that a CUDA graph can capture, where ``torch.tensor`` copies from
the host.  The engine runs tick functions under ``torch.device(dev)``, so
the fills land on the simulation's device.
"""
from __future__ import annotations

import functools

import torch

MSG_WORDS = 8
_PAYLOAD0 = 4
N_PAYLOAD = MSG_WORDS - _PAYLOAD0

# Word indices.
W_OP = 0
W_SRC = 1
W_DST = 2
W_TIME = 3


def const(x, dtype):
    """``x`` as a tensor of ``dtype``: a tensor is cast, a Python scalar
    becomes a 0-d fill on the default device."""
    if isinstance(x, torch.Tensor):
        return x.to(dtype)
    return torch.full((), x, dtype=dtype)


@torch.library.custom_op("repro_torch::bitcast", mutates_args=())
def _bitcast_op(x: torch.Tensor, to_float: bool) -> torch.Tensor:
    return x.view(torch.float32 if to_float else torch.int32).clone()


@_bitcast_op.register_fake
def _(x, to_float):
    return torch.empty_like(x, dtype=torch.float32 if to_float
                            else torch.int32)


@_bitcast_op.register_vmap
def _(info, in_dims, x, to_float):
    # elementwise: the batch dimension stays where it is
    return _bitcast_op(x, to_float), in_dims[0]


@functools.cache
def _vmap_has_view_dtype() -> bool:
    """Whether this PyTorch has a batching rule for ``view.dtype``."""
    try:
        torch.func.vmap(lambda v: v.view(torch.float32))(
            torch.zeros((1, 1), dtype=torch.int32, device="cpu"))
    except RuntimeError:
        return False
    return True


def _bitcast(x, dtype):
    """``x.view(dtype)`` between the 32-bit types.  Under ``vmap``, on a
    PyTorch without a batching rule for ``view.dtype``, it goes through a
    custom op that copies."""
    if torch._C._functorch.is_batchedtensor(x) and \
            not _vmap_has_view_dtype():
        return _bitcast_op(x, dtype == torch.float32)
    return x.view(dtype)


def f2i(x):
    """Bitcast float32 -> int32 (for storing times/floats in payload words)."""
    return _bitcast(const(x, torch.float32), torch.int32)


def i2f(x):
    """Bitcast int32 -> float32."""
    return _bitcast(const(x, torch.int32), torch.float32)


def msg_new(opcode, dst=-1, p0=0, p1=0, p2=0, p3=0):
    """Build a message. ``dst`` < 0 means "send to the port's default peer"."""
    return torch.stack([const(v, torch.int32)
                        for v in (opcode, -1, dst, 0, p0, p1, p2, p3)])


def msg_reply(msg, opcode, p0=0, p1=0, p2=0, p3=0):
    """Build a reply addressed to the sender of ``msg``."""
    return msg_new(opcode, dst=msg[W_SRC], p0=p0, p1=p1, p2=p2, p3=p3)


def opcode(msg):
    return msg[..., W_OP]


def payload(msg, i):
    return msg[..., _PAYLOAD0 + i]


def ready_time(msg):
    return i2f(msg[..., W_TIME])
