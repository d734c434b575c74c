"""Gradient compression: int8 error-feedback all-reduce.  Counterpart of
``repro.optim.compress``.

Each rank quantizes its gradient to int8 (per-tensor scale), the int8
payload is summed in int32 across the data-parallel ranks and
dequantized: 4x fewer bytes on the wire than f32.  The quantization
error is fed back into the next step's gradient (error feedback).  The
reference runs this inside ``shard_map`` with ``pmax``/``psum``; the port
uses ``torch.distributed`` (``all_reduce`` MAX for the scale, SUM in
int32 for the payload) over ``group`` when a process group is
initialised, and at world 1 (no process group) the reduction is the
identity, as the reference's one-device mesh is.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.core.engine import ref_map

from .adamw import tree_unzip


def quant_int8(g):
    scale = torch.amax(torch.abs(g)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def dequant_int8(q, scale):
    return q.float() * scale


def _world(group):
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(group)
    return 1


@torch.no_grad()
def int8_allreduce_grads(grads, err, group=None):
    """All-reduce-mean of each rank's gradient tree in int8 with error
    feedback.  ``err`` is the error-feedback state (the same tree).
    Returns (reduced, new_err)."""
    n = _world(group)

    def one(g, e):
        gf = g.float() + e
        q, s = quant_int8(gf)
        new_e = gf - dequant_int8(q, s)
        # wire format: the int8 payload summed in int32 plus one f32 scale
        # a tensor; each rank's payload is rescaled to the largest scale
        # before the integer sum
        s_max = s.clone()
        if n > 1:
            dist.all_reduce(s_max, op=dist.ReduceOp.MAX, group=group)
        q_resc = torch.round(q.float() * (s / s_max)).to(torch.int32)
        if n > 1:
            dist.all_reduce(q_resc, op=dist.ReduceOp.SUM, group=group)
        red = q_resc.float() * s_max / n
        return red.to(g.dtype), new_e

    reduced, new_err = tree_unzip(ref_map(one, grads, err), 2)
    return reduced, new_err
