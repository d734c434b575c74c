"""Batched ring-buffer ports (Akita §3.1 'Port').
Counterpart of ``repro.core.ports``.

Each port owns an incoming and an outgoing FIFO ring buffer.  Globally, all
ports of all component instances live in flat tensors indexed by a *global
port id* so connections can deliver with pure gather/select ops.  A
component's ``tick_fn`` sees only its own instance's slice through the
:class:`Ports` view, whose ``recv``/``send``/``peek`` mirror Akita's port
API — functional (they return a new view) but reading like cycle-based
code.

Send rejects when the outgoing buffer is full (returns ``ok=False``) exactly
like Akita; the engine uses the resulting full/not-full transitions for Smart
Ticking rule 2 and Availability Backpropagation.

Every update builds new tensors: the engine runs ``tick_fn`` under
``torch.func.vmap``, where writing in place into a tensor that the vmap
sees as unbatched is an error.  Ring-buffer reads and writes at the
(dynamic) head and tail positions are one-hot selects over the tiny ``CAP``
axis, as in the reference.
"""
from __future__ import annotations

import dataclasses

import torch

from .message import W_DST, W_SRC, W_TIME, const, i2f

EPS = 1e-3


def oh_set(arr, ix, val, when=True):
    """Scatter-free ``arr.at[ix].set(val)`` for a *traced* index on a tiny
    leading axis: a one-hot compare over ``axis 0`` plus a masked select.

    Component ``tick_fn``s should use this helper for dynamic single-row
    updates of small state tables (cache tag arrays, register scoreboards,
    ...).  Out-of-range indices are *dropped* (no row matches the one-hot),
    which makes a past-the-end index a safe "no update" sentinel.

    ``when=False`` makes the call a no-op (keeps the progress=False
    "unchanged state" contract easy to honor).
    """
    oh = torch.arange(arr.shape[0], device=arr.device) == ix
    if when is not True:
        oh = oh & when
    oh = oh.reshape((arr.shape[0],) + (1,) * (arr.ndim - 1))
    return torch.where(oh, const(val, arr.dtype), arr)


def take(arr, ix):
    """``arr[ix]`` for a *traced* index, with the reference's gather
    semantics: a negative index counts from the end, and an index still out
    of range is clamped to the nearest row.  (A torch gather raises there,
    on the card by a device assert that ends the process.)"""
    n = arr.shape[0]
    ix = torch.where(ix < 0, ix + n, ix).clamp(0, n - 1)
    return arr[ix]


def _set_row(arr, p: int, row):
    """``arr`` with row ``p`` (a static index) replaced by ``row``."""
    row = row.unsqueeze(0)
    if arr.shape[0] == 1:
        return row
    return torch.cat([arr[:p], row, arr[p + 1:]])


@dataclasses.dataclass(frozen=True)
class Ports:
    """Per-instance view over this component's ports.

    Tensors are shaped ``[P, ...]`` where ``P`` is the number of ports the
    component kind declares.  ``t`` is the current virtual time (cycles).
    """

    in_buf: torch.Tensor    # [P, CAP, W] i32
    in_head: torch.Tensor   # [P] i32
    in_cnt: torch.Tensor    # [P] i32
    out_buf: torch.Tensor   # [P, CAP, W] i32
    out_head: torch.Tensor  # [P] i32
    out_cnt: torch.Tensor   # [P] i32
    cap: torch.Tensor       # [P] i32 logical capacity (<= physical CAP)
    gid: torch.Tensor       # [P] i32 global port ids
    peer: torch.Tensor      # [P] i32 default peer port id (-1 if ambiguous)
    t: torch.Tensor         # scalar f32

    @property
    def _cap_phys(self):
        return self.in_buf.shape[1]

    def _acap(self):
        return torch.arange(self._cap_phys, dtype=torch.int32,
                            device=self.in_buf.device)

    # -- incoming ---------------------------------------------------------
    def peek(self, p):
        """Return (msg, ok) for the head of port ``p``'s incoming buffer.

        ``ok`` is False when the buffer is empty or the head message has not
        yet arrived (its connection-stamped ready time is in the future).
        """
        row = self.in_buf[p]                            # [CAP, W]
        oh = self.in_head[p] == self._acap()
        msg = torch.sum(torch.where(oh[:, None], row, 0), dim=0,
                        dtype=torch.int32)
        ok = (self.in_cnt[p] > 0) & (i2f(msg[W_TIME]) <= self.t + EPS)
        return msg, ok

    def recv(self, p, when=True):
        """Pop the head message of port ``p`` if present+ready and ``when``."""
        msg, ok = self.peek(p)
        if when is not True:
            ok = ok & when
        oki = ok.to(torch.int32)
        new = dataclasses.replace(
            self,
            in_head=_set_row(self.in_head, p,
                             (self.in_head[p] + oki) % self._cap_phys),
            in_cnt=_set_row(self.in_cnt, p, self.in_cnt[p] - oki),
        )
        return msg, ok, new

    # -- outgoing ---------------------------------------------------------
    def can_send(self, p):
        return self.out_cnt[p] < self.cap[p]

    def send(self, p, msg, when=True):
        """Append ``msg`` to port ``p``'s outgoing buffer (rejects if full).

        Fills the source field and resolves ``dst < 0`` to the port's default
        peer.  Returns ``(new_ports, ok)``.
        """
        ok = self.can_send(p)
        if when is not True:
            ok = ok & when
        oki = ok.to(torch.int32)
        dst = torch.where(msg[W_DST] < 0, self.peer[p], msg[W_DST])
        msg = torch.cat([msg[:W_SRC], self.gid[p].reshape(1), dst.reshape(1),
                         msg[W_DST + 1:]])
        tail = (self.out_head[p] + self.out_cnt[p]) % self._cap_phys
        row = self.out_buf[p]                           # [CAP, W]
        oh = (tail == self._acap()) & ok
        row = torch.where(oh[:, None], msg[None, :], row)
        new = dataclasses.replace(
            self,
            out_buf=_set_row(self.out_buf, p, row),
            out_cnt=_set_row(self.out_cnt, p, self.out_cnt[p] + oki),
        )
        return new, ok

    def in_level(self, p):
        return self.in_cnt[p]

    def out_level(self, p):
        return self.out_cnt[p]

