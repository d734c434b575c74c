"""Component kinds (Akita §3.1 'Component' + §3.2 'TickingComponent').
Counterpart of ``repro.core.component``.

A *kind* is a class of components (cores, caches, DRAM controllers...); the
*instances* of a kind are rows of a batched state pytree and are executed with
``vmap`` — the SPMD analogue of Akita running many component objects.

The developer-facing contract is Akita's: implement one ``tick_fn`` that takes
the instance state, its :class:`~repro.core.ports.Ports` view and the current
virtual time, and returns the new state, new ports and whether the tick made
*forward progress*.  Everything else — sleeping, wakeups, scheduling, parallel
execution — is the engine's job (paper Fig. 3).

``tick_fn(state, ports, t) -> (state, ports, progress)`` or
``tick_fn(state, ports, t) -> (state, ports, TickResult(progress, next_time))``

A kind may additionally opt in to *traced model parameters* by declaring a
``params`` pytree: its ``tick_fn`` then takes a 4th argument —
``tick_fn(state, ports, t, params)`` — holding that pytree (shared by all
instances of the kind, i.e. broadcast under the instance vmap).  Declared
defaults are baked into ``Simulation.default_params()`` and can be
overridden per ``run()`` — or batched over by ``repro.dse`` — without
rebuilding or recompiling (see DSE.md).

``next_time`` (optional, -1 = unset) requests a wake at an arbitrary future
virtual time — this is the pure event-driven escape hatch (used by TrioSim to
fast-forward over operator execution) that Smart Ticking layers on top of.

Contract required for exact smart==naive equivalence (and honored by all
first-party components): a tick that returns ``progress=False`` must leave the
instance state and ports unchanged.

In the port, ``tick_fn`` is written with torch ops on 0-d and small tensors
and runs under ``torch.func.vmap``; it must not branch in Python on a
tensor's value.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from .message import const


@dataclasses.dataclass(frozen=True)
class TickResult:
    progress: torch.Tensor                 # bool scalar
    next_time: torch.Tensor | None = None  # f32 scalar, <0 = default scheduling

    @staticmethod
    def make(progress, next_time=None):
        nt = const(-1.0 if next_time is None else next_time, torch.float32)
        return TickResult(const(progress, torch.bool), nt)


def normalize_tick_output(out) -> tuple[Any, Any, TickResult]:
    state, ports, res = out
    if not isinstance(res, TickResult):
        res = TickResult.make(res)
    elif res.next_time is None:
        res = TickResult.make(res.progress)
    return state, ports, res


@dataclasses.dataclass
class ComponentKind:
    """Static description of one component kind."""

    name: str
    tick_fn: Callable
    n_instances: int
    n_ports: int
    init_state: Any                      # pytree, leaves [N, ...]
    period: float | Any = 1.0            # scalar or [N] — cycle length
    cap: int | Any = 4                   # scalar, [P], or [N, P] buffer capacity
    start_asleep: bool = False           # if True, wait for a message to start
    params: Any = None                   # opt-in traced model params pytree;
    #                                      non-None => tick_fn is 4-ary

    @property
    def n_ports_total(self) -> int:
        """Size of this kind's port-state segment (``n_instances*n_ports``,
        instance-major) — see the engine's segmented ``SimState`` layout."""
        return self.n_instances * self.n_ports

    def periods(self):
        p = np.asarray(self.period, np.float32)
        if p.ndim == 0:
            p = np.full((self.n_instances,), float(p), np.float32)
        assert p.shape == (self.n_instances,)
        return p

    def caps(self):
        c = np.asarray(self.cap, np.int32)
        if c.ndim == 0:
            c = np.full((self.n_instances, self.n_ports), int(c), np.int32)
        elif c.ndim == 1:
            c = np.broadcast_to(c[None, :], (self.n_instances, self.n_ports)).copy()
        assert c.shape == (self.n_instances, self.n_ports)
        return c


@dataclasses.dataclass(frozen=True)
class KindHandle:
    """Returned by ``SimBuilder.add_kind``; names ports for ``connect``."""

    name: str
    index: int

    def port(self, instance: int, port: int = 0):
        return (self.name, instance, port)
