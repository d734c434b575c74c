"""Topology families: one padded build serving every sub-shape by mask.
Counterpart of ``repro.dse.family``.

A *topology family* replaces one-build-per-shape in structural sweeps:
the simulation is built once at the family's **maximum shape**
(``SimBuilder.build(pad_shape=...)`` sizes every kind's segments to the
maximum), and each concrete shape is selected at run time by the
``SimParams.inst_mask`` / ``conn_mask`` activity masks (DSE.md "Topology
families").

:class:`TopologyFamily` is the contract between a model's family-aware
builder (``repro_torch.sims.memsys.build_family``) and a sweep:

* ``kind_counts(shape)`` maps the model's shape axes (e.g. ``core=4``)
  to per-kind active instance counts for the engine's prefix masks;
* ``state_fn(shape)`` builds the padded initial ``SimState`` whose
  *active rows are bit-identical* to an unpadded build of that shape
  (masked rows are inert and pinned to ``next_tick = +inf``);
* ``params_for(shape, ...)`` attaches the masks to a ``SimParams``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.core import SimParams, SimState, Simulation


@dataclasses.dataclass
class TopologyFamily:
    """A padded maximum-shape build plus per-shape state/mask factories.

    ``shape_max`` names the family's shape axes and their maxima (the
    shape the topology was built at); ``kind_counts`` translates a shape
    assignment into per-kind active counts; ``state_fn`` builds the padded
    initial state for a shape.  Shape assignments may be partial: missing
    axes default to the family maximum.
    """

    sim: Simulation
    shape_max: dict[str, int]
    kind_counts: Callable[[dict], dict]
    state_fn: Callable[[dict], SimState]

    def full_shape(self, shape: dict | None = None) -> dict:
        shape = dict(shape or {})
        unknown = set(shape) - set(self.shape_max)
        if unknown:
            raise ValueError(
                f"unknown shape axes {sorted(unknown)} "
                f"(family axes: {sorted(self.shape_max)})")
        for name, mx in self.shape_max.items():
            v = int(shape.get(name, mx))
            if not 1 <= v <= mx:
                raise ValueError(
                    f"shape.{name}={v} outside this family's range "
                    f"[1, {mx}]")
            shape[name] = v
        return shape

    def masks(self, shape: dict | None = None):
        """``(inst_mask, conn_mask)`` prefix activity masks for a shape."""
        return self.sim.prefix_masks(self.kind_counts(self.full_shape(shape)))

    def params_for(self, shape: dict | None = None,
                   base: SimParams | None = None,
                   masks: tuple | None = None) -> SimParams:
        """``base`` (default: the build-time params) with the shape's
        activity masks attached."""
        base = self.sim.default_params() if base is None else base
        inst, conn = self.masks(shape) if masks is None else masks
        return dataclasses.replace(base, inst_mask=inst, conn_mask=conn)

    def state_for(self, shape: dict | None = None,
                  masks: tuple | None = None) -> SimState:
        """Padded initial state for a shape: the model's ``state_fn``
        output with masked-off rows pinned to ``next_tick = +inf`` (so
        they never enter the engine's next-event min)."""
        shape = self.full_shape(shape)
        st = self.state_fn(shape)
        inst, _ = self.masks(shape) if masks is None else masks
        alive = self.sim._flat_inst_mask(inst)
        return dataclasses.replace(
            st, next_tick=torch.where(alive, st.next_tick, float("inf")))
