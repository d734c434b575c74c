"""Meshes.  Counterpart of ``repro.launch.mesh``.

Single pod: 16x16 = 256 devices ("data", "model").
Multi-pod:  2x16x16 = 512 devices ("pod", "data", "model") -- "pod" is the
outer data-parallel/FSDP axis.

The production and test meshes are *logical*: axis names and sizes and no
devices, as JAX's ``AbstractMesh`` has none.  The dry run
(``repro_torch.launch.dryrun``) plans a step on them; nothing is placed.
The sim mesh names real placements for the sharded PDES.

Like the reference's, these are functions, not module constants:
importing this module touches no device.
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.core.pdes import device_count, lane_mesh


@dataclasses.dataclass(frozen=True)
class LogicalMesh:
    """Axis names and sizes of a mesh, with no devices: ``shape[name]``,
    ``axis_names``, ``axis_sizes`` and ``size`` as JAX's meshes give
    them."""
    axis_sizes: tuple
    axis_names: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)


def make_production_mesh(*, multi_pod: bool = False) -> LogicalMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return LogicalMesh(shape, axes)


def make_test_mesh(*, multi_pod: bool = False) -> LogicalMesh:
    """The tiny meshes of the reference's 8-fake-device tests."""
    shape = (2, 2, 2) if multi_pod else (2, 2)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return LogicalMesh(shape, axes)


def make_sim_mesh(n: int | None = None, device=None):
    """1-D mesh over ``n`` placements (all by default) for the
    sharded-PDES engine workload: a tuple of ``torch.device``s
    (``core.pdes.lane_mesh``).  ``device=None`` names the cards.  Asking
    for more placements than there are raises, as the reference's
    ``jax.make_mesh`` does; ``REPRO_TORCH_FORCE_DEVICES`` adds them."""
    have = device_count(device if device is not None else "cuda")
    n = n or have
    if n > have:
        raise ValueError(
            f"a sim mesh of {n} needs {n} placements, {have} available "
            f"(set REPRO_TORCH_FORCE_DEVICES={n} to place several on one "
            "device)")
    return lane_mesh(n, "sim", device)
