"""The simulation mesh.  Counterpart of ``repro.launch.mesh``'s
``make_sim_mesh``; the production and test meshes of the dry run are
not ported (ROADMAP queue 1 item 11).

Like the reference's, this is a function, not a module constant:
importing it touches no device.
"""
from __future__ import annotations

from repro_torch.core.pdes import device_count, lane_mesh


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
