"""The fleet/cell batch axis on one card.

Counterpart of ``repro/sharding/fleet.py``, whose 1-D mesh splits a
sweep's cells (or a driver's fleets) over the local devices. The port
runs on one card: ``fleet_mesh()`` returns ``None`` (the reference's
single-device answer) and the helpers are the identity for it, so
callers keep the reference's shape. A mesh over several cards is ROADMAP
item 11 (sharding).
"""
from __future__ import annotations

from typing import Optional

FLEET_AXIS = "fleet"


def fleet_mesh(n_devices: Optional[int] = None) -> None:
    """``None``: the port's sweeps run on one device. More than one
    raises ``NotImplementedError``."""
    if n_devices is not None and n_devices > 1:
        raise NotImplementedError(
            f"a fleet mesh over {n_devices} devices: the port runs on one "
            f"card (ROADMAP item 11: sharding)")
    return None


def pad_to_devices(n_items: int, mesh) -> int:
    """Smallest count >= n_items divisible by the mesh's device count:
    ``n_items`` itself without a mesh."""
    if mesh is None:
        return n_items
    d = mesh.devices.size
    return ((n_items + d - 1) // d) * d


def shard_leading_axis(tree, mesh):
    """Split every leaf's leading axis over the mesh; ``mesh=None`` (the
    port's only mesh) returns ``tree`` untouched."""
    if mesh is not None:
        raise NotImplementedError("sharding over a mesh (ROADMAP item 11)")
    return tree


def replicate(tree, mesh):
    """Replicate every leaf across the mesh (no-op when ``mesh`` is None)."""
    if mesh is not None:
        raise NotImplementedError("sharding over a mesh (ROADMAP item 11)")
    return tree
