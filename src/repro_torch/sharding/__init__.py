"""Sharding (PyTorch port): the fleet/cell axis on one card
(``sharding/fleet.py``). ``partition.py`` and ``runtime.py`` are not
ported yet (ROADMAP item 11)."""
from repro_torch.sharding.fleet import (
    FLEET_AXIS,
    fleet_mesh,
    pad_to_devices,
    replicate,
    shard_leading_axis,
)

__all__ = [
    "FLEET_AXIS", "fleet_mesh", "pad_to_devices", "replicate",
    "shard_leading_axis",
]
