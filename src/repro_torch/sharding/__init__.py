"""Sharding (PyTorch port): the fleet/cell axis on one card
(``sharding/fleet.py``). The reference's ``partition.py`` (param and cache
partition specs over a TPU mesh) and ``runtime.py`` (its mesh toggles) are
not ported, by design: one card has no mesh to partition over, and the
port's remat is ``cfg.remat`` (ROADMAP, "Deliberate differences")."""
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
