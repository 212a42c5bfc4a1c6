"""Sharding (PyTorch port): the fleet/cell/member axis over the cards
(``sharding/fleet.py``: a 1-D ``DeviceMesh`` over a ``torch.distributed``
process group, one rank per card), the LM partition rules as per-dim
specs and DTensor placements (``sharding/partition.py``) and their
``REPRO_OPT`` toggles and block-boundary activation constraint
(``sharding/runtime.py``)."""
from repro_torch.sharding.fleet import (
    FLEET_AXIS,
    fleet_mesh,
    gather_leading,
    init_from_env,
    pad_to_devices,
    replicate,
    shard_leading_axis,
)
from repro_torch.sharding.partition import (
    PSpec,
    batch_pspec,
    batch_pspecs,
    cache_pspecs,
    distribute_tree,
    fake_tree,
    param_pspecs,
    shard_shapes,
    to_placements,
)

__all__ = [
    "FLEET_AXIS", "fleet_mesh", "gather_leading", "init_from_env",
    "pad_to_devices", "replicate", "shard_leading_axis",
    "PSpec", "batch_pspec", "batch_pspecs", "cache_pspecs",
    "distribute_tree", "fake_tree", "param_pspecs", "shard_shapes", "to_placements",
]
