"""The device replay ring under its ``rollout`` name.

Counterpart of ``repro/rollout/replay.py``: the ring lives in
``repro_torch.core.devreplay``, a field of the agent's state; importing
the names from here keeps working.
"""
from repro_torch.core.devreplay import (  # noqa: F401
    DeviceReplay,
    replay_add,
    replay_init,
    replay_sample,
)

__all__ = ["DeviceReplay", "replay_init", "replay_add", "replay_sample"]
