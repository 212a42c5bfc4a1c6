"""Workload generators for fleet rollouts — the paper's ``iid`` draws.

Counterpart of ``repro/rollout/workloads.py`` for ``workload="iid"``:
every device active, fresh uniform rates and capacity each slot, drawn by
``MECEnv.sample_slot``. The ``iid`` family carries no generator state.
The ``poisson``/``mmpp`` arrival processes (with churn and AR(1)
channels) are not ported yet.
"""
from __future__ import annotations

import torch

from repro_torch.mec.env import MECEnv, SlotTasks


class WorkloadGen:
    """Arrival/channel process for one ``MECEnv``."""

    def __init__(self, env: MECEnv):
        if env.cfg.workload != "iid":
            raise NotImplementedError(
                f"workload {env.cfg.workload!r} is not ported to repro_torch "
                f"yet; only 'iid' is")
        self.env = env

    def sample(self, generator: torch.Generator, n_fleets: int) -> SlotTasks:
        """One slot's tasks for ``n_fleets`` fleets (leaves [B, ...])."""
        return self.env.sample_slot(generator, (n_fleets,))


def make_workload(env: MECEnv) -> WorkloadGen:
    return WorkloadGen(env)
