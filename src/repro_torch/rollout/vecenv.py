"""B fleets of one MEC network as a tensor dimension.

Counterpart of ``repro/rollout/vecenv.py``. Where the reference ``vmap``s
the env over fleets, every ``MECEnv`` method here already takes a leading
batch axis, so ``VecMECEnv`` fixes it to ``(B,)``.

RNG: the reference derives each fleet's stream with ``fold_in(key,
fleet)``, so fleet b's draws do not depend on B. A ``torch.Generator``
cannot reproduce threefry, and here one generator draws each slot's
``[B, ...]`` tensors at once: fleet b's draws *do* depend on B. Runs on
the port's own generator are compared with the reference by statistics;
bitwise parity goes through injected draws.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.mec.config import ScenarioParams
from repro_torch.mec.env import MECEnv, MECState, SlotTasks


class VecMECEnv:
    """B-fleet view of one ``MECEnv``; every leaf has a leading [B] axis."""

    def __init__(self, env: MECEnv, n_fleets: int):
        if n_fleets < 1:
            raise ValueError("n_fleets must be >= 1")
        self.env = env
        self.n_fleets = n_fleets
        self.M, self.N, self.L = env.M, env.N, env.L

    def reset(self) -> MECState:
        return self.env.reset((self.n_fleets,))

    # ``sp`` is one ScenarioParams shared by the B fleets (None: the env's
    # own), as the reference's ``in_axes=None``; per-fleet scenarios go
    # through ``MECEnv`` with [B]-leading knobs (``RolloutDriver``)
    def sample_slot(self, generator: torch.Generator,
                    sp: Optional[ScenarioParams] = None) -> SlotTasks:
        return self.env.sample_slot(generator, (self.n_fleets,), sp)

    def observe(self, states: MECState, tasks: SlotTasks,
                sp: Optional[ScenarioParams] = None) -> dict:
        return self.env.observe(states, tasks, sp)

    def evaluate(self, states: MECState, tasks: SlotTasks,
                 decisions: torch.Tensor,
                 sp: Optional[ScenarioParams] = None) -> torch.Tensor:
        """Per-fleet critic: decisions [B, S, M] -> Q [B, S]."""
        return self.env.evaluate(states, tasks, decisions, sp)

    def step(self, states: MECState, tasks: SlotTasks,
             decisions: torch.Tensor,
             sp: Optional[ScenarioParams] = None):
        """Realize per-fleet decisions [B, M] -> (new states, SlotResults)."""
        return self.env.step(states, tasks, decisions, sp)
