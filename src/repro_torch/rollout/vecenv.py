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

import torch

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

    def sample_slot(self, generator: torch.Generator) -> SlotTasks:
        return self.env.sample_slot(generator, (self.n_fleets,))

    def observe(self, states: MECState, tasks: SlotTasks) -> dict:
        return self.env.observe(states, tasks)

    def evaluate(self, states: MECState, tasks: SlotTasks,
                 decisions: torch.Tensor) -> torch.Tensor:
        """Per-fleet critic: decisions [B, S, M] -> Q [B, S]."""
        return self.env.evaluate(states, tasks, decisions)

    def step(self, states: MECState, tasks: SlotTasks,
             decisions: torch.Tensor):
        """Realize per-fleet decisions [B, M] -> (new states, SlotResults)."""
        return self.env.step(states, tasks, decisions)
