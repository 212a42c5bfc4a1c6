"""Learning-rate schedules (step -> lr).

Counterpart of ``repro/optim/schedules.py``. A schedule takes the 0-d
int32 step tensor the optimizers pass and returns a 0-d float32 tensor on
its device.
"""
from __future__ import annotations

import math

import torch


def constant(lr: float):
    return lambda step: torch.tensor(lr, dtype=torch.float32,
                                     device=torch.as_tensor(step).device)


def cosine_decay(lr: float, decay_steps: int, alpha: float = 0.0):
    """``lr * ((1 - alpha) * cos + alpha)``, ``cos`` falling from 1 to 0
    over ``decay_steps`` steps and staying there."""

    def fn(step):
        t = torch.clamp(torch.as_tensor(step).float(),
                        max=decay_steps) / decay_steps
        cos = 0.5 * (1.0 + torch.cos(math.pi * t))
        return lr * ((1 - alpha) * cos + alpha)

    return fn


def linear_warmup_cosine(lr: float, warmup_steps: int, decay_steps: int,
                         alpha: float = 0.1):
    """Linear from 0 to ``lr`` over ``warmup_steps``, then ``cosine_decay``
    over the remaining ``decay_steps - warmup_steps``."""
    cos = cosine_decay(lr, max(decay_steps - warmup_steps, 1), alpha)

    def fn(step):
        step = torch.as_tensor(step)
        s = step.float()
        warm = lr * s / max(warmup_steps, 1)
        return torch.where(s < warmup_steps, warm, cos(step - warmup_steps))

    return fn
