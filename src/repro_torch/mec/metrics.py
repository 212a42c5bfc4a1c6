"""Running metrics matching the paper's §VI-D definitions.

Counterpart of ``repro/mec/metrics.py`` (host code). ``update`` reads a
``SlotResult``'s tensors (one device-to-host copy each) or numpy arrays.

* SSP — #successful tasks / #total tasks.
* Average inference accuracy — Σ accuracy of *successful* tasks / #total.
* Average throughput — #successful tasks / total elapsed time (tasks/s).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


@dataclasses.dataclass
class RunningMetrics:
    total_tasks: int = 0
    successful: int = 0
    accuracy_sum: float = 0.0
    reward_sum: float = 0.0
    slots: int = 0
    slot_s: float = 30e-3

    def update(self, result, active=None) -> None:
        success = _host(result.success)
        acc = _host(result.accuracy)
        if active is None:
            active = np.ones_like(success, dtype=bool)
        else:
            active = _host(active) > 0.5
        self.total_tasks += int(active.sum())
        self.successful += int((success & active).sum())
        self.accuracy_sum += float((acc * (success & active)).sum())
        self.reward_sum += float(_host(result.reward))
        self.slots += 1

    @property
    def ssp(self) -> float:
        return self.successful / max(self.total_tasks, 1)

    @property
    def avg_accuracy(self) -> float:
        return self.accuracy_sum / max(self.total_tasks, 1)

    @property
    def throughput(self) -> float:
        return self.successful / max(self.slots * self.slot_s, 1e-9)

    @property
    def avg_reward(self) -> float:
        return self.reward_sum / max(self.slots, 1)

    def summary(self) -> dict:
        return {
            "ssp": self.ssp,
            "avg_accuracy": self.avg_accuracy,
            "throughput_tps": self.throughput,
            "avg_reward": self.avg_reward,
            "tasks": self.total_tasks,
        }
