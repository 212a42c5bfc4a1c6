"""Device-resident running metrics for rollouts.

Counterpart of ``repro/rollout/metrics.py``: a NamedTuple of fixed-dtype
scalar tensors, folded every slot without a host sync, pooled over all
fleets.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class CellMetrics(NamedTuple):
    """Running sums for one cell (all fleets pooled)."""
    n_slots: torch.Tensor    # int32, slots accumulated
    n_tasks: torch.Tensor    # float32, active tasks seen
    n_success: torch.Tensor  # float32, tasks finished within deadline
    n_miss: torch.Tensor     # float32, active tasks that missed the deadline
    sum_acc: torch.Tensor    # float32, sum of accuracy over successful tasks
    sum_reward: torch.Tensor # float32, sum of per-fleet slot rewards
    n_train: torch.Tensor    # int32, train steps taken
    last_loss: torch.Tensor  # float32, most recent minibatch loss (NaN before)


def metrics_init(device) -> CellMetrics:
    def f():
        return torch.zeros((), dtype=torch.float32, device=device)

    def i():
        return torch.zeros((), dtype=torch.int32, device=device)

    return CellMetrics(n_slots=i(), n_tasks=f(), n_success=f(), n_miss=f(),
                       sum_acc=f(), sum_reward=f(), n_train=i(),
                       last_loss=torch.full((), torch.nan, device=device))


def metrics_update(m: CellMetrics, *, reward, success, accuracy, active,
                   loss) -> CellMetrics:
    """Fold one slot's batched results ([B] reward, [B, M] the rest)."""
    act = active > 0.5
    suc = success & act
    sucf = suc.to(torch.float32)
    trained = ~torch.isnan(loss)
    return CellMetrics(
        n_slots=m.n_slots + 1,
        n_tasks=m.n_tasks + act.to(torch.float32).sum(),
        n_success=m.n_success + sucf.sum(),
        n_miss=m.n_miss + (act & ~suc).to(torch.float32).sum(),
        sum_acc=m.sum_acc + (accuracy.to(torch.float32) * sucf).sum(),
        sum_reward=m.sum_reward + reward.to(torch.float32).sum(),
        n_train=m.n_train + trained.to(torch.int32),
        last_loss=torch.where(trained, loss.to(torch.float32), m.last_loss),
    )


def metrics_finalize(m: CellMetrics, *, slot_s: float, n_fleets: int) -> dict:
    """§VI-D summary metrics (float32 scalar tensors)."""
    tasks = torch.clamp_min(m.n_tasks, 1.0)
    wall = torch.clamp_min(m.n_slots.to(torch.float32) * slot_s, 1e-9)
    return {
        "ssp": m.n_success / tasks,
        "avg_accuracy": m.sum_acc / tasks,
        "deadline_miss": m.n_miss / tasks,
        "throughput_tps": m.n_success / wall / n_fleets,
        "avg_reward": m.sum_reward
        / torch.clamp_min(m.n_slots.to(torch.float32) * n_fleets, 1.0),
        "tasks": m.n_tasks,
        "train_steps": m.n_train.to(torch.float32),
        "final_loss": m.last_loss,
    }
