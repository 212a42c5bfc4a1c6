"""Fleet rollouts, decision path (PyTorch port)."""
from repro_torch.rollout.driver import (RolloutCarry, RolloutDriver,
                                        RolloutTrace, SlotDraws)
from repro_torch.rollout.metrics import (CellMetrics, metrics_finalize,
                                         metrics_init, metrics_update)
from repro_torch.rollout.vecenv import VecMECEnv
from repro_torch.rollout.workloads import WorkloadGen, make_workload

__all__ = [
    "RolloutCarry", "RolloutDriver", "RolloutTrace", "SlotDraws",
    "CellMetrics", "metrics_finalize", "metrics_init", "metrics_update",
    "VecMECEnv", "WorkloadGen", "make_workload",
]
