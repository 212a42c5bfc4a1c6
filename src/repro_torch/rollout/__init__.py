"""Fleet rollouts (PyTorch port): B fleets as a batch axis, the replay
ring, the slot-by-slot and compiled (CUDA-graph) episode driver, iid
workloads and the device-resident running metrics."""
from repro_torch.rollout.vecenv import VecMECEnv
from repro_torch.rollout.replay import (
    DeviceReplay,
    replay_add,
    replay_init,
    replay_sample,
)
from repro_torch.rollout.workloads import WorkloadGen, make_workload
from repro_torch.rollout.metrics import (
    CellMetrics,
    metrics_finalize,
    metrics_init,
    metrics_update,
)
from repro_torch.rollout.driver import (
    RolloutCarry,
    RolloutDriver,
    RolloutTrace,
    SlotDraws,
    carry_metrics,
    carry_telemetry,
    trace_metrics,
)

__all__ = [
    "VecMECEnv",
    "DeviceReplay", "replay_init", "replay_add", "replay_sample",
    "WorkloadGen", "make_workload",
    "CellMetrics", "metrics_init", "metrics_update", "metrics_finalize",
    "RolloutCarry", "RolloutDriver", "RolloutTrace", "SlotDraws",
    "carry_metrics", "carry_telemetry", "trace_metrics",
]
