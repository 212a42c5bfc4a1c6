"""Serving layer (PyTorch port): GRLE-scheduled early-exit LM serving,
synchronous and continuously batched; counterpart of ``repro/serve``."""
from repro_torch.serve.clock import VirtualClock, WallClock
from repro_torch.serve.engine import (AgentPool, BatchState,
                                      ContinuousServingEngine,
                                      EdgeServingEngine, Replica, Request,
                                      RunningReq, SchedEvents, ServeDraws,
                                      batch_init, batch_occupancy,
                                      batch_release, sched_evict, sched_tick)
from repro_torch.serve.loadgen import make_trace
from repro_torch.serve.queue import (QueueEntry, QueueState, ServeRequest,
                                     queue_depth, queue_expire, queue_init,
                                     queue_pop, queue_push, queue_requeue)

__all__ = [
    "AgentPool", "BatchState", "ContinuousServingEngine",
    "EdgeServingEngine", "QueueEntry", "QueueState", "Replica", "Request",
    "RunningReq", "SchedEvents", "ServeRequest", "VirtualClock", "WallClock",
    "batch_init", "batch_occupancy", "batch_release", "make_trace",
    "queue_depth", "queue_expire", "queue_init", "queue_pop", "queue_push",
    "queue_requeue", "sched_evict", "sched_tick",
]
