"""Observability (PyTorch port): the device-resident telemetry registry.

Counterpart of ``repro/obs/telemetry.py``. The rest of the reference's
``obs/`` (compile tracking, profiler hooks, run logs, history, regression
verdicts, cost attribution) is not ported yet.
"""
from repro_torch.obs.telemetry import (
    LATENCY_BINS,
    LOSS_EMA_BETA,
    POP_COUNTERS,
    QUEUE_DEPTH_EDGES,
    ROLLOUT_COUNTERS,
    SERVE_COUNTERS,
    Histogram,
    Telemetry,
    hist_add,
    hist_init,
    hist_quantile,
    hist_to_host,
    pop_telemetry,
    pop_telemetry_update,
    rollout_telemetry,
    serve_telemetry,
    serve_telemetry_update,
    telemetry_host,
    telemetry_init,
    telemetry_summary,
    telemetry_update,
)

__all__ = [
    "Histogram", "Telemetry",
    "hist_init", "hist_add", "hist_quantile", "hist_to_host",
    "telemetry_init", "telemetry_update", "telemetry_host",
    "telemetry_summary", "rollout_telemetry",
    "serve_telemetry", "serve_telemetry_update",
    "pop_telemetry", "pop_telemetry_update",
    "ROLLOUT_COUNTERS", "SERVE_COUNTERS", "POP_COUNTERS",
    "QUEUE_DEPTH_EDGES", "LATENCY_BINS", "LOSS_EMA_BETA",
]
