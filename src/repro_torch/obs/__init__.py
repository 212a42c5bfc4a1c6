"""Observability (PyTorch port): the device-resident telemetry registry,
JSONL run logs, the run-history store, compile (episode build and graph
capture) counting and regression verdicts.

Counterparts of ``repro/obs/telemetry.py``, ``log.py``, ``history.py``,
``compile.py`` and ``regress.py``. The rest of the reference's ``obs/``
(profiler hooks, cost attribution) is not ported yet (ROADMAP item 7).
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
from repro_torch.obs.log import RunLog, json_safe, read_events, run_manifest
from repro_torch.obs.history import (HistoryStore, default_store,
                                     history_manifest)
from repro_torch.obs.compile import CompileTracker
from repro_torch.obs.regress import (check_history, metric_direction,
                                     regression_verdict, summarize_verdicts)

__all__ = [
    "Histogram", "Telemetry",
    "hist_init", "hist_add", "hist_quantile", "hist_to_host",
    "telemetry_init", "telemetry_update", "telemetry_host",
    "telemetry_summary", "rollout_telemetry",
    "serve_telemetry", "serve_telemetry_update",
    "pop_telemetry", "pop_telemetry_update",
    "ROLLOUT_COUNTERS", "SERVE_COUNTERS", "POP_COUNTERS",
    "QUEUE_DEPTH_EDGES", "LATENCY_BINS", "LOSS_EMA_BETA",
    "RunLog", "json_safe", "read_events", "run_manifest",
    "HistoryStore", "default_store", "history_manifest",
    "CompileTracker",
    "check_history", "metric_direction", "regression_verdict",
    "summarize_verdicts",
]
