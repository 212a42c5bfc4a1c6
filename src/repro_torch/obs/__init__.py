"""Observability (PyTorch port): the device-resident telemetry registry,
JSONL run logs, the run-history store, compile (episode build and graph
capture) counting, regression verdicts, profiler hooks and cost
attribution.

Counterparts of ``repro/obs/telemetry.py``, ``log.py``, ``history.py``,
``compile.py``, ``regress.py``, ``profile.py`` (``torch.profiler`` trace
capture, ``obs/<phase>`` spans) and ``cost.py`` (FLOPs and bytes of a
program run eagerly under a dispatch mode, the hand-written kernels by
their formulas).
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
from repro_torch.obs.profile import PHASES, phase, span, trace_capture
from repro_torch.obs.cost import (HOT_PROGRAMS, driver_step_cost,
                                  hot_program_costs, pack_program_cost,
                                  program_cost, serve_decode_cost)

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
    "PHASES", "phase", "span", "trace_capture",
    "HOT_PROGRAMS", "program_cost", "driver_step_cost",
    "pack_program_cost", "serve_decode_cost", "hot_program_costs",
]
