"""Noise-aware perf-regression verdicts over the run-history store.

Counterpart of ``repro/obs/regress.py``, the same verdict logic over the
port's ``HistoryStore`` (whose manifests carry ``torch_version`` and the
device type as ``backend``).

Benchmark wall-clock on shared CI boxes is noisy (the actor benchmark
already takes best-of-K because box load varies 2-3x), so a naive
"current vs last" comparison either cries wolf or needs a tolerance so
wide it misses real rot. The sentinel compares the **latest** record
against the **median** of the last K comparable records (same backend /
device count / ``use_pallas`` — see ``obs.history.COMPARABLE_KEYS``)
and widens the tolerance band by a robust noise estimate, the median
absolute deviation (MAD):

    band = max(tolerance * |median|, MAD_SIGMAS * 1.4826 * MAD)

1.4826 * MAD estimates one standard deviation for Gaussian noise; three
of them plus the floor tolerance means a verdict of ``regression`` is a
shift the observed run-to-run noise cannot plausibly explain. A series
shorter than ``min_history`` returns the explicit
``insufficient-history`` status — never a silent pass or fail.

Metric direction is inferred from the key name (``steps_per_s`` up is
good, ``us_per_call`` down is good); unknown metrics are skipped rather
than guessed. ``tools/check_perf_regression.py`` is the CLI/CI gate on
top of the reference's module (warn on PRs, fail on main);
``python -m repro_torch.launch.history --check`` gates on this one.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.obs.history import HistoryStore, comparable

# Verdict statuses (exhaustive).
OK = "ok"
REGRESSION = "regression"
IMPROVEMENT = "improvement"
INSUFFICIENT = "insufficient-history"

DEFAULT_TOLERANCE = 0.10   # 10% floor band around the median
DEFAULT_K = 8              # baseline window: last K comparable records
MIN_HISTORY = 3            # fewer baselines -> insufficient-history
MAD_SIGMAS = 3.0           # noise band half-width, in robust sigmas
MAD_SCALE = 1.4826         # MAD -> sigma under Gaussian noise

# Direction by metric-name suffix/exact key: +1 higher-is-better,
# -1 lower-is-better. Anything unmatched is informational (skipped).
HIGHER_BETTER = ("steps_per_s", "cells_per_s", "slots_per_s",
                 "throughput_tps", "ssp", "avg_accuracy",
                 "deadline_hit_rate", "arithmetic_intensity")
LOWER_BETTER = ("us_per_call", "wall_s", "latency_p50_s", "latency_p99_s",
                "latency_p50_s_exact", "latency_p99_s_exact",
                "deadline_miss", "total_compile_s")


def metric_direction(key: str) -> int:
    """+1 higher-better, -1 lower-better, 0 unknown (not gated)."""
    if key in HIGHER_BETTER:
        return 1
    if key in LOWER_BETTER:
        return -1
    return 0


def regression_verdict(baseline, current: float, *, direction: int,
                       tolerance: float = DEFAULT_TOLERANCE,
                       min_history: int = MIN_HISTORY) -> dict:
    """Verdict for one metric: ``current`` vs the baseline series.

    ``baseline`` is the historical value series (most recent last, the
    current value excluded); ``direction`` follows
    ``metric_direction``. Returns a dict with ``status`` plus the
    numbers behind it (median, MAD, band, ratio vs median) so reports
    can show *why*.
    """
    vals = np.asarray([v for v in baseline if np.isfinite(v)], np.float64)
    out = {"current": float(current), "n_history": int(vals.size),
           "direction": direction}
    if vals.size < min_history:
        out.update(status=INSUFFICIENT, median=None, mad=None, band=None,
                   ratio=None)
        return out
    med = float(np.median(vals))
    mad = float(np.median(np.abs(vals - med)))
    band = max(tolerance * abs(med), MAD_SIGMAS * MAD_SCALE * mad)
    delta = float(current) - med
    # a worsening moves against the metric's good direction
    if direction != 0 and delta * direction < -band:
        status = REGRESSION
    elif direction != 0 and delta * direction > band:
        status = IMPROVEMENT
    else:
        status = OK
    out.update(status=status, median=med, mad=mad, band=band,
               ratio=(float(current) / med if med else None))
    return out


def check_history(store: HistoryStore, *, k: int = DEFAULT_K,
                  tolerance: float = DEFAULT_TOLERANCE,
                  tolerances: Optional[dict] = None,
                  kind: Optional[str] = None,
                  min_history: int = MIN_HISTORY) -> list:
    """Verdicts for every (record name, gated metric) in the store.

    For each name, the latest record is the candidate; its baseline is
    the up-to-``k`` most recent *earlier* records comparable to it
    (identical backend / device count / ``use_pallas``). ``tolerances``
    maps metric name -> per-metric tolerance overriding the global
    ``tolerance``. Returns one verdict dict per (name, metric), each
    carrying ``name``/``metric``/``status`` plus the
    ``regression_verdict`` numbers.
    """
    tolerances = tolerances or {}
    out = []
    for name in store.names(kind=kind):
        recs = store.records(name=name)
        cand = recs[-1]
        metrics = cand.get("metrics") or {}
        base_recs = [r for r in recs[:-1] if comparable(r, cand)][-k:]
        for key, value in metrics.items():
            direction = metric_direction(key)
            if direction == 0:
                continue
            if not isinstance(value, (int, float)) or isinstance(value, bool):
                continue
            series = [
                (r.get("metrics") or {}).get(key) for r in base_recs]
            series = [float(v) for v in series
                      if isinstance(v, (int, float))
                      and not isinstance(v, bool)]
            v = regression_verdict(
                series, float(value), direction=direction,
                tolerance=tolerances.get(key, tolerance),
                min_history=min_history)
            v.update(name=name, metric=key,
                     git_rev=(cand.get("manifest") or {}).get("git_rev"),
                     backend=(cand.get("manifest") or {}).get("backend"))
            out.append(v)
    return out


def summarize_verdicts(verdicts) -> dict:
    """Counts per status — the CI gate's one-line digest."""
    counts = {OK: 0, REGRESSION: 0, IMPROVEMENT: 0, INSUFFICIENT: 0}
    for v in verdicts:
        counts[v["status"]] = counts.get(v["status"], 0) + 1
    counts["total"] = len(verdicts)
    return counts
