"""Aggregate sweep rows into the paper's comparison tables and curves.

Counterpart of ``repro/sweep/report.py``, the same pure numpy code: for
the same rows it writes the same bytes.

Per scenario (= figure column: fig5_baseline .. fig8_csi, dyn_*), the
report carries mean/std over seeds for every §VI-D metric and method,
plus the paper's headline framing — GRLE's metrics normalized against
each baseline (the "up to 3.41x average accuracy over GRL, 1.45x over
DROOE" ratios of Figs 5-8 / Table VI style).
"""
from __future__ import annotations

import json
from typing import Optional

import numpy as np

from repro_torch.obs.log import json_safe

METRIC_KEYS = ("avg_accuracy", "ssp", "deadline_miss", "throughput_tps",
               "avg_reward")
RATIO_KEYS = ("avg_accuracy", "throughput_tps", "ssp")
TARGET = "grle"
BASELINES = ("grl", "drooe", "droo")


def _mean_std(rows, key):
    # None (e.g. final_loss before any train step) and non-finite values
    # are dropped, never averaged or serialized as NaN
    vals = np.asarray([r[key] for r in rows
                       if r.get(key) is not None], np.float64)
    vals = vals[np.isfinite(vals)]
    if vals.size == 0:
        return {"mean": None, "std": None, "n": 0}
    return {"mean": round(float(vals.mean()), 6),
            "std": round(float(vals.std()), 6),
            "n": int(vals.size)}


def build_report(rows) -> dict:
    """Rows (one per cell) -> per-scenario aggregate + ratio report."""
    scenarios: dict = {}
    for row in rows:
        sc = scenarios.setdefault(row["scenario"], {})
        sc.setdefault(row["method"], []).append(row)

    out = {"scenarios": {}, "grid": {
        "scenarios": sorted(scenarios),
        "methods": sorted({r["method"] for r in rows}),
        "seeds": sorted({r["seed"] for r in rows}),
        "cells": len(rows),
    }}
    for name in sorted(scenarios):
        methods = {
            m: {k: _mean_std(rs, k) for k in METRIC_KEYS + ("final_loss",)}
            for m, rs in sorted(scenarios[name].items())
        }
        ratios: dict = {}
        if TARGET in methods:
            for base in BASELINES:
                if base not in methods:
                    continue
                ratios[f"{TARGET}_vs_{base}"] = {
                    k: _ratio(methods[TARGET][k]["mean"],
                              methods[base][k]["mean"])
                    for k in RATIO_KEYS
                }
        out["scenarios"][name] = {"methods": methods, "ratios": ratios}
    return out


def _ratio(num: Optional[float], den: Optional[float]) -> Optional[float]:
    if num is None or den is None or den == 0:
        return None
    return round(num / den, 4)


def format_markdown(report: dict) -> str:
    """Report -> one markdown table per scenario + ratio summary lines."""
    lines = []
    for name, sc in report["scenarios"].items():
        lines.append(f"### {name}")
        lines.append("| method | avg_accuracy | ssp | deadline_miss "
                     "| throughput_tps | avg_reward |")
        lines.append("|---|---|---|---|---|---|")
        for method, stats in sc["methods"].items():
            cells = [(f"{stats[k]['mean']:.4f} ± {stats[k]['std']:.4f}"
                      if stats[k]["mean"] is not None else "n/a")
                     for k in METRIC_KEYS]
            lines.append("| " + " | ".join([method] + cells) + " |")
        for pair, vals in sc["ratios"].items():
            pretty = ", ".join(
                f"{k}={v if v is not None else 'n/a'}x"
                for k, v in vals.items())
            lines.append(f"- **{pair}**: {pretty}")
        lines.append("")
    return "\n".join(lines)


TELEMETRY_COLUMNS = (
    ("deadline_hit_rate", "hit"),
    ("latency_p50", "lat_p50"),
    ("latency_p99", "lat_p99"),
    ("comm_share", "comm"),
    ("wait_share", "wait"),
    ("compute_share", "comp"),
    ("replay_occ_mean", "replay"),
    ("loss_ema", "loss_ema"),
)


def format_telemetry(rows) -> str:
    """Per-cell telemetry summaries -> one markdown table.

    Rows without a ``telemetry`` entry (sweep ran with telemetry off, or
    cached pre-telemetry results) are skipped; latencies are in deadline
    units; ``exits`` shows each cell's decision share per exit depth.
    """
    rows = [r for r in rows if r.get("telemetry")]
    if not rows:
        return "(no telemetry in these rows)"
    heads = [h for _, h in TELEMETRY_COLUMNS]
    lines = ["| cell | " + " | ".join(heads) + " | exits |",
             "|" + "---|" * (len(heads) + 2)]
    for r in rows:
        s = r["telemetry"]["summary"]
        cells = [(f"{s[k]:.3f}" if isinstance(s.get(k), float) else "n/a")
                 for k, _ in TELEMETRY_COLUMNS]
        exits = "/".join(f"{x:.2f}" for x in s.get("exit_share", []))
        label = f"{r['scenario']}/{r['method']}/s{r['seed']}"
        lines.append("| " + " | ".join([label] + cells + [exits]) + " |")
    return "\n".join(lines)


def write_report(report: dict, path: str) -> str:
    """Deterministic, strict JSON dump: sorted keys, NaN/inf scrubbed to
    null (``allow_nan=False`` guarantees no bare ``NaN`` token can leak
    into stored reports)."""
    with open(path, "w") as f:
        json.dump(json_safe(report), f, sort_keys=True, indent=1,
                  allow_nan=False)
    return path
