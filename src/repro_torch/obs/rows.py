"""Result rows: time them, stamp them, save them, record them in history.

Counterpart of the row helpers of ``benchmarks/common.py`` (``timed``,
``stamp_rows``, ``record_rows``, ``save_rows``), kept inside the package so
that neither a launch command nor a figure module imports another's for
them. ``timed`` stops its clock only after ``torch.cuda.synchronize``, so
queued device work is counted. Every row is stamped with where it was
measured (``run_manifest``'s git rev, torch version, backend and device
count; on the card its name and power limit), and ``record_rows`` appends
one ``bench`` record per row to the run-history store (``REPRO_HISTORY``,
default ``results/torch_history``; the empty string disables it).
"""
from __future__ import annotations

import json
import os
import subprocess
import time

import numpy as np
import torch

from repro_torch.obs.history import default_store, history_manifest
from repro_torch.obs.log import card_line, run_manifest

RESULTS_ENV = "REPRO_RESULTS"
# Row keys that are labels or stamps, not measurements: left out of the
# metric set a history record carries.
NON_METRIC_KEYS = ("backend", "n_devices", "git_rev", "torch_version",
                   "device_name", "power_limit")


def _sync_device(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timed(fn, device: torch.device):
    """Run ``fn`` and return (result, wall seconds) on a monotonic clock
    that starts after the card has finished earlier work and stops only
    after ``torch.cuda.synchronize``, so queued device work is counted."""
    _sync_device(device)
    t0 = time.perf_counter()
    out = fn()
    _sync_device(device)
    return out, time.perf_counter() - t0


def card_stamp(device: torch.device) -> dict:
    """The card's name and power limit as ``nvidia-smi`` reports them
    (``obs.log.card_line``); the limit None where it cannot be read.
    Empty off the card."""
    if device.type != "cuda":
        return {}
    try:
        line = card_line(device.index if device.index is not None else 0)
        name, limit = (v.strip() for v in line.split(",", 1))
    except (OSError, subprocess.SubprocessError, IndexError, ValueError):
        name, limit = torch.cuda.get_device_name(device), None
    return {"device_name": name, "power_limit": limit}


def stamp_rows(rows, device: torch.device) -> list:
    """Stamp every row with where it was measured: ``run_manifest``'s git
    rev, torch version, backend (``cuda``/``cpu``) and device count, and
    on the card its name and power limit. A key the row already has is
    kept: a paper row's ``n_devices`` stays the fleet's M. History
    comparisons filter on these, so a CPU number never gates a card's
    trend."""
    man = run_manifest(backend=device.type)
    stamp = {k: man[k] for k in ("backend", "n_devices", "git_rev",
                                 "torch_version")}
    stamp.update(card_stamp(device))
    for row in rows:
        for k, v in stamp.items():
            row.setdefault(k, v)
    return rows


def _row_label(name: str, row: dict) -> str:
    """A row's history name: its own ``name``, else the module/method-M-tau
    label of the reference's CSV digest."""
    if row.get("name"):
        return str(row["name"])
    return (f"{name}/{row.get('method', 'row')}-M{row.get('n_devices', '')}"
            f"-t{row.get('slot_ms', '')}")


def record_rows(rows, name: str = "") -> None:
    """Append one manifest-stamped ``bench`` history record per stamped
    row to the env-configured store (``REPRO_HISTORY``, default
    ``results/torch_history``; empty string disables), named by
    ``_row_label(name, row)``. The record's metrics are every finite
    numeric row entry except the stamps."""
    store = default_store()
    if store is None:
        return
    for row in rows:
        metrics = {k: v for k, v in row.items()
                   if k not in NON_METRIC_KEYS
                   and isinstance(v, (int, float))
                   and not isinstance(v, bool) and np.isfinite(v)}
        if metrics:
            store.append("bench", _row_label(name, row), metrics,
                         manifest=history_manifest(backend=row["backend"]),
                         derived=row.get("derived", ""))


def save_rows(name: str, rows, device: torch.device) -> str:
    """Stamp the rows, write them to ``results/torch_<name>.json`` (the
    directory from ``REPRO_RESULTS``, default ``results``) and append them
    to the run history. Returns the file's path."""
    stamp_rows(rows, device)
    out_dir = os.environ.get(RESULTS_ENV, "results")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"torch_{name}.json")
    with open(path, "w") as f:
        json.dump(rows, f, indent=1)
    record_rows(rows, name)
    return path
