"""Structured JSONL run logs: manifest + per-episode telemetry + bench rows.

Counterpart of ``repro/obs/log.py``. A run directory holds one
``events.jsonl``: append-only, one JSON object per line, every line
carrying ``event`` and ``seq`` keys. The first event is the
``manifest``: config signature, git revision, torch version and backend.

Everything written passes through ``json_safe`` first: NaN/±inf become
``null`` (strict JSON), numpy and torch scalars and arrays become Python
numbers and lists, unknown objects fall back to ``repr``.
"""
from __future__ import annotations

import json
import os
import subprocess
import time
from typing import Optional

import numpy as np
import torch


def json_safe(obj):
    """Recursively convert ``obj`` into strict-JSON-serializable data.

    NaN and ±inf map to None (null): JSON has no spelling for them.
    """
    if obj is None or isinstance(obj, (bool, str, int)):
        return obj
    if isinstance(obj, float):
        return obj if np.isfinite(obj) else None
    if isinstance(obj, (np.bool_,)):
        return bool(obj)
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        v = float(obj)
        return v if np.isfinite(v) else None
    if isinstance(obj, dict):
        return {str(k): json_safe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [json_safe(v) for v in obj]
    if isinstance(obj, torch.Tensor):
        return json_safe(obj.detach().cpu().tolist())
    if hasattr(obj, "tolist"):       # numpy arrays
        return json_safe(np.asarray(obj).tolist())
    return repr(obj)


def git_rev(root: str = ".") -> str:
    """Current commit hash, or "unknown" outside a git checkout."""
    try:
        out = subprocess.run(
            ["git", "-C", root, "rev-parse", "HEAD"],
            capture_output=True, text=True, timeout=5)
        rev = out.stdout.strip()
        return rev if out.returncode == 0 and rev else "unknown"
    except Exception:
        return "unknown"


def card_line(index: int = 0) -> str:
    """Card ``index``'s name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them, e.g.
    ``NVIDIA H100 80GB HBM3, 700.00 W``. Raises where ``nvidia-smi``
    cannot be run."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    return out.splitlines()[index]


def run_manifest(config_signature=None, *, backend: Optional[str] = None,
                 **extra) -> dict:
    """The who/what/where header every run log starts with. ``backend``
    is the device type the run used (``"cuda"`` or ``"cpu"``; default:
    ``"cuda"`` when a card is visible); ``n_devices`` counts the cards of
    a ``"cuda"`` run, else 1."""
    if backend is None:
        backend = "cuda" if torch.cuda.is_available() else "cpu"
    man = {
        "git_rev": git_rev(),
        "torch_version": torch.__version__,
        "backend": backend,
        "n_devices": (torch.cuda.device_count() if backend == "cuda"
                      else 1),
        "config_signature": (None if config_signature is None
                             else list(map(str, config_signature))
                             if isinstance(config_signature, (tuple, list))
                             else str(config_signature)),
    }
    man.update(extra)
    return man


class RunLog:
    """Append-only JSONL event log for one run directory.

    ``emit(event, **payload)`` writes one line and flushes: a killed run
    keeps every event it logged. Events get a monotonically increasing
    ``seq`` and a wall-clock ``t_s`` relative to the log's creation.
    """

    def __init__(self, outdir: str, *, manifest=None):
        self.outdir = outdir
        os.makedirs(outdir, exist_ok=True)
        self.path = os.path.join(outdir, "events.jsonl")
        self._seq = 0
        self._t0 = time.perf_counter()
        self._f = open(self.path, "a")
        if manifest is not None:
            self.emit("manifest", **manifest)

    def emit(self, event: str, **payload) -> dict:
        rec = {"event": event, "seq": self._seq,
               "t_s": round(time.perf_counter() - self._t0, 6)}
        rec.update(json_safe(payload))
        self._f.write(json.dumps(rec, allow_nan=False) + "\n")
        self._f.flush()
        self._seq += 1
        return rec

    def close(self) -> None:
        self._f.close()

    def __enter__(self) -> "RunLog":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def read_events(path: str) -> list:
    """Load every event of an ``events.jsonl`` (strict JSON per line)."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out
