"""Append-only run-history store: perf/metric records across revisions.

Counterpart of ``repro/obs/history.py``. ``HistoryStore`` keeps one
``records.jsonl`` under
``results/torch_history/`` (override with ``REPRO_HISTORY``; set it to the
empty string to disable appends entirely), strictly append-only, one
JSON object per line.

Record schema (``schema: 1``)::

    {"schema": 1, "kind": "bench" | "sweep" | "serve" | "pop",
     "name": "<row/cell/snapshot label>", "ts": <unix seconds>,
     "metrics": {"steps_per_s": ..., ...},       # finite numbers or null
     "manifest": {"git_rev": ..., "backend": ..., "n_devices": ...,
                  "torch_version": ..., "config_signature": ...,
                  "use_pallas": ...},
     ...extra}

The manifest is what makes records comparable: only records sharing
``backend``, ``n_devices`` and ``use_pallas`` compare, and the port's
manifests carry ``torch_version`` and a ``backend`` of ``"cuda"`` or
``"cpu"``. A reference record on the CPU also says ``"cpu"``, so the port
keeps its own default root, and its records never meet the reference's
unless ``REPRO_HISTORY`` points both at one store. Producers here:
``EdgeServingEngine.telemetry_snapshot(history=...)``, one ``serve``
record per snapshot, and ``sweep.run_sweep(history=...)``, one ``sweep``
record per executed cell (``use_pallas`` is whether the actor kernels run
hand-written, i.e. on the card). ``launch/history.py`` renders them.
"""
from __future__ import annotations

import json
import os
import time
from typing import Optional

from repro_torch.obs.log import json_safe, run_manifest

HISTORY_SCHEMA = 1
HISTORY_KINDS = ("bench", "sweep", "serve", "pop")
HISTORY_ENV = "REPRO_HISTORY"
DEFAULT_ROOT = os.path.join("results", "torch_history")
# Manifest keys two records must share to be compared by the sentinel.
COMPARABLE_KEYS = ("backend", "n_devices", "use_pallas")


def history_root() -> Optional[str]:
    """The configured store root; None when appends are disabled
    (``REPRO_HISTORY=""``)."""
    root = os.environ.get(HISTORY_ENV)
    if root is None:
        return DEFAULT_ROOT
    return root or None


def history_manifest(*, config_signature=None, use_pallas=None,
                     **extra) -> dict:
    """The comparability stamp every history record carries.

    Extends ``run_manifest`` (git rev, torch version, backend, device
    count, config signature) with the kernel-backend switch; the three
    ``COMPARABLE_KEYS`` are what comparisons filter on.
    """
    return run_manifest(config_signature=config_signature,
                        use_pallas=use_pallas, **extra)


def comparable(a: dict, b: dict) -> bool:
    """True when two records' manifests agree on every comparability key."""
    ma, mb = a.get("manifest") or {}, b.get("manifest") or {}
    return all(ma.get(k) == mb.get(k) for k in COMPARABLE_KEYS)


class HistoryStore:
    """Append-only JSONL store of run-history records.

    ``append`` opens/writes/closes per call — no held file handle, so
    concurrent producers (a sweep and a benchmark) interleave whole
    lines rather than corrupting each other. Records are never rewritten
    or deleted; readers filter.
    """

    def __init__(self, root: Optional[str] = None):
        self.root = root if root is not None else (history_root()
                                                   or DEFAULT_ROOT)
        self.path = os.path.join(self.root, "records.jsonl")

    # ------------------------------------------------------------- writing
    def append(self, kind: str, name: str, metrics: dict, *,
               manifest: Optional[dict] = None, **extra) -> dict:
        """Append one record; returns the (JSON-safe) record written."""
        if kind not in HISTORY_KINDS:
            raise ValueError(f"kind {kind!r} not in {HISTORY_KINDS}")
        if not name:
            raise ValueError("record needs a non-empty name")
        rec = {"schema": HISTORY_SCHEMA, "kind": kind, "name": str(name),
               "ts": round(time.time(), 3),
               "metrics": json_safe(dict(metrics)),
               "manifest": json_safe(manifest if manifest is not None
                                     else history_manifest())}
        rec.update(json_safe(extra))
        os.makedirs(self.root, exist_ok=True)
        with open(self.path, "a") as f:
            f.write(json.dumps(rec, allow_nan=False) + "\n")
        return rec

    # ------------------------------------------------------------- reading
    def records(self, *, kind: Optional[str] = None,
                name: Optional[str] = None,
                backend: Optional[str] = None,
                git_rev: Optional[str] = None) -> list:
        """All records in append order, optionally filtered."""
        if not os.path.exists(self.path):
            return []
        out = []
        with open(self.path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                rec = json.loads(line)
                man = rec.get("manifest") or {}
                if kind is not None and rec.get("kind") != kind:
                    continue
                if name is not None and rec.get("name") != name:
                    continue
                if backend is not None and man.get("backend") != backend:
                    continue
                if git_rev is not None and man.get("git_rev") != git_rev:
                    continue
                out.append(rec)
        return out

    def names(self, *, kind: Optional[str] = None) -> list:
        """Distinct record names, in first-seen order."""
        seen: dict = {}
        for rec in self.records(kind=kind):
            seen.setdefault(rec.get("name"), None)
        return [n for n in seen if n]

    def series(self, name: str, metric: str, *,
               like: Optional[dict] = None) -> list:
        """The metric's value trajectory for one record name, append
        order, skipping records where it is missing/null. ``like``
        restricts to records comparable (same backend/devices/pallas)
        to the given one."""
        out = []
        for rec in self.records(name=name):
            if like is not None and not comparable(rec, like):
                continue
            v = (rec.get("metrics") or {}).get(metric)
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                out.append((rec, float(v)))
        return out

    def latest(self, name: str) -> Optional[dict]:
        recs = self.records(name=name)
        return recs[-1] if recs else None


def default_store() -> Optional[HistoryStore]:
    """The env-configured store, or None when appends are disabled."""
    root = history_root()
    return None if root is None else HistoryStore(root)
