"""Opt-in ``torch.profiler`` capture and named phase spans.

Counterpart of ``repro/obs/profile.py``. Two hooks, both cheap when no
profiler runs:

* ``trace_capture(outdir)``: a context manager around a
  ``torch.profiler.profile`` (host activity, and the card's where there is
  one). On exit the trace is written as a Chrome/Perfetto JSON file under
  ``outdir`` (open it in ui.perfetto.dev or chrome://tracing). With
  ``enabled=False`` the block is a no-op, so callers can pass a ``--trace``
  flag straight through. A profiler that fails to start or to write its
  file prints a warning and the run goes on, as in the reference; the
  yielded ``TraceCapture`` says whether a trace was taken.
* ``phase(name)`` and ``span(name)``: ``torch.profiler.record_function``
  ranges. ``phase`` names a region of the slot body ``obs/<name>``, as the
  reference's ``jax.named_scope`` does (``PHASES`` lists them); ``span``
  marks host-side code under its own name. Inside a CUDA graph a range is
  recorded at capture only: replays show the graph's kernels, not its
  phases.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch
from torch.profiler import record_function

# Standard phase names of the rollout slot body (driver._slot), the
# reference's list; "critic" runs inside "actor" here as there.
PHASES = ("sample", "actor", "critic", "env_step", "train")
TRACE_FILE = "trace.json"
# torch.profiler can lose the device records of the last milliseconds of
# work in its window, even after a synchronize; on the card the window
# stays open this long after the block
TAIL_S = 0.2


# every span name ``phase`` can record, for tools that leave spans out of
# device time
PHASE_SPANS = tuple(f"obs/{p}" for p in PHASES)


def phase(name: str):
    """A ``record_function`` range named ``obs/<name>`` around a phase of
    the slot body; no effect on numerics."""
    return record_function(f"obs/{name}")


def span(name: str):
    """A ``record_function`` range named ``name`` around host-side code
    (serving loop, benchmark harness)."""
    return record_function(name)


class TraceCapture:
    """What ``trace_capture`` yields: ``outdir``, ``started`` (the profiler
    ran), and after the block ``path``, the trace file, or None when no
    trace was taken. True once the file is written."""

    def __init__(self, outdir: str):
        self.outdir = outdir
        self.started = False
        self.path: Optional[str] = None

    def __bool__(self) -> bool:
        return self.path is not None


@contextlib.contextmanager
def trace_capture(outdir: str, *, enabled: bool = True):
    """Profile the block into ``outdir/trace.json`` (the directory is
    created). ``enabled=False`` yields None and does nothing. A profiler
    that cannot start or write degrades to a printed warning: profiling
    must never take down the run it observes."""
    if not enabled:
        yield None
        return
    os.makedirs(outdir, exist_ok=True)
    cap = TraceCapture(outdir)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = None
    try:
        prof = torch.profiler.profile(activities=activities)
        prof.__enter__()
        cap.started = True
    except Exception as e:              # pragma: no cover - env-dependent
        print(f"[obs] profiler trace unavailable: {e}", flush=True)
    try:
        yield cap
    finally:
        if cap.started:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
                time.sleep(TAIL_S)
            try:
                prof.__exit__(None, None, None)
                path = os.path.join(outdir, TRACE_FILE)
                prof.export_chrome_trace(path)
                cap.path = path
            except Exception as e:      # pragma: no cover - env-dependent
                print(f"[obs] profiler trace not written: {e}", flush=True)
