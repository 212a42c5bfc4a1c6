"""Compile-count tracking: episode builds and CUDA-graph captures.

Counterpart of ``repro/obs/compile.py``. The repo's scaling story rests
on compile-count invariants ("a 4-method x seeds x scenarios grid is one
compiled episode per pack"). In the port, "a compile" is one scan episode
built by ``RolloutDriver.run(mode="scan")``: its static buffers, and on
the card one warm-up and the capture of its two slot graphs (with and
without a train step). ``CompileTracker`` counts them at two levels:

* **Event stream** — while the context is active, every episode built
  and every capture anywhere in the process is recorded, with its
  seconds and the building driver's ``label`` (``PackProgram`` labels its
  driver with its pack's). Drivers built by other code are seen too, so
  this is a logging signal; ``by_label()`` groups it.
* **Tracked drivers** — ``track(name, obj)`` registers a
  ``RolloutDriver`` (or anything with a ``driver``, such as a
  ``PackProgram``); ``counts()`` reads each one's ``episodes_built``
  counter. A fresh driver starts at zero, so this is the exact
  per-program count the pack guards assert.

Usage::

    with CompileTracker() as ct:
        prog = PackProgram(pack)
        prog.run(); prog.run()
        ct.track(pack.label(), prog)
    ct.assert_counts({pack.label(): 1})
    log(ct.summary())   # episodes, graphs, capture seconds, tracked
"""
from __future__ import annotations

from typing import Optional

EPISODE_EVENT = "episode"     # one scan episode's static buffers built
CAPTURE_EVENT = "capture"     # its slot graphs warmed up and captured

# the active trackers' listeners, told of every build (record_build)
_LISTENERS: list = []


def record_build(label: Optional[str], event: str, seconds: float,
                 count: int = 1) -> None:
    """Tell the active trackers of one build: ``event`` is
    ``EPISODE_EVENT`` or ``CAPTURE_EVENT`` (``count`` graphs), by the
    driver labelled ``label``. ``RolloutDriver`` calls it."""
    for listener in list(_LISTENERS):
        listener(label, event, float(seconds), int(count))


def _driver(obj):
    """The driver a tracked object stands for."""
    return getattr(obj, "driver", obj)


class CompileTracker:
    """Context manager that counts scan episodes built and graphs
    captured while active."""

    def __init__(self):
        self.events: list = []       # (label, event, seconds, count)
        self._tracked: dict = {}     # name -> driver (or its holder)
        self._active = False

    # ------------------------------------------------------------- context
    def __enter__(self) -> "CompileTracker":
        def listener(label, event, seconds, count):
            if self._active:
                self.events.append((label, event, seconds, count))

        self._listener = listener
        self._active = True
        _LISTENERS.append(listener)
        return self

    def __exit__(self, *exc) -> None:
        self._active = False
        if self._listener in _LISTENERS:
            _LISTENERS.remove(self._listener)

    # ------------------------------------------------------- event stream
    def _sum(self, event: str, field: int) -> float:
        return sum(e[field] for e in self.events if e[1] == event)

    @property
    def n_backend_compiles(self) -> int:
        """Scan episodes built in the process while active."""
        return int(self._sum(EPISODE_EVENT, 3))

    @property
    def n_graphs_captured(self) -> int:
        """CUDA graphs captured in the process while active."""
        return int(self._sum(CAPTURE_EVENT, 3))

    @property
    def total_compile_s(self) -> float:
        """Seconds spent building episodes and capturing graphs (warm-up
        slots included) while active."""
        return sum(e[2] for e in self.events)

    def by_label(self) -> dict:
        """The event stream grouped by driver label: {label: {"episodes",
        "graphs", "seconds"}}."""
        out: dict = {}
        for label, event, seconds, count in self.events:
            row = out.setdefault(label, {"episodes": 0, "graphs": 0,
                                         "seconds": 0.0})
            row["episodes" if event == EPISODE_EVENT else "graphs"] += count
            row["seconds"] += seconds
        return out

    # --------------------------------------------------- tracked drivers
    def track(self, name: str, obj) -> None:
        """Register a ``RolloutDriver``, or an object with a ``driver``
        (``PackProgram``), whose episodes to pin."""
        self._tracked[name] = obj

    @staticmethod
    def cache_size(obj) -> Optional[int]:
        """Scan episodes one tracked driver has built (None if ``obj``
        has no such counter)."""
        n = getattr(_driver(obj), "episodes_built", None)
        return None if n is None else int(n)

    def counts(self) -> dict:
        return {name: self.cache_size(obj)
                for name, obj in self._tracked.items()}

    def assert_counts(self, expected: dict) -> dict:
        """Assert each tracked driver built exactly N episodes.

        Entries whose counter is unreadable are skipped, as in the
        reference. Returns the observed counts.
        """
        got = self.counts()
        for name, want in expected.items():
            n = got.get(name)
            if n is not None:
                assert n == want, (f"{name}: {n} episodes built, "
                                   f"expected {want}")
        return got

    # ------------------------------------------------------------ summary
    def summary(self) -> dict:
        """JSON-safe snapshot for run logs / bench rows."""
        return {
            "n_backend_compiles": self.n_backend_compiles,
            "n_graphs_captured": self.n_graphs_captured,
            "total_compile_s": round(self.total_compile_s, 4),
            "tracked": self.counts(),
        }
