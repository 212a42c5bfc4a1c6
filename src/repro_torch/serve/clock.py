"""Clock abstraction for the serving loop: virtual time vs wall time.

Counterpart of ``repro/serve/clock.py`` (a copy: pure Python).

The continuous-batching engine never reads ``time.*`` directly — every
admission/eviction/timeout decision takes an explicit ``now`` from a
``Clock``. Under test that clock is a ``VirtualClock``: time advances
only when the engine says so (one decode step = one ``advance(slot_s)``),
so a load test over thousands of requests is a pure function of
(seed, trace) — no sleeps, no flaky wall-clock races, byte-identical
replays. In production the same loop runs against a ``WallClock``.

The split mirrors the rest of the repo's "state as data" discipline:
the clock is the one ambient input an async serving loop usually hides,
so it is made an explicit, swappable dependency instead.
"""
from __future__ import annotations

import time


class VirtualClock:
    """Deterministic simulated time; advances only via ``advance``.

    The serving engine advances it by ``slot_s`` per decode step, so
    simulated arrival times from the load generator line up with the
    engine's step grid regardless of host speed.
    """

    def __init__(self, t0: float = 0.0):
        self._t = float(t0)

    def now(self) -> float:
        return self._t

    def advance(self, dt: float) -> float:
        if dt < 0:
            raise ValueError(f"clock cannot run backwards (dt={dt})")
        self._t += float(dt)
        return self._t


class WallClock:
    """Monotonic wall time (``perf_counter``), zeroed at construction.

    ``advance`` is a no-op — wall time advances itself; the parameter is
    accepted so the engine loop is clock-agnostic.
    """

    def __init__(self):
        self._t0 = time.perf_counter()

    def now(self) -> float:
        return time.perf_counter() - self._t0

    def advance(self, dt: float) -> float:  # noqa: ARG002 - interface parity
        return self.now()
