"""Serving clocks: wall time for live traffic, manual time for tests.

The real-time layer spans two time domains. The backend keeps its own
clock — the engine's modeled (virtual) or measured iteration time — which
prices scheduling decisions, admission verdicts, and every trace
benchmark. The *serving* clock is what the caller experiences: the wall
seconds between submitting a request and receiving its tokens.
``WallClock`` is the production serving clock; ``ManualClock`` freezes the
serving domain so async-lifecycle tests and trace replays through the
real-time loop stay deterministic (the "paused clock" of the
wall-vs-drive equivalence tests).
"""
from __future__ import annotations

import time


class WallClock:
    """Monotonic wall seconds since construction (server start)."""

    def __init__(self):
        self._t0 = time.monotonic()

    def now(self) -> float:
        return time.monotonic() - self._t0


class ManualClock:
    """A serving clock that only moves when told to — paused by default.

    With this clock the real-time loop runs as fast as the backend steps
    while every wall stamp stays at a known value, making the async path
    bit-comparable to a ``drive()`` trace replay."""

    def __init__(self, t: float = 0.0):
        self._t = t

    def now(self) -> float:
        return self._t

    def advance(self, dt: float) -> None:
        assert dt >= 0.0, "serving clocks are monotonic"
        self._t += dt
