"""Clock abstraction for the serving fleet.

The fleet's event loop (``fleet/loadgen.py``) is written against a single
``Clock`` protocol so that ONE implementation of frontend/pool/autoscaler
logic drives two very different run modes:

  * :class:`VirtualClock` — time jumps instantly to the next event.  Trace
    replay of an hour-long Azure-shaped workload finishes in milliseconds,
    deterministic, and directly comparable with ``core/simulator.py``.
  * :class:`WallClock` — logical time is tied to ``time.monotonic()`` with a
    ``speed`` factor (speed=60 replays one logical minute per real second).
    Used when the fleet serves *real* :class:`InferenceEngine` replicas and
    cold starts / execution are genuinely measured.

``sleep_until`` is the only blocking point: virtual clocks return
immediately, wall clocks sleep the scaled remainder.
"""
from __future__ import annotations

import time


class Clock:
    """Monotonic logical-seconds clock."""

    def now(self) -> float:
        raise NotImplementedError

    def sleep_until(self, t: float) -> None:
        raise NotImplementedError


class VirtualClock(Clock):
    """Discrete-event time: ``sleep_until`` teleports, never blocks."""

    def __init__(self, start: float = 0.0):
        self._now = start

    def now(self) -> float:
        return self._now

    def sleep_until(self, t: float) -> None:
        if t > self._now:
            self._now = t


class WallClock(Clock):
    """Scaled wall-clock: ``speed`` logical seconds pass per real second.

    With real engines the blocking work itself advances the clock; the
    event loop only sleeps for gaps between scheduled events.
    """

    def __init__(self, speed: float = 1.0):
        assert speed > 0
        self.speed = speed
        self._t0 = time.monotonic()

    def now(self) -> float:
        return (time.monotonic() - self._t0) * self.speed

    def sleep_until(self, t: float) -> None:
        remaining = (t - self.now()) / self.speed
        if remaining > 0:
            time.sleep(remaining)
