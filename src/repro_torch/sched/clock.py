"""Clocks for the request scheduler.

Every scheduling decision — admission deadlines, the micro-batcher's
dual trigger, the lifecycle driver's poll window and migration rate
limit — reads time through one of these two clocks, never ``time.*``
directly.  That is what makes the scheduler testable: under a
``VirtualClock`` a test advances time by hand and every trigger,
deadline, and rate budget fires deterministically, bit-for-bit
reproducibly; production swaps in ``WallClock`` without touching any
scheduling code.
"""
from __future__ import annotations

import time


class VirtualClock:
    """Manually advanced clock for deterministic scheduler tests and
    benchmarks: ``now()`` returns the virtual time, ``advance``/``sleep``
    move it forward (sleeping never blocks)."""

    def __init__(self, start: float = 0.0) -> None:
        self._now = float(start)

    def now(self) -> float:
        """Current virtual time in seconds."""
        return self._now

    def advance(self, dt: float) -> float:
        """Move virtual time forward by ``dt`` seconds (never backward)."""
        if dt < 0:
            raise ValueError(f"cannot advance time backward (dt={dt})")
        self._now += float(dt)
        return self._now

    def sleep(self, dt: float) -> None:
        """Virtual sleep: advances time, returns immediately."""
        self.advance(dt)


class WallClock:
    """Monotonic wall clock for production use (immune to NTP steps)."""

    def now(self) -> float:
        """Seconds from an arbitrary monotonic origin."""
        return time.monotonic()

    def sleep(self, dt: float) -> None:
        """Real sleep."""
        if dt > 0:
            time.sleep(dt)
