"""Shared eviction policy for the store's decode caches (ISSUE 3).

Both the host tile cache (``TileCache``) and the device tile arena
(``TileArena``) evict by GreedyDual with a decode-cost weight: an entry's
priority is ``clock + cost`` at insert/access, the minimum-priority entry
is evicted first (ties broken least-recently-used), and the clock advances
to each evicted priority so long-idle expensive entries age out.  Equal
costs reduce exactly to LRU.  One implementation here keeps the two caches'
policies from drifting apart.
"""
from __future__ import annotations


def decode_cost(n_trees: int, heap_width: int) -> float:
    """Reconstruction cost proxy of a resident run: trees * 2**depth (a
    heap of width h holds 2**(depth+1) - 1 slots)."""
    return n_trees * (heap_width + 1) / 2


class GreedyDualClock:
    """The policy core: hands out ``(priority, last_access)`` keys and
    tracks the aging clock.  Containers keep their own entry maps and call
    ``touch`` on insert/access, ``evicted`` with each victim's priority,
    and pick victims as ``min()`` over the issued keys."""

    def __init__(self) -> None:
        self.clock = 0.0
        self._tick = 0

    def touch(self, cost: float) -> tuple[float, int]:
        """Priority key for an inserted/accessed entry of ``cost``."""
        self._tick += 1
        return (self.clock + cost, self._tick)

    def evicted(self, priority: float) -> None:
        """Advance the aging clock to an evicted entry's priority."""
        self.clock = priority
