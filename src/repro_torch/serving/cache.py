"""Cross-batch plan/pack memoization with PER-USER invalidation (ISSUE 4
tentpole, refined by ISSUE 5's partial invalidation — the ROADMAP
"plan-cache partial invalidation" item).

Two LRU maps, both keyed by the batch's user-run signature
(``ServePlan.signature``) and validated by a TOKEN the serving session
derives from the users the entry covers:

* PLANS — the host-side IR (grouping, sort permutation, engine choice).
  Token: the tuple of the store's PER-USER registration versions for the
  batch's users.  Re-registering (or migrating) one user invalidates only
  plans containing that user.
* PACKS — the arena-gathered device arrays + chunk ranges a plan resolves
  to at execute time.  Token: per user, the pair (store user version,
  arena run-admission token).  A pack survives exactly while every one of
  its users is still resident with unchanged content — so a codebook
  migration or arena eviction touching user A leaves user B's warm packs
  alone, while evicted users' gathered device copies are still swept
  eagerly (``sweep_packs``) so they cannot survive as hidden copies and
  defeat the arena's capacity bound.

A hot repeated batch therefore skips grouping, the argsort, the device
index-gather, and the chunk-range computation — it pays only the row
upload, the kernel, and the finalize.

The cache is THREAD-SAFE (one lock around every map operation): the
scheduler's pipelined executor (ISSUE 7) pre-plans batch *k+1* on the
submit thread while the worker thread plans/executes batch *k*, and both
paths go through this memo.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Callable

from ..runtime.guards import guarded_by


@guarded_by(
    "_lock",
    "_plans", "_packs",
    "plan_hits", "plan_misses", "pack_hits", "pack_misses",
    "invalidations",
)
class PlanCache:
    """LRU memo of ServePlans and their gathered packs, with per-user
    token invalidation and hit/miss accounting for admission-control
    dashboards."""

    def __init__(self, capacity: int = 64) -> None:
        self.capacity = capacity
        self._lock = threading.Lock()
        # signature -> (token, plan)
        self._plans: OrderedDict[tuple, tuple[tuple, Any]] = OrderedDict()
        # signature -> (users, token, pack)
        self._packs: OrderedDict[
            tuple, tuple[tuple, tuple, Any]
        ] = OrderedDict()
        self.plan_hits = 0
        self.plan_misses = 0
        self.pack_hits = 0
        self.pack_misses = 0
        self.invalidations = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._packs)

    # ---------------- plans -----------------------------------------------
    def get_plan(self, key: tuple, token: tuple):
        """The memoized plan under ``key``, provided its per-user token
        still matches; a mismatch drops the entry (counted as an
        invalidation) and misses."""
        with self._lock:
            entry = self._plans.get(key)
            if entry is not None and entry[0] != token:
                del self._plans[key]
                self.invalidations += 1
                entry = None
            if entry is None:
                self.plan_misses += 1
                return None
            self._plans.move_to_end(key)
            self.plan_hits += 1
            return entry[1]

    def put_plan(self, key: tuple, token: tuple, plan) -> None:
        """Memoize ``plan`` under ``key`` with its validity ``token``."""
        with self._lock:
            self._plans[key] = (token, plan)
            self._plans.move_to_end(key)
            while len(self._plans) > self.capacity:
                self._plans.popitem(last=False)

    # ---------------- gathered packs --------------------------------------
    def sweep_packs(
        self, current_token_of: Callable[[tuple], tuple]
    ) -> None:
        """Drop every pack whose users' current token no longer matches
        the one it was stored under.  Sweeping eagerly (not just the
        queried key) keeps evicted users' gathered device arrays from
        surviving as hidden copies, which would defeat the arena's
        capacity bound — but packs whose users are untouched stay put
        (partial invalidation)."""
        with self._lock:
            stale = [
                k for k, (users, token, _) in self._packs.items()
                if current_token_of(users) != token
            ]
            for k in stale:
                del self._packs[k]
            self.invalidations += len(stale)

    def get_pack(self, key: tuple, token: tuple):
        """The memoized gathered pack under ``key``, provided its per-user
        token still matches (callers sweep first; the token check here
        guards the queried entry itself)."""
        with self._lock:
            entry = self._packs.get(key)
            if entry is not None and entry[1] != token:
                del self._packs[key]
                self.invalidations += 1
                entry = None
            if entry is None:
                self.pack_misses += 1
                return None
            self._packs.move_to_end(key)
            self.pack_hits += 1
            return entry[2]

    def put_pack(
        self, key: tuple, users: tuple, token: tuple, pack
    ) -> None:
        """Memoize a gathered ``pack`` for ``users`` under ``key`` with
        its per-user validity ``token``."""
        with self._lock:
            self._packs[key] = (users, token, pack)
            self._packs.move_to_end(key)
            while len(self._packs) > self.capacity:
                self._packs.popitem(last=False)

    # ---------------- maintenance -----------------------------------------
    def clear(self) -> None:
        """Drop every memoized plan and pack."""
        with self._lock:
            self._plans.clear()
            self._packs.clear()

    def stats(self) -> dict:
        """Hit/miss/invalidation counters for dashboards.  Reads under
        the lock: the scheduler's submit thread mutates these counters
        concurrently, and a stats snapshot must be one consistent state,
        not a torn mix of two (the ISSUE 9 lock-discipline fix)."""
        with self._lock:
            plan_total = self.plan_hits + self.plan_misses
            pack_total = self.pack_hits + self.pack_misses
            return {
                "plans": len(self._plans),
                "packs": len(self._packs),
                "plan_hits": self.plan_hits,
                "plan_misses": self.plan_misses,
                "plan_hit_rate": (
                    round(self.plan_hits / plan_total, 4)
                    if plan_total else 0.0
                ),
                "pack_hits": self.pack_hits,
                "pack_misses": self.pack_misses,
                "pack_hit_rate": (
                    round(self.pack_hits / pack_total, 4)
                    if pack_total else 0.0
                ),
                "invalidations": self.invalidations,
            }
