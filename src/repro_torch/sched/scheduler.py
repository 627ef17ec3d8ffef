"""The continuous-batching scheduler facade.

``Scheduler`` is the online front of ``ForestServer``: callers submit
per-user requests as they arrive and get back tickets; the scheduler
coalesces them into micro-batches under the dual trigger (row budget /
SLO deadline), overlaps host planning with device execution across
consecutive batches, and — when a ``LifecycleDriver`` is attached —
re-clusters the fleet codebook autonomously in low-load gaps with
rate-limited migration.

    sched = Scheduler(server, lifecycle=LifecycleDriver(server, clock))
    ticket = sched.submit("user00042", rows)   # returns immediately
    sched.pump()                               # form + dispatch due batches
    ticket.wait(); ticket.prediction           # resolved serve_safe result
    sched.flush()                              # drain everything

The pump loop is explicitly driven (no hidden thread): a production
host calls ``pump`` from its event loop; tests drive it with a
``VirtualClock`` for bit-deterministic batching, triggering, and
lifecycle decisions.  Execution overlap lives in ``PipelinedExecutor``
and defaults on under a wall clock, off (inline, deterministic) under a
virtual clock.
"""
from __future__ import annotations

import numpy as np

from .batcher import MicroBatch, MicroBatcher
from .clock import VirtualClock, WallClock
from .executor import PipelinedExecutor
from .queue import RequestQueue, SchedRequest


class Scheduler:
    """Continuous-batching request scheduler over one ``ForestServer``."""

    def __init__(
        self,
        server,
        clock=None,
        queue: RequestQueue | None = None,
        batcher: MicroBatcher | None = None,
        lifecycle=None,
        safe: bool = True,
        overlap: bool | None = None,
        fault_hook=None,
        prefetcher=None,
    ) -> None:
        self.server = server
        self.clock = clock if clock is not None else WallClock()
        self.queue = queue if queue is not None else RequestQueue()
        self.batcher = batcher if batcher is not None else MicroBatcher()
        self.lifecycle = lifecycle
        self.prefetcher = prefetcher
        if overlap is None:
            # virtual time has no concurrency to overlap with — run inline
            # so tests are single-threaded deterministic
            overlap = not isinstance(self.clock, VirtualClock)
        self.executor = PipelinedExecutor(
            server, self.clock, safe=safe, overlap=overlap,
            fault_hook=fault_hook, prefetcher=prefetcher,
        )
        self.completed: list[SchedRequest] = []

    # ---------------- intake ----------------------------------------------
    def submit(
        self,
        user_id: str,
        rows: np.ndarray,
        deadline_s: float | None = None,
    ) -> SchedRequest:
        """Admit one request (deadline = now + SLO unless overridden) and
        return its ticket.  Raises ``sched.AdmissionError`` when the
        queue's admission bounds are full.  Call ``pump`` to let due
        micro-batches form and dispatch."""
        return self.queue.submit(
            user_id, rows, self.clock.now(), deadline_s=deadline_s
        )

    # ---------------- the pump loop ---------------------------------------
    def pump(self) -> int:
        """One scheduler step at the current clock time: form and
        dispatch every micro-batch whose trigger is due, then tick the
        lifecycle driver.  Returns the number of batches dispatched."""
        n = 0
        while True:
            batch = self.batcher.form(self.queue, self.clock.now())
            if batch is None:
                break
            self._dispatch(batch)
            n += 1
        if self.lifecycle is not None:
            self.lifecycle.tick(self.clock.now(), self.queue.pending_rows)
        return n

    def next_due_in(self) -> float | None:
        """Seconds until the deadline trigger next fires (<= 0: due now;
        ``None``: queue empty) — what an event loop sleeps between pumps."""
        oldest = self.queue.oldest_head_deadline()
        if oldest is None:
            return None
        return (
            oldest - self.batcher.plan_headroom_s - self.clock.now()
        )

    def flush(self, drain: bool = True) -> int:
        """Dispatch everything still queued regardless of triggers, then
        (by default) block until the executor drains.  Returns the number
        of batches dispatched."""
        n = 0
        while True:
            batch = self.batcher.form(
                self.queue, self.clock.now(), flush=True
            )
            if batch is None:
                break
            self._dispatch(batch)
            n += 1
        if drain:
            self.executor.drain()
        return n

    def _dispatch(self, batch: MicroBatch) -> None:
        self.completed.extend(batch.requests)  # resolved in flight order
        self.executor.submit(batch)

    def close(self) -> None:
        """Flush, drain, and stop the executor worker (and the residency
        prefetcher's, when one is attached)."""
        self.flush()
        self.executor.close()
        if self.prefetcher is not None:
            self.prefetcher.close()

    # ---------------- observability ---------------------------------------
    def latency_stats(self, slack_s: float = 0.0) -> dict:
        """Latency distribution over resolved requests: p50/p99/max
        arrival-to-completion, SLO attainment, and deadline misses beyond
        ``slack_s``."""
        done = [r for r in self.completed if r.done]
        if not done:
            return {"n_completed": 0}
        lat = np.array([r.latency_s for r in done])
        excess = np.array([r.deadline_excess_s for r in done])
        misses = int((excess > slack_s).sum())
        return {
            "n_completed": len(done),
            "p50_ms": round(float(np.percentile(lat, 50)) * 1e3, 3),
            "p99_ms": round(float(np.percentile(lat, 99)) * 1e3, 3),
            "max_ms": round(float(lat.max()) * 1e3, 3),
            "deadline_misses": misses,
            "slo_attainment": round(1.0 - misses / len(done), 4),
            "max_deadline_excess_ms": round(float(excess.max()) * 1e3, 3),
            "slack_s": slack_s,
        }

    def stats(self) -> dict:
        """One dict for the whole scheduling layer: queue occupancy and
        admission counters, batch-formation trigger mix, executor
        counters, latency distribution, request status counts, and the
        lifecycle driver's state when attached."""
        statuses: dict[str, int] = {}
        for r in self.completed:
            if r.done:
                statuses[r.status] = statuses.get(r.status, 0) + 1
        return {
            "queue": self.queue.stats(),
            "batcher": self.batcher.stats(),
            "executor": self.executor.stats(),
            "latency": self.latency_stats(),
            "statuses": statuses,
            "lifecycle": (
                self.lifecycle.stats() if self.lifecycle is not None
                else None
            ),
        }
