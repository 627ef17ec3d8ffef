"""Pipelined micro-batch execution.

``PipelinedExecutor`` runs micro-batches through a ``ForestServer``,
overlapping the HOST half of batch *k+1* with the DEVICE half of batch
*k*: ``submit`` pre-builds the plan for the incoming batch on the
caller's thread (grouping, argsort, engine cost model — all host work,
memoized into the server's ``PlanCache``) while the single worker
thread is still blocked on the previous batch's kernel; when the worker
reaches the new batch, its plan stage is a cache hit and it goes
straight to pack/execute.  Ordering is preserved (one worker, FIFO
queue), so results are identical to inline execution.

Per-request semantics are exactly ``ForestServer.serve_safe``:
quarantined users come back ``status="quarantined"`` while healthy
users in the same micro-batch are served, transient arena faults are
retried/degraded inside the server.  On top of that the executor adds
BATCH-level fault isolation: an exception that escapes the serve path
(or the chaos ``fault_hook``) marks just that batch's requests
``status="failed"`` and the scheduler keeps going.

``overlap=False`` executes inline on the caller's thread — same
results, fully deterministic — which is what the virtual-clock tests
use.
"""
from __future__ import annotations

import queue as _queue
import threading

from ..runtime.guards import guarded_by
from .batcher import MicroBatch

_STOP = object()


@guarded_by(
    "_idle",
    "_inflight", "n_batches", "n_failed_batches", "n_preplanned",
)
class PipelinedExecutor:
    """Single-consumer micro-batch executor over one ``ForestServer``.

    ``_idle`` (a ``Condition``) is the one lock: it already guarded the
    in-flight count for backpressure, and it also guards
    the batch counters — ``_run`` mutates them on the worker thread
    while ``stats`` reads them from the pump thread."""

    def __init__(
        self,
        server,
        clock,
        safe: bool = True,
        overlap: bool = True,
        max_inflight: int = 2,
        fault_hook=None,
        prefetcher=None,
    ) -> None:
        self.server = server
        self.clock = clock
        self.safe = bool(safe)
        self.overlap = bool(overlap)
        # residency prefetcher (store.residency.Prefetcher): the pre-plan
        # slot hands it batch k+1's users while batch k executes, so
        # demoted users' shards are read + parsed off the serve path
        self.prefetcher = prefetcher
        if max_inflight < 1:
            raise ValueError(
                f"max_inflight must be positive, got {max_inflight}"
            )
        self.max_inflight = int(max_inflight)
        self.fault_hook = fault_hook
        self.n_batches = 0
        self.n_failed_batches = 0
        self.n_preplanned = 0
        self._inflight = 0
        self._idle = threading.Condition()
        self._work: _queue.SimpleQueue = _queue.SimpleQueue()
        self._worker: threading.Thread | None = None
        if self.overlap:
            self._worker = threading.Thread(
                target=self._worker_loop, name="sched-executor", daemon=True
            )
            self._worker.start()

    # ---------------- submit side (host stage) ----------------------------
    def submit(self, batch: MicroBatch) -> None:
        """Dispatch one micro-batch.  Pre-plans on the calling thread
        (overlapping the in-flight batch's device work), then executes —
        on the worker thread when overlapped, inline otherwise.

        Submission applies BACKPRESSURE: it blocks while ``max_inflight``
        batches are already queued (double buffering by default).  The
        bound matters beyond memory: pre-planning is host work that
        contends with the worker's own host stages, so racing arbitrarily
        far ahead *slows the pipeline down* — one batch ahead captures
        the whole overlap win."""
        if self.overlap:
            with self._idle:
                self._idle.wait_for(
                    lambda: self._inflight < self.max_inflight
                )
                self._inflight += 1
            self._preplan(batch)
            self._work.put(batch)
        else:
            if self.prefetcher is not None:
                # no overlap to hide the warm behind, but the prefetch
                # accounting (and its determinism under VirtualClock)
                # must match the overlapped path
                self._prefetch(batch)
            self._run(batch)

    def _preplan(self, batch: MicroBatch) -> None:
        """Build (and memoize) the plan the serve path will need, using
        row COUNTS only — plans don't depend on row values, so this is
        pure host work the device never waits for.  Quarantined users are
        left out to match the healthy subset ``serve_safe`` will plan."""
        quarantined = (
            set(self.server.quarantined_users) if self.safe else ()
        )
        reqs = [
            (r.user_id, r.n_rows)
            for r in batch.requests if r.user_id not in quarantined
        ]
        if not reqs:
            return
        if self.prefetcher is not None:
            self._prefetch(batch)
        try:
            self.server.plan(reqs)
            with self._idle:
                self.n_preplanned += 1
        except Exception:  # noqa: BLE001 — planning faults surface (and
            # are isolated) at execute time; pre-planning is best-effort
            pass

    def _prefetch(self, batch: MicroBatch) -> None:
        """Warm the batch's demoted users' shards (best-effort): under
        overlap this runs in the plan-of-k+1 slot, so the disk read +
        RFD1 parse overlaps batch k's device work.  The prefetcher
        filters quarantined users itself (it holds the server)."""
        try:
            self.prefetcher.request(r.user_id for r in batch.requests)
        except Exception:  # noqa: BLE001 — prefetch is advisory; the
            # serve path surfaces real faults through quarantine
            pass

    # ---------------- worker side (device stage) --------------------------
    def _worker_loop(self) -> None:
        while True:
            batch = self._work.get()
            if batch is _STOP:
                return
            try:
                self._run(batch)
            finally:
                with self._idle:
                    self._inflight -= 1
                    self._idle.notify_all()

    def _run(self, batch: MicroBatch) -> None:
        with self._idle:
            self.n_batches += 1
        requests = [(r.user_id, r.rows) for r in batch.requests]
        try:
            if self.fault_hook is not None:
                self.fault_hook(batch)
            if self.safe:
                statuses = self.server.serve_safe(requests)
                for r, st in zip(batch.requests, statuses):
                    r.status = st.status
                    r.prediction = st.prediction
                    r.detail = st.detail
                    r.degraded = st.degraded
            else:
                preds = self.server.serve(requests)
                for r, p in zip(batch.requests, preds):
                    r.status = "ok"
                    r.prediction = p
        except Exception as e:  # noqa: BLE001 — batch-level isolation:
            # one poisoned batch must not kill the scheduler loop
            with self._idle:
                self.n_failed_batches += 1
            detail = f"{type(e).__name__}: {e}"
            for r in batch.requests:
                r.status = "failed"
                r.detail = detail
        now = self.clock.now()
        for r in batch.requests:
            r.completed_t = now
            r._resolve()

    # ---------------- lifecycle -------------------------------------------
    def drain(self, timeout: float | None = None) -> bool:
        """Block until every submitted batch has executed.  Returns True
        when drained (always, under the inline executor)."""
        if not self.overlap:
            return True
        with self._idle:
            return self._idle.wait_for(
                lambda: self._inflight == 0, timeout
            )

    def close(self) -> None:
        """Drain and stop the worker thread (idempotent)."""
        if self._worker is None:
            return
        self.drain()
        self._work.put(_STOP)
        self._worker.join()
        self._worker = None

    def stats(self) -> dict:
        """Execution counters for dashboards, snapshotted under the
        lock (the worker thread mutates them concurrently)."""
        with self._idle:
            return {
                "n_batches": self.n_batches,
                "n_failed_batches": self.n_failed_batches,
                "n_preplanned": self.n_preplanned,
                "overlap": self.overlap,
                "max_inflight": self.max_inflight,
                "safe": self.safe,
            }
