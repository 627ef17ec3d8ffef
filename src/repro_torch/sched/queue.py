"""Per-tenant request queue with admission bounds.

``RequestQueue`` holds one FIFO per tenant of ``SchedRequest`` tickets —
``(user_id, rows)`` plus arrival time, deadline, and a result slot the
executor fills.  Admission is BOUNDED three ways (global requests,
global rows, per-tenant requests); a full queue rejects with a typed
``AdmissionError`` instead of buffering unboundedly, which is what keeps
the latency SLO meaningful under overload (queueing delay is capped by
construction).

The queue itself never looks at a clock: callers stamp ``now`` into
``submit``, so the same code runs under the wall clock and the
deterministic virtual clock.
"""
from __future__ import annotations

from collections import OrderedDict, deque
from dataclasses import dataclass, field
from threading import Event, Lock

import numpy as np

from ..runtime.guards import guarded_by


class AdmissionError(RuntimeError):
    """Raised by ``RequestQueue.submit`` when an admission bound is hit —
    the caller should shed or retry later, not buffer."""


@dataclass(slots=True)
class SchedRequest:
    """One queued prediction request: the ticket the scheduler hands back
    at ``submit`` time and fills in when its micro-batch completes.

    ``status`` moves ``"pending"`` -> ``"ok"`` | ``"quarantined"`` |
    ``"failed"`` (the latter two mirror ``ForestServer.serve_safe``
    semantics plus batch-level fault isolation).  ``deadline`` is the
    absolute completion target (arrival + SLO); ``latency_s`` is valid
    once ``done``."""

    seq: int
    user_id: str
    rows: np.ndarray
    arrival_t: float
    deadline: float
    status: str = "pending"
    prediction: np.ndarray | None = None
    detail: str = ""
    degraded: bool = False
    completed_t: float | None = None
    batch_seq: int | None = None
    # resolution signalling: a bare flag on the hot path, with the Event
    # materialized lazily only when somebody actually wait()s.  The
    # flag-then-event / event-then-flag ordering below makes the
    # handshake race-free under the GIL (each side publishes its write
    # before reading the other's).
    _done_flag: bool = field(default=False, repr=False, compare=False)
    _event: Event | None = field(default=None, repr=False, compare=False)

    @property
    def done(self) -> bool:
        """True once the executor resolved this request (any status)."""
        return self._done_flag

    def _resolve(self) -> None:
        """Executor side: publish resolution, then wake any waiter."""
        self._done_flag = True
        ev = self._event
        if ev is not None:
            ev.set()

    def wait(self, timeout: float | None = None) -> bool:
        """Block until resolved (overlapped executor); immediate under the
        inline executor.  Returns ``done``."""
        if self._done_flag:
            return True
        ev = self._event
        if ev is None:
            ev = self._event = Event()
            if self._done_flag:  # resolver may have missed the new event
                return True
        return ev.wait(timeout)

    @property
    def n_rows(self) -> int:
        return int(len(self.rows))

    @property
    def latency_s(self) -> float:
        """Arrival-to-completion latency; raises if not yet resolved."""
        if self.completed_t is None:
            raise ValueError(f"request {self.seq} is not resolved yet")
        return self.completed_t - self.arrival_t

    @property
    def deadline_excess_s(self) -> float:
        """Seconds past the deadline this request completed (<= 0 means
        it made the SLO)."""
        if self.completed_t is None:
            raise ValueError(f"request {self.seq} is not resolved yet")
        return self.completed_t - self.deadline


@guarded_by(
    "_lock",
    "_tenants", "_n_pending", "_pending_rows", "_next_seq",
    "n_admitted", "n_rejected", "rows_admitted",
)
class RequestQueue:
    """Per-tenant FIFO of pending requests with admission bounds.

    ``slo_s`` is the default latency SLO: a request submitted at ``now``
    gets ``deadline = now + slo_s`` unless the caller passes an explicit
    ``deadline_s``.  Service is FIFO per tenant, so the batcher's
    deadline trigger looks at TENANT-HEAD deadlines (``head_deadlines``):
    a request behind another of the same tenant cannot be served before
    it, so the head deadline is the earliest *servable* one.

    Thread-safe: client threads ``submit``
    while the scheduler's pump thread peeks/pops, so every access to the
    tenant map, occupancy totals, and admission counters holds ``_lock``
    — previously the admission check-then-append could interleave and
    overshoot the bounds, and ``stats`` could read torn totals.
    """

    def __init__(
        self,
        slo_s: float = 0.25,
        max_pending_requests: int = 4096,
        max_pending_rows: int = 1 << 20,
        max_pending_per_tenant: int = 512,
    ) -> None:
        self.slo_s = float(slo_s)
        self.max_pending_requests = int(max_pending_requests)
        self.max_pending_rows = int(max_pending_rows)
        self.max_pending_per_tenant = int(max_pending_per_tenant)
        self._lock = Lock()
        self._tenants: OrderedDict[str, deque[SchedRequest]] = OrderedDict()
        self._n_pending = 0
        self._pending_rows = 0
        self._next_seq = 0
        self.n_admitted = 0
        self.n_rejected = 0
        self.rows_admitted = 0

    # ---------------- admission -------------------------------------------
    def submit(
        self,
        user_id: str,
        rows: np.ndarray,
        now: float,
        deadline_s: float | None = None,
    ) -> SchedRequest:
        """Admit one ``(user_id, rows)`` request at time ``now`` and
        return its ticket.  Raises ``AdmissionError`` when any bound
        (global requests, global rows, per-tenant requests) is full."""
        rows = np.ascontiguousarray(rows, np.int32)
        if rows.ndim != 2:
            raise ValueError(
                f"rows must be a (n, d) block, got shape {rows.shape}"
            )
        # admission is one atomic check-then-append: concurrent submits
        # racing the bounds check could otherwise both pass and overshoot
        with self._lock:
            fifo = self._tenants.get(user_id)
            if self._n_pending >= self.max_pending_requests:
                self.n_rejected += 1
                raise AdmissionError(
                    f"queue full: {self._n_pending} pending requests "
                    f"(bound {self.max_pending_requests})"
                )
            if self._pending_rows + len(rows) > self.max_pending_rows:
                self.n_rejected += 1
                raise AdmissionError(
                    f"queue full: {self._pending_rows} pending rows + "
                    f"{len(rows)} would exceed the "
                    f"{self.max_pending_rows}-row bound"
                )
            if (fifo is not None
                    and len(fifo) >= self.max_pending_per_tenant):
                self.n_rejected += 1
                raise AdmissionError(
                    f"tenant {user_id!r} has {len(fifo)} pending requests "
                    f"(bound {self.max_pending_per_tenant})"
                )
            slo = self.slo_s if deadline_s is None else float(deadline_s)
            req = SchedRequest(
                seq=self._next_seq,
                user_id=user_id,
                rows=rows,
                arrival_t=now,
                deadline=now + slo,
            )
            self._next_seq += 1
            if fifo is None:
                fifo = self._tenants[user_id] = deque()
            fifo.append(req)
            self._n_pending += 1
            self._pending_rows += len(rows)
            self.n_admitted += 1
            self.rows_admitted += len(rows)
            return req

    # ---------------- state the batcher reads -----------------------------
    @property
    def n_pending(self) -> int:
        with self._lock:
            return self._n_pending

    @property
    def pending_rows(self) -> int:
        with self._lock:
            return self._pending_rows

    def head_deadlines(self) -> dict[str, float]:
        """Tenant -> deadline of its FIFO head (the earliest servable
        deadline per tenant — service is FIFO within a tenant)."""
        with self._lock:
            return {
                u: fifo[0].deadline
                for u, fifo in self._tenants.items() if fifo
            }

    def oldest_head_deadline(self) -> float | None:
        """The earliest servable deadline across all tenants, or ``None``
        when the queue is empty — the batcher's deadline trigger."""
        heads = self.head_deadlines()
        return min(heads.values()) if heads else None

    def peek(self, user_id: str) -> SchedRequest | None:
        """The tenant's FIFO head without removing it."""
        with self._lock:
            fifo = self._tenants.get(user_id)
            return fifo[0] if fifo else None

    def pop(self, user_id: str) -> SchedRequest:
        """Remove and return the tenant's FIFO head."""
        with self._lock:
            fifo = self._tenants[user_id]
            req = fifo.popleft()
            if not fifo:
                del self._tenants[user_id]
            self._n_pending -= 1
            self._pending_rows -= req.n_rows
            return req

    def stats(self) -> dict:
        """Occupancy + admission counters for dashboards, read as one
        consistent snapshot under the lock."""
        with self._lock:
            return {
                "n_pending": self._n_pending,
                "pending_rows": self._pending_rows,
                "n_tenants_pending": len(self._tenants),
                "n_admitted": self.n_admitted,
                "n_rejected": self.n_rejected,
                "rows_admitted": self.rows_admitted,
                "slo_s": self.slo_s,
            }
