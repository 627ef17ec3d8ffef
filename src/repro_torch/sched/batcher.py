"""Micro-batch formation under a dual trigger.

``MicroBatcher`` turns the per-tenant queue into a stream of
micro-batches for the executor.  A batch forms when EITHER trigger
fires, whichever comes first:

* **rows** — the queue holds at least ``max_rows`` pending rows: enough
  work to fill the kernel, no reason to wait;
* **deadline** — the earliest servable deadline is within
  ``plan_headroom_s`` of now: waiting any longer would blow the SLO
  (the headroom covers plan + execute for one batch).

Selection is tenant-coherent and deterministic: tenants are visited in
urgency order (earliest head deadline first) and each selected tenant
contributes its WHOLE FIFO run while the row budget lasts — grouping a
user's requests into one batch means the plan folds them into one
segment and the arena pack is gathered once.  The chosen requests are
then ordered canonically by ``(user_id, seq)``, so recurring workloads
produce recurring plan signatures and hit the serving session's
cross-batch ``PlanCache``.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from .queue import RequestQueue, SchedRequest


@dataclass
class MicroBatch:
    """One formed micro-batch: the requests it serves, which trigger
    fired (``"rows"`` | ``"deadline"`` | ``"flush"``), and when."""

    seq: int
    requests: list[SchedRequest] = field(default_factory=list)
    trigger: str = ""
    formed_t: float = 0.0

    @property
    def n_rows(self) -> int:
        return sum(r.n_rows for r in self.requests)

    @property
    def n_requests(self) -> int:
        return len(self.requests)

    @property
    def users(self) -> list[str]:
        """Distinct users, in batch order."""
        return list(dict.fromkeys(r.user_id for r in self.requests))


class MicroBatcher:
    """Coalesces queued requests into micro-batches under the dual
    trigger (max-rows budget / SLO deadline headroom)."""

    def __init__(
        self, max_rows: int = 1024, plan_headroom_s: float = 0.05
    ) -> None:
        if max_rows < 1:
            raise ValueError(f"max_rows must be positive, got {max_rows}")
        self.max_rows = int(max_rows)
        self.plan_headroom_s = float(plan_headroom_s)
        self._next_seq = 0
        self.n_batches = 0
        self.trigger_counts: dict[str, int] = {}

    def due(self, queue: RequestQueue, now: float) -> str | None:
        """Which trigger (if any) fires at ``now``: ``"rows"`` when the
        pending-row budget is met, else ``"deadline"`` when the earliest
        servable deadline is within the plan headroom."""
        if queue.n_pending == 0:
            return None
        if queue.pending_rows >= self.max_rows:
            return "rows"
        oldest = queue.oldest_head_deadline()
        if oldest is not None and now >= oldest - self.plan_headroom_s:
            return "deadline"
        return None

    def form(
        self, queue: RequestQueue, now: float, flush: bool = False
    ) -> MicroBatch | None:
        """Form one micro-batch if a trigger is due (or unconditionally
        with ``flush=True``, for drains); ``None`` otherwise.

        The first (most urgent) request is always taken even when it
        alone exceeds the row budget — an oversized request must not
        starve behind the budget it can never fit."""
        trigger = self.due(queue, now)
        if trigger is None:
            if not flush or queue.n_pending == 0:
                return None
            trigger = "flush"
        heads = queue.head_deadlines()
        order = sorted(heads, key=lambda u: (heads[u], u))
        taken: list[SchedRequest] = []
        rows = 0
        for user in order:
            while True:
                req = queue.peek(user)
                if req is None:
                    break
                if taken and rows + req.n_rows > self.max_rows:
                    break  # tenant's tail stays queued; try next tenant
                taken.append(queue.pop(user))
                rows += taken[-1].n_rows
            if rows >= self.max_rows:
                break
        # canonical order: same-user requests adjacent, recurring
        # workloads -> recurring plan signatures (PlanCache hits)
        taken.sort(key=lambda r: (r.user_id, r.seq))
        batch = MicroBatch(
            seq=self._next_seq, requests=taken, trigger=trigger,
            formed_t=now,
        )
        self._next_seq += 1
        self.n_batches += 1
        self.trigger_counts[trigger] = self.trigger_counts.get(trigger, 0) + 1
        for r in taken:
            r.batch_seq = batch.seq
        return batch

    def stats(self) -> dict:
        """Batch-formation counters (dual-trigger mix)."""
        return {
            "n_batches": self.n_batches,
            "trigger_counts": dict(self.trigger_counts),
            "max_rows": self.max_rows,
            "plan_headroom_s": self.plan_headroom_s,
        }
