"""Self-driving codebook lifecycle.

``LifecycleDriver`` closes the loop the ROADMAP called "self-driving":
the drift monitor (``store.lifecycle.drift_report``) decides WHEN to
recluster and the migration machinery does the moving, with no human
calling ``recluster()``:

* **watch** — polls ``drift_report`` on a LOAD-AWARE window: the poll
  interval stretches with queue depth so a busy scheduler is not taxed
  with observability work (the report itself is memoized on the store
  registry version, so an unchanged fleet polls for free).
* **trigger** — once the monitor recommends a recluster AND the queue is
  in a low-load gap (pending rows at or under ``low_load_rows``), the
  driver runs a journaled ``recluster(mode, migrate=False)``: successor
  codebook built and installed, nothing migrated yet.  Mixed-generation
  serving keeps every request exact from this moment on.
* **migrate** — per-user migration is RATE-LIMITED to
  ``migrate_users_per_s`` (a budget accumulator over clock time, at most
  ``max_users_per_tick`` per tick), each user journaled
  intent-before/commit-after exactly like ``lifecycle.recluster`` would,
  so serving latency stays inside the SLO mid-migration and a crash at
  any point is recoverable via ``resume_recluster``.  Superseded-
  generation GC runs strictly after the journal commits.

The driver is a plain ``tick(now, pending_rows)`` callable — the
scheduler invokes it from its pump loop, so under a virtual clock every
poll, trigger, and migration step is deterministic.
"""
from __future__ import annotations

from ..store.lifecycle import (
    MigrationJournal,
    RemapTable,
    drift_report,
    migrate_user,
    recluster,
)


class LifecycleDriver:
    """Autonomous drift-poll -> recluster -> rate-limited-migration loop
    over a ``ForestServer``'s store."""

    def __init__(
        self,
        server,
        clock,
        poll_interval_s: float = 1.0,
        max_poll_interval_s: float = 8.0,
        recluster_threshold: float = 0.2,
        low_load_rows: int = 256,
        migrate_users_per_s: float = 50.0,
        max_users_per_tick: int = 8,
        mode: str = "extend",
        seed: int = 0,
        verify: bool = True,
        journal_path: str | None = None,
        scrubber=None,
        scrub_interval_s: float = 2.0,
        scrub_shards_per_tick: int = 64,
    ) -> None:
        self.server = server
        self.clock = clock
        self.poll_interval_s = float(poll_interval_s)
        self.max_poll_interval_s = float(max_poll_interval_s)
        self.recluster_threshold = float(recluster_threshold)
        self.low_load_rows = int(low_load_rows)
        self.migrate_users_per_s = float(migrate_users_per_s)
        self.max_users_per_tick = int(max_users_per_tick)
        self.mode = mode
        self.seed = seed
        self.verify = verify
        self.journal_path = journal_path
        # background scrubbing: a ``store.durable.Scrubber``
        # ticked in the same low-load gaps as recluster — durability work
        # must not tax a loaded queue
        self.scrubber = scrubber
        self.scrub_interval_s = float(scrub_interval_s)
        self.scrub_shards_per_tick = int(scrub_shards_per_tick)
        self._next_scrub: float | None = None
        # state machine: "watching" -> "migrating" -> "watching"
        self.state = "watching"
        self._next_poll: float | None = None
        self._remap: RemapTable | None = None
        self._pending: list[str] = []
        self._journal: MigrationJournal | None = None
        self._budget = 0.0
        self._last_budget_t: float | None = None
        # counters for dashboards / the bench
        self.n_polls = 0
        self.n_reclusters = 0
        self.n_migrated = 0
        self.n_migration_ticks = 0
        self.n_deferred = 0
        self.n_recluster_failures = 0
        self.n_scrub_ticks = 0
        self.n_scrub_failures = 0
        self.last_report: dict | None = None
        self.last_error: str | None = None

    @property
    def store(self):
        return self.server.store

    # ---------------- the tick --------------------------------------------
    def tick(self, now: float, pending_rows: int) -> None:
        """One driver step, called from the scheduler's pump loop with
        the current queue depth (rows) for load awareness."""
        if self.state == "migrating":
            self._migrate_some(now)
            return
        self._maybe_scrub(now, pending_rows)
        if self._next_poll is not None and now < self._next_poll:
            return
        # load-aware window: a loaded queue stretches the poll interval
        # (linearly in queue depth, capped), an idle one polls at base rate
        load = pending_rows / max(self.low_load_rows, 1)
        interval = min(
            self.poll_interval_s * (1.0 + load), self.max_poll_interval_s
        )
        self._next_poll = now + interval
        # drop quarantines whose delta changed since (repair/migration)
        # before reading the set — serve_safe does the same refresh, but
        # an idle fleet may not see a serve between repair and poll
        self.server._refresh_quarantine()
        report = drift_report(
            self.store,
            recluster_threshold=self.recluster_threshold,
            exclude=tuple(self.server.quarantined_users),
        )
        self.n_polls += 1
        self.last_report = {
            k: report[k]
            for k in (
                "n_users", "codebook_generation", "n_pending_migration",
                "fallback_user_fraction", "fallback_overhead_fraction",
                "recommend_recluster",
            )
        }
        if (
            report["recommend_recluster"]
            and report["n_pending_migration"] == 0
            and pending_rows <= self.low_load_rows
        ):
            if self.server.quarantined_users:
                # a quarantined delta cannot be decoded, hence cannot be
                # migrated — defer until it is repaired or dropped
                self.n_deferred += 1
                return
            try:
                self._start_recluster(now)
            except Exception as e:  # noqa: BLE001 — a failed recluster
                # must not take the scheduler's pump loop down with it
                self.n_recluster_failures += 1
                self.last_error = f"{type(e).__name__}: {e}"
                self.state = "watching"
                self._pending = []

    def _maybe_scrub(self, now: float, pending_rows: int) -> None:
        """One bounded scrub tick when the queue is in a low-load gap and
        the scrub interval elapsed.  A scrubber fault is counted, never
        propagated — durability maintenance must not take down the pump
        loop."""
        if (
            self.scrubber is None
            or pending_rows > self.low_load_rows
            or (self._next_scrub is not None and now < self._next_scrub)
        ):
            return
        self._next_scrub = now + self.scrub_interval_s
        try:
            self.scrubber.tick(self.scrub_shards_per_tick)
            self.n_scrub_ticks += 1
        except Exception as e:  # noqa: BLE001 — keep the pump loop alive
            self.n_scrub_failures += 1
            self.last_error = f"{type(e).__name__}: {e}"

    # ---------------- recluster + rate-limited migration ------------------
    def _start_recluster(self, now: float) -> None:
        """Build + install the successor generation (journaled), then
        hand the per-user migration to the rate limiter."""
        journal = MigrationJournal(path=self.journal_path)
        result = recluster(
            self.store, mode=self.mode, seed=self.seed,
            migrate=False, journal=journal,
        )
        self._journal = journal
        self._remap = result.remap
        self._pending = [
            u for u in self.store.user_ids
            if self.store.delta(u).codebook_generation
            != self.store.generation
        ]
        self._budget = 0.0
        self._last_budget_t = now
        self.n_reclusters += 1
        if self._pending:
            self.state = "migrating"
        else:
            self._finish_migration()

    def _migrate_some(self, now: float) -> None:
        """Migrate up to the rate budget's worth of users this tick."""
        last = self._last_budget_t if self._last_budget_t is not None else now
        dt = max(now - last, 0.0)
        self._last_budget_t = now
        self._budget = min(
            self._budget + dt * self.migrate_users_per_s,
            float(self.max_users_per_tick),
        )
        n = min(int(self._budget), len(self._pending))
        if n == 0:
            return
        self.n_migration_ticks += 1
        journal, remap = self._journal, self._remap
        for u in self._pending[:n]:
            journal.log_migrate_intent(u, self.store.delta(u).to_bytes())
            rec = migrate_user(
                self.store, u, remap, seed=self.seed, verify=self.verify
            )
            journal.log_migrate_commit(u, rec["status"])
            self.n_migrated += 1
        del self._pending[:n]
        self._budget -= n
        if not self._pending:
            self._finish_migration()

    def _finish_migration(self) -> None:
        """Commit the journal, then (and only then) GC superseded
        codebook generations — the crash-safety ordering of
        ``lifecycle.recluster``."""
        self._journal.log_committed()
        self.store.drop_unreferenced_codebooks()
        self.state = "watching"
        self._remap = None
        self._next_poll = None  # re-poll immediately: drift is repaired

    def stats(self) -> dict:
        """Driver state + counters for dashboards and the bench."""
        return {
            "state": self.state,
            "n_polls": self.n_polls,
            "n_reclusters": self.n_reclusters,
            "n_migrated": self.n_migrated,
            "n_migration_ticks": self.n_migration_ticks,
            "n_deferred": self.n_deferred,
            "n_recluster_failures": self.n_recluster_failures,
            "last_error": self.last_error,
            "n_pending_migration": len(self._pending),
            "migrate_users_per_s": self.migrate_users_per_s,
            "mode": self.mode,
            "n_scrub_ticks": self.n_scrub_ticks,
            "n_scrub_failures": self.n_scrub_failures,
            "scrub": (
                self.scrubber.stats() if self.scrubber is not None
                else None
            ),
            "last_report": self.last_report,
            "journal": (
                self._journal.summary() if self._journal is not None
                else None
            ),
        }
