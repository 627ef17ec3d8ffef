"""Fault-tolerant training runtime — the port of
``repro.runtime.fault_tolerance``, copied (it restores through the
port's ``CheckpointManager``, on the manager's device).

  * CHECKPOINT/RESTART — TrainLoop periodically saves through
    CheckpointManager; on (simulated or real) preemption the loop restarts
    from the latest committed step.  The data pipeline is stateless in
    (seed, step) (data.tokens), so a restart reproduces the exact same
    batch stream: training is bit-deterministic across failures when the
    step itself is (on a card, ``launch.steps.make_train_step`` runs
    under deterministic algorithms).
  * STRAGGLER MITIGATION — per-step deadline derived from a running
    latency percentile; hosts whose data fetch misses the deadline are
    skipped for that step (skips are logged in the step record).
  * ELASTIC SCALING — checkpoints carry logical (unsharded) arrays;
    ``load_checkpoint(shardings=...)`` (``CheckpointManager
    .restore_or_none(shardings)``) re-shards them onto another mesh on
    load, as DTensors.

A restored state is the checkpoint's pytree (``load_checkpoint``), not
the live objects that were saved: ``step_fn`` takes either (the train
driver converts with ``convert.train_state_from_arrays``).  A train
state of shards (tensor-parallel training) runs the same loop on every
rank: its checkpoints are gathered whole and written by rank 0, restored
with ``shardings`` as DTensors, and ``step_fn`` cuts them into shards
again (``convert.train_state_shards_from_arrays``).
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable

from ..checkpoint.manager import CheckpointManager


class Preemption(Exception):
    """Raised mid-training to simulate a node loss / maintenance event."""


@dataclass
class PreemptionSchedule:
    """Deterministic preemption injector for tests: fail at given steps."""

    fail_at: tuple[int, ...] = ()
    _seen: set = field(default_factory=set)

    def check(self, step: int):
        if step in self.fail_at and step not in self._seen:
            self._seen.add(step)
            raise Preemption(f"simulated preemption at step {step}")


class StragglerMonitor:
    """Tracks per-host step latencies; flags hosts exceeding a multiple of
    the running median as stragglers to skip."""

    def __init__(self, window: int = 32, threshold: float = 3.0):
        self.window = window
        self.threshold = threshold
        self._lat: dict[int, deque] = {}
        self.skipped: list[tuple[int, int]] = []  # (step, host)

    def observe(self, host: int, seconds: float):
        self._lat.setdefault(host, deque(maxlen=self.window)).append(seconds)

    def deadline(self) -> float:
        all_lat = sorted(
            x for dq in self._lat.values() for x in dq
        )
        if not all_lat:
            return float("inf")
        median = all_lat[len(all_lat) // 2]
        return self.threshold * median

    def should_skip(self, step: int, host: int, seconds: float) -> bool:
        dl = self.deadline()
        self.observe(host, min(seconds, dl))  # clamp so one spike
        # doesn't poison the window
        if seconds > dl:
            self.skipped.append((step, host))
            return True
        return False


class TrainLoop:
    """Restartable training loop.

    step_fn(state, step) -> (state, metrics); state is any pytree.
    run() survives Preemption by restoring the latest checkpoint and
    continuing — the test asserts the final state matches an uninterrupted
    run bit-for-bit.
    """

    def __init__(
        self,
        step_fn: Callable[[Any, int], tuple[Any, dict]],
        manager: CheckpointManager,
        *,
        save_every: int = 10,
        preemption: PreemptionSchedule | None = None,
        max_restarts: int = 16,
    ):
        self.step_fn = step_fn
        self.manager = manager
        self.save_every = save_every
        self.preemption = preemption
        self.max_restarts = max_restarts
        self.restarts = 0
        self.metrics_log: list[dict] = []

    def run(self, init_state, n_steps: int, shardings=None):
        state, start = self.manager.restore_or_none(shardings)
        if state is None:
            state, start = init_state, 0
            self.manager.save(0, state)
        while True:
            try:
                return self._run_from(state, start, n_steps)
            except Preemption:
                self.restarts += 1
                if self.restarts > self.max_restarts:
                    raise
                state, start = self.manager.restore_or_none(shardings)
                assert state is not None, "preempted before first commit"

    def _run_from(self, state, start: int, n_steps: int):
        for step in range(start, n_steps):
            if self.preemption is not None:
                self.preemption.check(step)
            t0 = time.time()
            state, metrics = self.step_fn(state, step)
            metrics = dict(metrics, step=step, wall_s=time.time() - t0)
            self.metrics_log.append(metrics)
            next_step = step + 1
            if next_step % self.save_every == 0 or next_step == n_steps:
                self.manager.save(next_step, state)
        return state
