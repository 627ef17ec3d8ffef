"""Deterministic fault-injection harness (ISSUE 6 tentpole piece 4).

Everything the fault-tolerance tests and ``benchmarks/chaos_bench.py``
need to break the system ON PURPOSE, reproducibly:

* **Corruption** — seeded bit flips (``flip_bit`` / ``flip_bits``) and
  truncations (``truncate``) of serialized RFS1/RFD1/RFT1/RFM1 frames,
  for exercising the integrity-checked framing (``core.framing``);
* **Crashes** — ``CrashSchedule``, modeled on the training runtime's
  ``PreemptionSchedule``: a step hook the recluster journal calls at
  every named step, raising ``InjectedCrash`` at a chosen step name or
  index.  Run once with an empty schedule to RECORD the step list, then
  replay crashing at each recorded step in turn ("crash at every journal
  step");
* **Transient faults** — ``TransientFaults``, a callable that fails its
  first N invocations with ``TransientError`` (what the serving session's
  bounded retry-with-backoff is tested against, standing in for arena
  admission failures under memory pressure).

Everything here is seed-deterministic: the same seed produces the same
flipped bits, the same truncation points, the same crash steps — so every
chaos test is replayable bit-for-bit.
"""
from __future__ import annotations

import errno
import os
from dataclasses import dataclass, field

import numpy as np


class InjectedCrash(Exception):
    """Raised by ``CrashSchedule`` to simulate a process crash mid-step."""


class TransientError(Exception):
    """A retryable fault (simulated memory pressure, a busy device): the
    serving session's bounded retry-with-backoff handles these; anything
    else propagates."""


# ---------------------------------------------------------------------------
# corruption
# ---------------------------------------------------------------------------

def flip_bit(data: bytes, bit: int) -> bytes:
    """Return a copy of ``data`` with one bit flipped (``bit`` indexes the
    whole payload, LSB-first within each byte)."""
    if not 0 <= bit < 8 * len(data):
        raise ValueError(f"bit {bit} out of range for {len(data)} bytes")
    buf = bytearray(data)
    buf[bit // 8] ^= 1 << (bit % 8)
    return bytes(buf)


def flip_bits(data: bytes, seed: int, n: int = 1) -> tuple[bytes, list[int]]:
    """Flip ``n`` distinct seeded-random bits; returns the corrupted copy
    and the flipped bit positions (for reproduction in failure reports)."""
    rng = np.random.default_rng(seed)
    total = 8 * len(data)
    if total == 0:
        return data, []
    n = min(n, total)
    positions = sorted(
        int(p) for p in rng.choice(total, size=n, replace=False)
    )
    out = data
    for p in positions:
        out = flip_bit(out, p)
    return out, positions


def truncate(data: bytes, keep: int) -> bytes:
    """Return the first ``keep`` bytes of ``data`` (a torn write / partial
    download)."""
    if not 0 <= keep <= len(data):
        raise ValueError(f"keep={keep} out of range for {len(data)} bytes")
    return data[:keep]


def seeded_truncation(data: bytes, seed: int) -> tuple[bytes, int]:
    """Truncate at a seeded-random point strictly inside the payload."""
    rng = np.random.default_rng(seed)
    keep = int(rng.integers(0, max(len(data), 1)))
    return truncate(data, keep), keep


class PoisonedDelta:
    """Stand-in for a user delta whose bytes fail integrity checks at
    decode time: every attribute access beyond the generation stamp
    raises ``core.framing.IntegrityError``, so any decode path
    (``hydrate`` / ``tiles`` / ``reconstruct``) faults exactly where a
    CRC-failing delta loaded lazily from storage would."""

    def __init__(self, generation: int, reason: str) -> None:
        self.codebook_generation = generation
        self._reason = reason

    def __getattr__(self, name: str):
        from ..core.framing import IntegrityError

        raise IntegrityError(self._reason)


def poison_user(
    store, user_id: str, reason: str = "injected delta corruption"
) -> None:
    """Deterministically corrupt one user in a ``ForestStore``: their
    delta is replaced with a ``PoisonedDelta`` and every cached decode
    artifact for them is dropped, so the next decode attempt raises a
    typed ``IntegrityError`` — the fault ``ForestServer.serve_safe``
    quarantines."""
    if user_id not in store._deltas:
        raise KeyError(f"unknown user {user_id!r}")
    gen = store._deltas[user_id].codebook_generation
    store._deltas[user_id] = PoisonedDelta(gen, reason)
    store._hydrated.pop(user_id, None)
    store._tile_counts = {
        k: v for k, v in store._tile_counts.items() if k[0] != user_id
    }
    store.cache.invalidate_user(user_id)
    if store.arena is not None:
        store.arena.invalidate(user_id)
    store.version += 1
    store._user_versions[user_id] = store.version


# ---------------------------------------------------------------------------
# disk faults (ISSUE 8): what the durable shard store is tested against
# ---------------------------------------------------------------------------

@dataclass
class DiskFaults:
    """Seeded disk-fault injector for the durable shard store
    (``store.durable``).

    Two kinds of surface, both deterministic under ``seed``:

    * **File mutators** — corrupt on-disk state directly, the way a dying
      disk or torn write would: ``torn_write`` truncates a file at a byte
      offset, ``bit_rot_file`` flips seeded bits in place, ``missing``
      deletes a file, and ``corrupt_region`` zeroes a byte range (a
      trashed sector inside a slab).  Each returns/records where it
      struck so failures replay bit-for-bit.
    * **I/O hooks** — install ``on_read`` as ``DurableStore.read_fault``
      to bit-rot the shards named in ``rot_shards`` as they are read
      (latent corruption surfacing at access time), and ``on_write`` as
      ``DurableStore.write_fault`` to raise ``OSError(ENOSPC)`` once
      ``enospc_after`` writes have succeeded (a full disk mid-commit).
    """

    seed: int = 0
    rot_shards: tuple = ()
    enospc_after: int | None = None
    reads: int = 0
    writes: int = 0
    rotted: list = field(default_factory=list)

    # -- I/O hooks ----------------------------------------------------------

    def on_read(self, shard_id: int, data: bytes) -> bytes:
        """``DurableStore.read_fault`` hook: flip one seeded bit in the
        shards listed in ``rot_shards`` (every read, so repair-then-reread
        still sees clean bytes only from the healed file, not this hook —
        remove the shard from ``rot_shards`` to model a one-shot rot)."""
        self.reads += 1
        if shard_id in self.rot_shards and data:
            rng = np.random.default_rng(self.seed + shard_id)
            bit = int(rng.integers(0, 8 * len(data)))
            self.rotted.append((shard_id, bit))
            return flip_bit(data, bit)
        return data

    def on_write(self, path: str, nbytes: int) -> None:
        """``DurableStore.write_fault`` hook: allow ``enospc_after``
        writes, then fail every subsequent one with ``ENOSPC``."""
        self.writes += 1
        if self.enospc_after is not None and self.writes > self.enospc_after:
            raise OSError(
                errno.ENOSPC,
                f"injected ENOSPC on write {self.writes} ({nbytes} bytes)",
                path,
            )

    # -- file mutators ------------------------------------------------------

    def torn_write(self, path: str, offset: int | None = None) -> int:
        """Truncate ``path`` at ``offset`` (seeded-random strictly inside
        the file when omitted) — the on-disk shape of a write that died
        partway.  Returns the offset used."""
        size = os.path.getsize(path)
        if offset is None:
            rng = np.random.default_rng(self.seed ^ len(path))
            offset = int(rng.integers(0, size)) if size else 0
        os.truncate(path, offset)
        return offset

    def bit_rot_file(self, path: str, n: int = 1) -> list[int]:
        """Flip ``n`` seeded bits of ``path`` in place (deliberately NOT
        an atomic write — this IS the corruption).  Returns bit positions."""
        with open(path, "rb") as f:
            data = f.read()
        out, positions = flip_bits(data, self.seed ^ (len(path) << 8), n)
        with open(path, "wb") as f:
            f.write(out)
        return positions

    def corrupt_region(self, path: str, offset: int, length: int) -> None:
        """Zero ``length`` bytes of ``path`` at ``offset`` — a trashed
        sector; how the tests corrupt ONE shard inside a multi-shard slab
        without touching its siblings."""
        with open(path, "r+b") as f:
            f.seek(offset)
            f.write(b"\x00" * length)

    def missing(self, path: str) -> None:
        """Delete a file (a lost shard / parity file)."""
        os.remove(path)


# ---------------------------------------------------------------------------
# crash injection
# ---------------------------------------------------------------------------

@dataclass
class CrashSchedule:
    """Deterministic crash injector for journaled operations.

    Pass an instance as the ``on_step`` hook of ``lifecycle.recluster`` /
    ``resume_recluster``; each call records the step name in ``steps`` and
    raises ``InjectedCrash`` when the step's NAME or 0-based INDEX appears
    in ``fail_at`` (each trigger fires once, so a resumed run sails past
    the crash point it already took)."""

    fail_at: tuple = ()
    steps: list = field(default_factory=list)
    _fired: set = field(default_factory=set)

    def __call__(self, name: str) -> None:
        idx = len(self.steps)
        self.steps.append(name)
        for key in (name, idx):
            if key in self.fail_at and key not in self._fired:
                self._fired.add(key)
                raise InjectedCrash(
                    f"injected crash at step {idx} ({name})"
                )


def record_steps(run) -> list[str]:
    """Run ``run(on_step)`` with a no-crash schedule and return the step
    names it took — the crash points a crash-at-every-step sweep replays."""
    sched = CrashSchedule()
    run(sched)
    return list(sched.steps)


# ---------------------------------------------------------------------------
# transient faults
# ---------------------------------------------------------------------------

@dataclass
class TransientFaults:
    """Callable that raises ``TransientError`` on its first ``fail_first``
    invocations, then succeeds forever — install as
    ``TileArena.admission_fault`` to simulate admission failures under
    memory pressure and exercise the serving session's bounded
    retry-with-backoff."""

    fail_first: int = 1
    calls: int = 0

    def __call__(self, *_args) -> None:
        self.calls += 1
        if self.calls <= self.fail_first:
            raise TransientError(
                f"injected transient fault ({self.calls}/{self.fail_first})"
            )


@dataclass
class BatchFaults:
    """Scheduler-level fault injector (ISSUE 7): install as the
    ``fault_hook`` of ``sched.PipelinedExecutor`` / ``sched.Scheduler``
    and it raises on the micro-batches whose ``seq`` appears in
    ``fail_batches`` — exercising the executor's batch-level isolation
    (the poisoned batch resolves ``status="failed"``, the scheduler loop
    keeps serving).  ``transient=True`` raises ``TransientError`` (a
    retryable device fault) instead of ``InjectedCrash``."""

    fail_batches: tuple = ()
    transient: bool = False
    calls: int = 0
    seen: list = field(default_factory=list)

    def __call__(self, batch) -> None:
        self.calls += 1
        self.seen.append(batch.seq)
        if batch.seq in self.fail_batches:
            exc = TransientError if self.transient else InjectedCrash
            raise exc(f"injected batch fault at micro-batch {batch.seq}")
