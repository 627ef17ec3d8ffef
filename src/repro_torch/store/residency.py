"""Tiered residency for the multi-tenant store — the port of
``repro.store.residency``.

The durable tier (``store.durable``) keeps deltas on disk behind
``_LazyShard`` placeholders that materialize on first touch.  Without a
budget, residency only ratchets UP — once decoded, a user stays in host
memory forever, so a long-tailed trace eventually materializes the whole
fleet.  This module makes host memory a BUDGET, not a high-water mark:

* ``ResidencyManager`` byte-accounts every resident decoded delta and,
  when the configured budget is exceeded, DEMOTES the coldest unpinned
  users back to ``_LazyShard`` placeholders (GreedyDual priority, the
  same aging policy as ``TileCache`` / ``TileArena`` — ``store.policy``),
  dropping the user's hydrated object, decoded tiles, and arena run so
  every cached artifact derived from the resident delta goes with it.
  The user's serving version is NOT bumped: the durable tier holds the
  byte-identical shard, so a later touch reloads bit-exactly and every
  memoized plan stays valid.
* A DIRTY user (re-registered or relabeled since the last durable sync)
  is never demoted over its disk copy silently: with ``writeback=True``
  (default) the manager stages + commits the resident bytes first (the
  commit is the usual atomic epoch bump), otherwise the user is skipped
  and the budget may be exceeded (counted, never hidden).
* ``Prefetcher`` warms demoted users AHEAD of the serve path: the
  scheduler's plan stage names every user batch ``k+1`` needs while
  batch ``k`` executes, so the prefetcher reads + parses their shards
  (background thread under a wall clock; inline under ``VirtualClock``
  for determinism) and STAGES the parsed deltas with the manager.
  Staged deltas are absorbed into the store on the serving thread
  (``ForestServer.execute`` / first touch) — the prefetch thread never
  mutates the tile cache or the device arena, so no serving structure
  is ever raced.

Clocks are INJECTED (``clock=`` is any ``() -> float``): this module
never reads wall time itself, keeping the store determinism-clean
(repro-lint DET001) and letting a virtual clock drive the cold-load
latency accounting in tests.

Port note: copied from the reference with its relative imports.  The
device tier is the store's ``TileArena`` (torch tensors on the store's
device): a demotion drops the user's run through ``arena.invalidate``
on the thread that demotes.  The ``Prefetcher``'s worker does host work
only (shard read, RFD1 parse, hydrate, ``serving.pack.iter_heap_tiles``,
all numpy) and never touches a device; the staged result reaches the
store, and the card, on the serving thread (``absorb_staged`` / ``pin``,
which ``ForestServer.execute`` calls).

The one departure from the reference (ROADMAP Queue 3 S2): a demotion
made on a thread other than the serving thread (the scheduler's pump
thread, whose pre-plan and drift poll cold-load users and so enforce
the budget) swaps the registry entry and the accounting at once, but
leaves the derived artifacts (hydrated forest, decoded tiles, arena
run: value-identical to the disk bytes) for the serving thread to drop
at its next serve-path call (``touch`` / ``absorb_staged``).  The
reference drops them on the demoting thread, where they race the
worker's arena admission and gather.  The serving thread is the one
that made the last serve-path call; where no call was made yet, the
first one drops what demotions left.  On the serving thread itself a
demotion drops at once, as the reference's does.
"""
from __future__ import annotations

import contextlib
import queue as _queue
import threading
import zlib
from collections import deque
from typing import Callable, Iterable, Sequence

import numpy as np

from ..runtime.guards import guarded_by
from .delta import UserDelta, hydrate
from .durable import DurableStore, _LazyDeltaMap, _LazyShard
from .policy import GreedyDualClock

_COLD_WINDOW = 4096  # cold-load latency samples kept for p50/p99


def _percentile(samples, q: float) -> float:
    if not samples:
        return 0.0
    return float(np.percentile(np.asarray(samples, dtype=np.float64), q))


@guarded_by(
    "_lock",
    "_resident_bytes", "_total_bytes", "_prio", "_gd", "_pins", "_dirty",
    "_staged", "_warming", "_prefetched", "_cold_ms", "_warm_ms",
    "demotions", "writebacks", "reloads", "over_budget_events",
    "dirty_skips", "prefetch_requested", "prefetch_staged",
    "prefetch_hits", "prefetch_errors", "_serving", "_drops",
    holds=("_enforce", "_absorb_one", "_demote_one", "_account",
           "_demotable", "_writeback_commit", "_serve_path",
           "_drop_derived"),
)
class ResidencyManager:
    """Byte-accounted residency budget over one ``(ForestStore,
    DurableStore)`` pair.

    The manager owns the host tier of the residency ladder::

        disk (RFD1 shard) <-> demoted (_LazyShard) <-> resident (UserDelta)

    and triggers the derived-artifact drops (tiles, arena run, hydrated
    object) that keep the device tier coherent on demotion.  All
    accounting state is guarded by ``_lock``: the prefetch thread stages
    parsed deltas and the serving thread absorbs/demotes concurrently.

    Attach via ``attach_residency`` — it also converts the store's delta
    map to a ``_LazyDeltaMap`` (re-materialization on touch) and seeds
    the accounting from the current residency state."""

    def __init__(
        self,
        store,
        durable: DurableStore,
        budget_bytes: int,
        clock: Callable[[], float] | None = None,
        writeback: bool = True,
        on_step: Callable[[str], None] | None = None,
    ) -> None:
        if budget_bytes < 1:
            raise ValueError(
                f"budget_bytes must be positive, got {budget_bytes}"
            )
        self.store = store
        self.durable = durable
        self.budget_bytes = int(budget_bytes)
        self.writeback = bool(writeback)
        self.on_step = on_step
        self._clock = clock
        self._lock = threading.Lock()
        self._gd = GreedyDualClock()
        self._resident_bytes: dict[str, int] = {}
        self._total_bytes = 0
        self._prio: dict[str, tuple[float, int]] = {}
        self._pins: dict[str, int] = {}
        self._dirty: set[str] = set()
        self._staged: dict[str, tuple[UserDelta, int]] = {}
        self._warming: set[str] = set()
        self._prefetched: set[str] = set()
        self._cold_ms: deque = deque(maxlen=_COLD_WINDOW)
        self._warm_ms: deque = deque(maxlen=_COLD_WINDOW)
        self.demotions = 0
        self.writebacks = 0
        self.reloads = 0
        self.over_budget_events = 0
        self.dirty_skips = 0
        self.prefetch_requested = 0
        self.prefetch_staged = 0
        self.prefetch_hits = 0
        self.prefetch_errors = 0
        # the serving thread's ident, and the users demoted off it whose
        # derived artifacts it has still to drop
        self._serving: int | None = None
        self._drops: set[str] = set()

    # ---------------- clock (injected; DET001-clean) -----------------------
    def clock_now(self) -> float:
        """Injected-clock read; 0.0 when no clock was provided (latency
        accounting then degrades to counters only)."""
        return 0.0 if self._clock is None else float(self._clock())

    # ---------------- raw registry access ----------------------------------
    def _raw(self, user_id: str):
        """The registry value WITHOUT materializing: ``dict.get`` bypasses
        ``_LazyDeltaMap.__getitem__``, so placeholders stay placeholders."""
        return dict.get(self.store._deltas, user_id)

    def is_resident(self, user_id: str) -> bool:
        """True when the user's decoded delta is in host memory."""
        return not isinstance(self._raw(user_id), _LazyShard)

    # ---------------- serve-path notifications -----------------------------
    def touch(self, user_id: str) -> None:
        """Serve-path access: refresh the user's eviction priority, absorb
        a staged prefetch for this user, and account a prefetch hit when
        the prefetcher made this touch warm."""
        with self._lock:
            self._serve_path()
            staged = self._staged.pop(user_id, None)
            if staged is not None and isinstance(self._raw(user_id),
                                                 _LazyShard):
                self._absorb_one(user_id, *staged)
            if user_id in self._prefetched:
                self._prefetched.discard(user_id)
                self.prefetch_hits += 1
            nbytes = self._resident_bytes.get(user_id)
            if nbytes is not None:
                self._prio[user_id] = self._gd.touch(float(nbytes))

    def notify_loaded(self, user_id: str, nbytes: int,
                      elapsed_s: float) -> None:
        """A ``_LazyShard`` materialized on the serve path (cold load):
        account the resident bytes, record the latency, and enforce the
        budget.  The loaded bytes ARE the disk bytes, so the user is
        clean by construction."""
        with self._lock:
            self._account(user_id, int(nbytes))
            self._dirty.discard(user_id)
            self.reloads += 1
            self._cold_ms.append(elapsed_s * 1000.0)
            self._enforce()

    def notify_registered(self, user_id: str, delta: UserDelta) -> None:
        """``add_delta`` / ``replace_delta_relabeled`` installed new
        resident content: account it and mark the user DIRTY — its disk
        shard (if any) no longer byte-matches, so demotion must write
        back first."""
        nbytes = len(delta.to_bytes())
        with self._lock:
            self._account(user_id, nbytes)
            self._dirty.add(user_id)
            self._staged.pop(user_id, None)
            self._prefetched.discard(user_id)
            self._enforce()

    def _account(self, user_id: str, nbytes: int) -> None:
        # caller holds self._lock (guarded_by holds=)
        self._total_bytes += nbytes - self._resident_bytes.get(user_id, 0)
        self._resident_bytes[user_id] = nbytes
        self._prio[user_id] = self._gd.touch(float(nbytes))

    def seed_resident(self, user_id: str, nbytes: int,
                      dirty: bool) -> None:
        """Account one already-resident user (``attach_residency``)."""
        with self._lock:
            self._account(user_id, nbytes)
            if dirty:
                self._dirty.add(user_id)

    def forget(self, user_id: str) -> None:
        """Drop a removed user from the accounting entirely."""
        with self._lock:
            self._total_bytes -= self._resident_bytes.pop(user_id, 0)
            self._prio.pop(user_id, None)
            self._dirty.discard(user_id)
            self._staged.pop(user_id, None)
            self._prefetched.discard(user_id)

    # ---------------- pinning ----------------------------------------------
    @contextlib.contextmanager
    def pin(self, user_ids: Sequence[str]):
        """Hold the named users resident for the duration (the serve path
        pins a plan's users across pack build + execute: demoting a user
        between ``arena_ensure`` and ``gather`` would drop the run the
        gather is about to index).  Budget enforcement runs at unpin, so
        a batch whose working set exceeds the budget completes and the
        overflow is reclaimed immediately after."""
        users = list(dict.fromkeys(user_ids))
        with self._lock:
            for u in users:
                self._pins[u] = self._pins.get(u, 0) + 1
        try:
            yield
        finally:
            with self._lock:
                for u in users:
                    n = self._pins.get(u, 0) - 1
                    if n <= 0:
                        self._pins.pop(u, None)
                    else:
                        self._pins[u] = n
                self._enforce()

    # ---------------- demotion ---------------------------------------------
    def accounted_bytes(self) -> int:
        """Total bytes of resident decoded deltas the manager accounts."""
        with self._lock:
            return self._total_bytes

    def demote(self, user_id: str) -> bool:
        """Explicitly demote one user to its ``_LazyShard`` placeholder.
        Returns False (and changes nothing) when the user is pinned,
        already demoted, or dirty with writeback disabled."""
        with self._lock:
            if user_id in self._pins:
                return False
            state = self._demotable(user_id)
            if state is None:
                return False
            if state == "dirty":
                if not self.writeback:
                    self.dirty_skips += 1
                    return False
                self._writeback_commit([user_id])
            return self._demote_one(user_id)

    def _demotable(self, user_id: str) -> str | None:
        # caller holds self._lock (guarded_by holds=).  "clean" when the
        # live shard byte-matches the resident delta, "dirty" when a
        # writeback is needed first, None when not demotable at all.
        raw = self._raw(user_id)
        if raw is None or isinstance(raw, _LazyShard):
            return None
        if user_id in self._dirty:
            return "dirty"
        if self.durable.shard_for_user(user_id) is None:
            return "dirty"  # never synced: treat as writeback-needed
        return "clean"

    def _demote_one(self, user_id: str) -> bool:
        # caller holds self._lock (guarded_by holds=)
        entry = self.durable.shard_for_user(user_id)
        if entry is None:
            return False
        store = self.store
        placeholder = _LazyShard(self.durable, store._deltas, user_id,
                                 entry.shard_id, entry.generation)
        dict.__setitem__(store._deltas, user_id, placeholder)
        if self._serving == threading.get_ident():
            self._drop_derived(user_id)
        else:
            self._drops.add(user_id)
        prio = self._prio.pop(user_id, None)
        if prio is not None:
            self._gd.evicted(prio[0])
        self._total_bytes -= self._resident_bytes.pop(user_id, 0)
        self._dirty.discard(user_id)
        self.demotions += 1
        return True

    def _drop_derived(self, user_id: str) -> None:
        # caller holds self._lock, on the serving thread (guarded_by holds=)
        store = self.store
        store._hydrated.pop(user_id, None)
        store._tile_counts = {
            k: v for k, v in store._tile_counts.items() if k[0] != user_id
        }
        # decoded tiles go, but the user's hit-rate history survives — a
        # demotion is not a content change (cf. the user_version rule)
        store.cache.invalidate_user(user_id, reset_stats=False)
        if store.arena is not None:
            store.arena.invalidate(user_id)

    def _serve_path(self) -> None:
        # caller holds self._lock: this thread is now the serving thread;
        # drop what demotions on other threads left for it
        self._serving = threading.get_ident()
        for u in sorted(self._drops):
            self._drop_derived(u)
        self._drops.clear()

    def _writeback_commit(self, user_ids) -> None:
        # caller holds self._lock; stages every named user's resident
        # bytes and lands them in ONE atomic epoch bump.
        for u in user_ids:
            self.durable.put_delta(u, self.store._deltas[u])
        self.durable.commit(on_step=self.on_step)
        for u in user_ids:
            self._dirty.discard(u)
            self.writebacks += 1

    def enforce(self) -> None:
        """Demote coldest unpinned users until the budget holds."""
        with self._lock:
            self._enforce()

    def _enforce(self) -> None:
        # caller holds self._lock (guarded_by holds=)
        if self._total_bytes <= self.budget_bytes:
            return
        clean, dirty = [], []
        for u in self._resident_bytes:
            if u in self._pins:
                continue
            state = self._demotable(u)
            if state == "clean":
                clean.append(u)
            elif state == "dirty":
                dirty.append(u)
        order = lambda u: self._prio.get(u, (0.0, 0))  # noqa: E731
        for u in sorted(clean, key=order):
            if self._total_bytes <= self.budget_bytes:
                return
            self._demote_one(u)
        if self._total_bytes <= self.budget_bytes:
            return
        if self.writeback and dirty:
            dirty.sort(key=order)
            need, acc = [], self._total_bytes
            for u in dirty:
                if acc <= self.budget_bytes:
                    break
                need.append(u)
                acc -= self._resident_bytes.get(u, 0)
            self._writeback_commit(need)
            for u in need:
                self._demote_one(u)
        elif dirty:
            self.dirty_skips += len(dirty)
        if self._total_bytes > self.budget_bytes:
            # everything left is pinned (or undemotable): the overflow is
            # transient but must never be silent
            self.over_budget_events += 1

    # ---------------- prefetch staging --------------------------------------
    def wants_prefetch(self, user_id: str) -> bool:
        """True when a prefetch would help: demoted, not already staged
        or being warmed."""
        with self._lock:
            return (
                isinstance(self._raw(user_id), _LazyShard)
                and user_id not in self._staged
                and user_id not in self._warming
            )

    def begin_warm(self, user_id: str) -> bool:
        """Claim one user for warming (dedupes concurrent prefetches).
        Returns False when warming would be useless."""
        with self._lock:
            if (
                not isinstance(self._raw(user_id), _LazyShard)
                or user_id in self._staged
                or user_id in self._warming
            ):
                return False
            self._warming.add(user_id)
            self.prefetch_requested += 1
            return True

    def end_warm(self, user_id: str) -> None:
        with self._lock:
            self._warming.discard(user_id)

    def note_prefetch_error(self) -> None:
        """A prefetch read/parse failed — best-effort, counted; the serve
        path will surface the typed fault through quarantine/repair."""
        with self._lock:
            self.prefetch_errors += 1

    def stage(self, user_id: str, delta: UserDelta, nbytes: int,
              elapsed_s: float, comp=None, tiles=None,
              block_trees: int = 32) -> None:
        """Hand a prefetch-parsed delta (plus optionally the hydrated
        forest and pre-decoded heap tiles — pure functions of the shard
        bytes, so the warm thread may compute them) to the manager.  It
        is absorbed into the store ON THE SERVING THREAD
        (``absorb_staged`` / first ``touch``) — the prefetch thread never
        mutates serving structures."""
        with self._lock:
            if not isinstance(self._raw(user_id), _LazyShard):
                return  # materialized (or replaced) while we were reading
            self._staged[user_id] = (
                delta, int(nbytes), comp, tiles, int(block_trees)
            )
            self._warm_ms.append(elapsed_s * 1000.0)
            self.prefetch_staged += 1

    def absorb_staged(self) -> int:
        """Install every staged prefetch into the registry (serving
        thread).  Returns the number absorbed."""
        with self._lock:
            self._serve_path()
            staged = list(self._staged.items())
            self._staged.clear()
            n = 0
            for u, payload in staged:
                if isinstance(self._raw(u), _LazyShard):
                    self._absorb_one(u, *payload)
                    n += 1
            if n:
                self._enforce()
            return n

    def _absorb_one(self, user_id: str, delta: UserDelta, nbytes: int,
                    comp=None, tiles=None, block_trees: int = 32) -> None:
        # caller holds self._lock (guarded_by holds=)
        dict.__setitem__(self.store._deltas, user_id, delta)
        if comp is not None:
            self.store._hydrated[user_id] = comp
        if tiles:
            # seed the tile cache so the serve path skips entropy decode
            # entirely — this is the latency the prefetch exists to hide
            run_key = (user_id, block_trees)
            self.store._tile_counts[run_key] = len(tiles)
            for i, t in enumerate(tiles):
                self.store.cache.put((user_id, block_trees, i), t)
        self._account(user_id, nbytes)
        self._dirty.discard(user_id)
        self._prefetched.add(user_id)

    # ---------------- introspection -----------------------------------------
    def stats(self) -> dict:
        """Residency dashboard feed (surfaced as
        ``ForestServer.stats()["residency"]``)."""
        with self._lock:
            n_users = len(dict.keys(self.store._deltas))
            resident = len(self._resident_bytes)
            return {
                "budget_bytes": self.budget_bytes,
                "resident_bytes": self._total_bytes,
                "resident_users": resident,
                "demoted_users": n_users - resident,
                "dirty_users": len(self._dirty),
                "pinned_users": len(self._pins),
                "staged_prefetches": len(self._staged),
                "demotions": self.demotions,
                "writebacks": self.writebacks,
                "reloads": self.reloads,
                "over_budget_events": self.over_budget_events,
                "dirty_skips": self.dirty_skips,
                "prefetch_requested": self.prefetch_requested,
                "prefetch_staged": self.prefetch_staged,
                "prefetch_hits": self.prefetch_hits,
                "prefetch_errors": self.prefetch_errors,
                "cold_load_ms_p50": _percentile(self._cold_ms, 50),
                "cold_load_ms_p99": _percentile(self._cold_ms, 99),
                "prefetch_load_ms_p50": _percentile(self._warm_ms, 50),
            }


def attach_residency(
    store,
    durable: DurableStore,
    budget_bytes: int,
    clock: Callable[[], float] | None = None,
    writeback: bool = True,
    on_step: Callable[[str], None] | None = None,
) -> ResidencyManager:
    """Put ``store`` under a residency budget backed by ``durable``.

    Converts the store's delta registry to a ``_LazyDeltaMap`` (so a
    demoted user re-materializes on touch), seeds the byte accounting
    from the CURRENT residency state (a user whose resident bytes match
    the live shard is clean; anything else starts dirty), installs the
    manager on both the store and the durable store (the ``_LazyShard``
    load path reports cold loads through ``durable.residency``), and
    enforces the budget once."""
    if not isinstance(store._deltas, _LazyDeltaMap):
        lazy = _LazyDeltaMap(durable)
        for u, v in store._deltas.items():
            dict.__setitem__(lazy, u, v)
        store._deltas = lazy
    else:
        store._deltas._durable = durable
    manager = ResidencyManager(
        store, durable, budget_bytes, clock=clock,
        writeback=writeback, on_step=on_step,
    )
    for u, v in list(dict.items(store._deltas)):
        if isinstance(v, _LazyShard):
            continue
        data = v.to_bytes()
        e = durable.shard_for_user(u)
        clean = (
            e is not None and e.length == len(data)
            and e.crc == (zlib.crc32(data) & 0xFFFFFFFF)
            and e.generation == v.codebook_generation
        )
        manager.seed_resident(u, len(data), dirty=not clean)
    store.residency = manager
    durable.residency = manager
    manager.enforce()
    return manager


@guarded_by("_cv", "_pending")
class Prefetcher:
    """Plan-driven shard warmer over one ``ResidencyManager``.

    ``request`` takes the user ids an upcoming batch needs (the
    scheduler's pre-plan slot calls it with batch ``k+1`` while batch
    ``k`` executes) and warms the demoted ones: read the shard, parse
    the RFD1 frame, and STAGE the delta with the manager — absorption
    into the store happens on the serving thread.  ``background=True``
    runs warms on a daemon thread (the wall-clock deployment);
    ``background=False`` warms inline on the caller's thread (the
    deterministic ``VirtualClock`` mode, mirroring the executor's
    ``overlap=False``).  Quarantined users are never warmed: ``server``
    (optional) supplies the quarantine set at request time.

    Warm failures are best-effort by design: a corrupt shard is counted
    (``prefetch_errors``) and LEFT COLD, so the serve path hits the
    typed ``IntegrityError`` where quarantine + parity auto-repair
    handle it — a prefetch can never paper over a fault."""

    def __init__(self, manager: ResidencyManager, server=None,
                 background: bool = True, decode: bool = True,
                 block_trees: int | None = None) -> None:
        self.manager = manager
        self.server = server
        self.background = bool(background)
        self.decode = bool(decode)
        # match the tile-block size the serving engine will read, so the
        # warmed cache entries are the ones the pack path probes
        # (pipelined/sharded decode at 8, the simple engine at 32)
        if block_trees is None:
            block_trees = 8 if manager.store.arena is not None else 32
        self.block_trees = int(block_trees)
        self._cv = threading.Condition()
        self._pending = 0
        self._work: _queue.SimpleQueue = _queue.SimpleQueue()
        self._worker: threading.Thread | None = None
        if self.background:
            self._worker = threading.Thread(
                target=self._worker_loop, name="residency-prefetch",
                daemon=True,
            )
            self._worker.start()

    def request(self, user_ids: Iterable[str]) -> int:
        """Queue (or inline-run) warms for the demoted users among
        ``user_ids``.  Returns the number of warms issued."""
        server = self.server
        quarantined = (
            set(server.quarantined_users) if server is not None else ()
        )
        issued = 0
        for u in dict.fromkeys(user_ids):
            if u in quarantined:
                continue
            if not self.manager.begin_warm(u):
                continue
            issued += 1
            with self._cv:
                self._pending += 1
            if self.background:
                self._work.put(u)
            else:
                self._warm(u)
        return issued

    def _worker_loop(self) -> None:
        while True:
            u = self._work.get()
            if u is None:
                return
            self._warm(u)

    def _warm(self, user_id: str) -> None:
        m = self.manager
        try:
            entry = m.durable.shard_for_user(user_id)
            if entry is not None:
                t0 = m.clock_now()
                data = m.durable.read_shard(entry.shard_id)
                delta = UserDelta.from_bytes(data)
                comp = tiles = None
                if self.decode:
                    # hydrate + entropy-decode are pure functions of the
                    # shard bytes and the (immutable) codebook generation
                    # it references — safe off-thread, and they are the
                    # bulk of the cold-serve latency
                    from ..serving.pack import iter_heap_tiles

                    comp = hydrate(
                        delta,
                        m.store.codebook_for(delta.codebook_generation),
                    )
                    tiles = list(iter_heap_tiles(comp, self.block_trees))
                m.stage(
                    user_id, delta, len(data), m.clock_now() - t0,
                    comp=comp, tiles=tiles, block_trees=self.block_trees,
                )
        except Exception:  # noqa: BLE001 — best-effort: counted, the
            # serve path surfaces the typed fault through quarantine
            m.note_prefetch_error()
        finally:
            m.end_warm(user_id)
            with self._cv:
                self._pending -= 1
                self._cv.notify_all()

    def drain(self, timeout: float | None = None) -> bool:
        """Block until every issued warm has finished staging."""
        with self._cv:
            return self._cv.wait_for(lambda: self._pending == 0, timeout)

    def close(self) -> None:
        """Drain and stop the background worker (idempotent)."""
        if self._worker is None:
            return
        self.drain()
        self._work.put(None)
        self._worker.join()
        self._worker = None
