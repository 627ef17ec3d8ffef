"""``ForestServer`` — the unified serving session facade, ported.

One public API replaces the three divergent entry points PR 1-3 grew
(``predict_compressed`` stays as the pure decode-side reference oracle;
the ``serve_compressed_forest`` / ``serve_store_batch`` shims that
bridged PR 1-3 callers have since been removed):

    server = ForestServer(store)            # fleet session
    plan = server.plan(requests)            # host-only: grouping, sort,
                                            # engine cost model, signature
    preds = server.execute(plan, X)         # pack -> gather -> kernel ->
                                            # finalize
    server.serve(requests)                  # plan + execute convenience
    server.serve_safe(requests)             # fault-isolating serve:
                                            # per-user typed statuses

The session owns the store, its device ``TileArena``, the decoded
``TileCache``, and a ``PlanCache`` that memoizes plans AND arena-gathered
packs across batches by the batch's user-run signature.  Invalidation is
PER USER (ISSUE 5): each memoized entry carries the registry versions —
and, for packs, the arena run-admission tokens — of exactly the users it
covers, so re-registering, migrating, or evicting user A drops only the
entries containing A; a warm session crossing a codebook migration keeps
serving untouched users from cache.  Single-forest serving is a one-user
session (``ForestServer.from_forest(...)``).

Graceful degradation (ISSUE 6): ``serve_safe`` QUARANTINES users whose
deltas fail integrity checks or entropy decode (typed per-user status,
healthy users in the same batch still served), retries transient arena
admission faults with bounded exponential backoff, and — when retries
exhaust — degrades the batch to the arena-free ``simple`` engine instead
of failing it.  ``stats()["health"]`` surfaces the quarantine set,
failure counters, and the store's recluster-journal state.

Port notes: the session runs on one explicit device (``device``, default
``"cuda"``; ``"cpu"`` runs the kernels' plain PyTorch versions), where its
store and arena live.  The sharded engine spreads a batch's trees over the
session's device list (``devices``: by default every visible CUDA device
on a card, else the one device; a list may name one device more than
once).  The reference's ``interpret=`` keyword is dropped.
"""
from __future__ import annotations

import contextlib
import threading
import time
from collections import Counter, deque
from dataclasses import dataclass
from typing import Callable, Sequence

import numpy as np
import torch

from ..device import resolve_device, resolve_devices
from ..store.runtime import ForestStore, TileCache, make_schema_arena
from . import engines
from .cache import PlanCache
from .plan import ENGINE_BLOCKS, ServePlan, build_plan

Request = tuple[str, np.ndarray]


@dataclass
class RequestStatus:
    """Per-request outcome of a fault-isolating ``serve_safe`` batch.

    ``status`` is ``"ok"`` (``prediction`` holds the result, identical to
    what ``serve`` would return) or ``"quarantined"`` (``prediction`` is
    ``None`` and ``detail`` carries the decode/integrity failure that
    sidelined the user).  ``degraded`` is True when the batch fell back
    to the arena-free simple engine after transient-fault retries
    exhausted — the prediction is still exact, only slower."""

    user_id: str
    status: str
    prediction: np.ndarray | None = None
    detail: str = ""
    degraded: bool = False


class SingleForestStore(ForestStore):
    """The ForestStore surface the serving engines need, backed by ONE
    inline ``CompressedForest`` — no fleet codebook, no deltas.  This is
    what makes single-forest serving a one-user session instead of a
    separate code path."""

    def __init__(
        self,
        comp,
        user_id: str = "forest",
        tile_cache_trees: int = 4096,
        arena_capacity_trees: int = 16384,
        device: str | torch.device = "cuda",
    ) -> None:
        # deliberately NOT calling ForestStore.__init__: there is no
        # SharedCodebook — comp.meta carries every schema field the
        # serving layer reads (task, n_classes, n_features, bins)
        self.device = resolve_device(device)
        self.shared = comp.meta
        self._comp = comp
        self._user = user_id
        self._deltas = {}
        self._hydrated = {}
        self._tile_counts = {}
        self.cache = TileCache(tile_cache_trees)
        self.version = 0
        self.lossy = None
        self.residency = None  # no durable tier behind a one-user session
        self.arena = make_schema_arena(
            comp.meta.n_features, comp.meta.n_bins_per_feature,
            arena_capacity_trees, device=self.device,
        )
        self._serving = None
        self._arena_drops = set()
        self._drop_lock = threading.Lock()

    # ---------------- one-user registry ------------------------------------
    @property
    def user_ids(self) -> list[str]:
        return [self._user]

    def __contains__(self, user_id: str) -> bool:
        return user_id == self._user

    def _check(self, user_id: str) -> None:
        if user_id != self._user:
            raise KeyError(
                f"single-forest session serves {self._user!r}, "
                f"not {user_id!r}"
            )

    def n_trees(self, user_id: str) -> int:
        """Tree count of the session's one forest."""
        self._check(user_id)
        return self._comp.n_trees

    def max_depth(self, user_id: str) -> int:
        """Max tree depth of the session's one forest."""
        self._check(user_id)
        return self._comp.max_depth

    def hydrate(self, user_id: str):
        self._check(user_id)
        return self._comp

    def predict(self, user_id: str, x_binned: np.ndarray) -> np.ndarray:
        from ..core.compressed_predict import predict_compressed

        self._check(user_id)
        return predict_compressed(self._comp, x_binned, device=self.device)

    def user_version(self, user_id: str) -> int:
        """Per-user validity token (the registry never mutates here, so
        this is the constant store version)."""
        self._check(user_id)
        return self.version

    def drift_stats(self, exclude: tuple = ()) -> dict | None:
        """No fleet codebook, hence no codebook lifecycle to monitor."""
        return None

    # the multi-tenant registry/serialization surface does not apply
    def _unsupported(self, *_a, **_k):
        """Registry/serialization operation unavailable on the one-user
        serving adapter — raises ``TypeError``."""
        raise TypeError(
            "SingleForestStore is a read-only one-user serving adapter; "
            "build a ForestStore for registry operations"
        )

    add_user = add_delta = delta = reconstruct = _unsupported
    to_bytes = size_report = _unsupported


class ForestServer:
    """Session-level serving facade: plan/execute IR over one store."""

    def __init__(
        self,
        store: ForestStore,
        plan_cache_size: int = 64,
        *,
        max_retries: int = 3,
        retry_backoff_s: float = 0.01,
        repairer: "Callable[[str], bool] | None" = None,
        device: str | torch.device = "cuda",
        devices=None,
    ) -> None:
        self.device = resolve_device(device)
        if store.device != self.device:
            raise ValueError(
                f"store lives on {store.device}, session asked for "
                f"{self.device}; build the store on the session's device"
            )
        # the devices the sharded engine spreads a batch's trees over
        self.devices = resolve_devices(self.device, devices)
        self.store = store
        self.plan_cache = PlanCache(plan_cache_size)
        self.engine_counts: Counter[str] = Counter()
        # per-engine execute wall-times (bounded window per engine),
        # surfaced as stats()["engine_timings"] for SLO dashboards
        self._engine_times: dict[str, deque[float]] = {}
        self.timing_window = 1024
        # graceful degradation (ISSUE 6): quarantine registry + retry
        # policy + health counters, surfaced via stats()["health"]
        self.max_retries = max_retries
        self.retry_backoff_s = retry_backoff_s
        # user -> {"reason", "user_version": version at quarantine time}
        self._quarantined: dict[str, dict] = {}
        self.integrity_failures = 0
        self.transient_retries = 0
        self.degraded_batches = 0
        # auto-repair (ISSUE 8): optional hook called for a user whose
        # delta fails integrity — returns True after repairing + re-
        # registering the delta (``store.durable.attach_auto_repair``
        # wires it to parity reconstruction).  A failed repair is
        # remembered per quarantine entry, so an unrepairable user costs
        # one attempt, not one per batch.
        self.repairer = repairer
        self.repair_attempts = 0
        self.repairs = 0
        self.last_repair_error: str | None = None

    @classmethod
    def from_forest(
        cls,
        forest,
        user_id: str = "forest",
        tile_cache_trees: int = 4096,
        arena_capacity_trees: int = 16384,
        device: str | torch.device = "cuda",
        **kwargs,
    ) -> "ForestServer":
        """One-user session over a single forest on ``device``: accepts a
        plain ``Forest`` (compressed on the way in) or an
        already-compressed ``CompressedForest`` — serving always runs from
        the compressed format (paper §5)."""
        from ..core.forest_codec import compress_forest
        from ..core.tree import Forest

        device = resolve_device(device)
        comp = compress_forest(forest, device=device) \
            if isinstance(forest, Forest) else forest
        store = SingleForestStore(
            comp, user_id,
            tile_cache_trees=tile_cache_trees,
            arena_capacity_trees=arena_capacity_trees,
            device=device,
        )
        return cls(store, device=device, **kwargs)

    # ---------------- plan ------------------------------------------------
    def plan(
        self,
        requests: Sequence[Request],
        engine: str | None = None,
        block_trees: int | None = None,
        block_obs: int | None = None,
    ) -> ServePlan:
        """Compile a request batch into a ``ServePlan``.  Each request is
        ``(user_id, rows)`` where ``rows`` is the (n, d) row block or just
        its row COUNT — plans depend only on the batch signature, so they
        can be built (and cached) without the data.  Memoized across
        batches; invalidated when the store registry changes."""
        request_users = tuple(u for u, _ in requests)
        row_counts = tuple(
            int(x) if isinstance(x, (int, np.integer)) else len(x)
            for _, x in requests
        )
        key = (
            tuple(zip(request_users, row_counts)),
            engine, block_trees, block_obs,
        )
        # validity token: the PER-USER registry versions of this batch's
        # users — re-registering or migrating user A invalidates only
        # plans containing A (partial invalidation)
        token = self._plan_token(request_users)
        plan = self.plan_cache.get_plan(key, token)
        if plan is None:
            plan = build_plan(
                self.store, request_users, row_counts,
                engine=engine, block_trees=block_trees, block_obs=block_obs,
                n_devices=len(self.devices),
            )
            self.plan_cache.put_plan(key, token, plan)
        return plan

    def _plan_token(self, users) -> tuple:
        """Plan validity token: each distinct user's registry version."""
        return tuple(
            self.store.user_version(u) for u in dict.fromkeys(users)
        )

    def _pack_token(self, users) -> tuple:
        """Pack validity token: each user's (registry version, arena
        run-admission token) pair — stale as soon as any covered user is
        re-registered, migrated with new bytes, evicted from the arena,
        or re-admitted."""
        arena = self.store.arena
        return tuple(
            (self.store.user_version(u), arena.run_token(u)) for u in users
        )

    # ---------------- execute ---------------------------------------------
    def execute(
        self,
        plan: ServePlan,
        X: Sequence[np.ndarray],
    ) -> list[np.ndarray]:
        """Run pack -> gather -> kernel -> finalize for one row batch under
        a plan.  ``X`` holds one (n_i, d) int32 row block per request, in
        plan order.  Returns one prediction array per request (majority
        vote / ensemble mean), matching per-user ``predict_compressed``
        (vote counts are integer-exact; the regression mean accumulates in
        float32 on device)."""
        if len(X) != len(plan.row_counts):
            raise ValueError(
                f"plan covers {len(plan.row_counts)} requests, "
                f"got {len(X)} row blocks"
            )
        for i, (x, n) in enumerate(zip(X, plan.row_counts)):
            if len(x) != n:
                raise ValueError(
                    f"request {i}: plan expects {n} rows, got {len(x)}"
                )
        if self._plan_token(plan.users) != plan.user_tokens:
            raise ValueError(
                "stale plan: one of the plan's users was re-registered "
                "or migrated since it was built — call plan() again"
            )
        if not plan.request_users:
            return []
        if plan.n_rows == 0:
            return [np.zeros(len(x), np.float64) for x in X]
        from .pack import concat_rows

        xb = concat_rows(X)
        name = plan.engine.name
        # this thread serves: apply the arena drops that re-registrations
        # on other threads deferred to it, before any arena read
        self.store.serve_path()
        self.engine_counts[name] += 1
        residency = getattr(self.store, "residency", None)
        if residency is not None:
            # absorb prefetch-staged deltas on THIS (serving) thread —
            # the prefetcher never mutates serving structures — then
            # hold the batch's users resident across pack + kernel: a
            # budget demotion between arena_ensure and gather would
            # drop a run the gather is about to index
            residency.absorb_staged()
            cm = residency.pin(plan.users)
        else:
            cm = contextlib.nullcontext()
        t0 = time.perf_counter()
        with cm:
            if name == "simple":
                total = engines.run_simple(self.store, plan, xb)
            else:
                pack = self._gathered_pack(plan)
                run = (
                    engines.run_pipelined if name == "pipelined"
                    else engines.run_sharded
                )
                total = run(self.store, plan, pack, xb)
            out = self._finalize(plan, total)
        self._record_timing(name, time.perf_counter() - t0)
        return out

    def _record_timing(self, engine: str, elapsed_s: float) -> None:
        times = self._engine_times.get(engine)
        if times is None:
            times = self._engine_times[engine] = deque(
                maxlen=self.timing_window
            )
        times.append(elapsed_s)

    def engine_timings(self) -> dict:
        """Per-engine execute wall-time summary over the last
        ``timing_window`` executions: count (lifetime), mean/p50/p99/max
        in milliseconds over the window."""
        out: dict[str, dict] = {}
        for name, times in self._engine_times.items():
            arr = np.array(times)
            out[name] = {
                "count": int(self.engine_counts[name]),
                "window": len(arr),
                "mean_ms": round(float(arr.mean()) * 1e3, 4),
                "p50_ms": round(float(np.percentile(arr, 50)) * 1e3, 4),
                "p99_ms": round(float(np.percentile(arr, 99)) * 1e3, 4),
                "max_ms": round(float(arr.max()) * 1e3, 4),
            }
        return out

    def _gathered_pack(self, plan: ServePlan):
        """Cross-batch gather memoization: reuse the arena-gathered pack
        for this plan signature unless one of ITS users changed underneath
        it (re-registration, migration, arena eviction/re-admission).
        Unrelated admissions and evictions leave the pack alone — the
        per-run partial invalidation a codebook migration relies on.  The
        eager sweep still drops every pack holding an evicted user, so
        gathered device copies never outlive the arena's capacity
        accounting."""
        arena = self.store.arena
        self.plan_cache.sweep_packs(self._pack_token)
        pack = self.plan_cache.get_pack(
            plan.signature, self._pack_token(plan.users)
        )
        if pack is not None:
            # keep the eviction policy honest: a served-from-cache batch
            # must still count as an access for its users' runs
            arena.touch_users(plan.users)
            return pack
        if plan.engine.name == "pipelined":
            pack = engines.build_pipelined_pack(self.store, plan)
        else:
            pack = engines.build_sharded_pack(self.store, plan, self.devices)
        # token read AFTER building: cold admissions inside the gather
        # assign run tokens, and the entry must be valid for the arena
        # as-left
        self.plan_cache.put_pack(
            plan.signature, plan.users, self._pack_token(plan.users), pack
        )
        return pack

    def _finalize(self, plan: ServePlan, total: np.ndarray):
        task = self.store.shared.task
        out: list[np.ndarray] = []
        for user_id, sl in zip(plan.request_users, plan.row_slices):
            if task == "classification":
                out.append(total[sl].argmax(-1).astype(np.float64))
            else:
                out.append(
                    total[sl].astype(np.float64)
                    / max(self.store.n_trees(user_id), 1)
                )
        return out

    # ---------------- conveniences ----------------------------------------
    def serve(
        self,
        requests: Sequence[Request],
        engine: str | None = None,
        block_trees: int | None = None,
        block_obs: int | None = None,
    ) -> list[np.ndarray]:
        """plan + execute in one call.  Raises on any per-user fault —
        ``serve_safe`` is the fault-isolating variant."""
        if not requests:
            return []
        plan = self.plan(
            requests, engine=engine,
            block_trees=block_trees, block_obs=block_obs,
        )
        return self.execute(plan, [x for _, x in requests])

    # ---------------- graceful degradation (ISSUE 6) ----------------------
    @property
    def quarantined_users(self) -> list[str]:
        """Users currently sidelined by ``serve_safe`` (sorted)."""
        return sorted(self._quarantined)

    def release_quarantine(self, user_id: str) -> bool:
        """Manually lift a user's quarantine (e.g. after repairing their
        delta out of band).  Returns True if the user was quarantined.
        ``serve_safe`` re-probes them on the next batch."""
        return self._quarantined.pop(user_id, None) is not None

    def _quarantine(self, user_id: str, exc: Exception) -> None:
        from ..core.framing import FramingError

        self.integrity_failures += 1
        self._quarantined[user_id] = {
            "reason": f"{type(exc).__name__}: {exc}",
            "kind": (
                "integrity" if isinstance(exc, FramingError) else "decode"
            ),
            "user_version": self.store.user_version(user_id),
        }

    def _refresh_quarantine(self) -> None:
        """Release quarantined users whose delta changed since quarantine
        — a re-registered or migrated delta may be healthy again, and the
        next ``serve_safe`` batch re-probes it."""
        for u in list(self._quarantined):
            if u not in self.store:
                del self._quarantined[u]
            elif (
                self.store.user_version(u)
                != self._quarantined[u]["user_version"]
            ):
                del self._quarantined[u]

    def attach_repairer(self, repairer: Callable[[str], bool]) -> None:
        """Install the auto-repair hook (see ``__init__``) and forget
        past repair failures — newly repairable faults get a fresh
        attempt."""
        self.repairer = repairer
        for info in self._quarantined.values():
            info.pop("repair_failed", None)

    def _try_repair(self, user_id: str) -> bool:
        """Attempt auto-repair of one user's delta.  True = the repairer
        repaired AND re-registered the delta (caller re-probes before
        serving — release is verified, never assumed).  A raise or False
        from the repairer marks the user's quarantine entry
        ``repair_failed`` so the attempt is not repeated every batch."""
        if self.repairer is None:
            return False
        info = self._quarantined.get(user_id)
        if info is not None and info.get("repair_failed"):
            return False
        self.repair_attempts += 1
        try:
            ok = bool(self.repairer(user_id))
        except Exception as exc:  # noqa: BLE001 — typed UnrepairableError
            # and any unexpected repairer fault both mean "not repaired"
            self.last_repair_error = f"{type(exc).__name__}: {exc}"
            ok = False
        if ok:
            self.repairs += 1
            self._quarantined.pop(user_id, None)
        elif info is not None:
            info["repair_failed"] = True
        return ok

    def _probe_block_trees(self, engine: str | None) -> int:
        """Tree-block size the health probe decodes with — matched to the
        engine the batch will run under, so the probe's decoded tiles land
        in the same ``TileCache`` entries the engine reads (the probe is
        then warm-up, not extra work)."""
        name = engine or (
            "simple" if self.store.arena is None else "pipelined"
        )
        return ENGINE_BLOCKS.get(name, (8, 128))[0]

    def _probe_user(self, user_id: str, block_trees: int) -> Exception | None:
        """Decode one user's tiles end to end (entropy decode included);
        returns the exception on failure.  ``KeyError`` (unknown user) is
        a caller bug, not a data fault, and propagates."""
        try:
            self.store.tiles(user_id, block_trees)
            return None
        except KeyError:
            raise
        except Exception as e:  # noqa: BLE001 — any decode fault
            # quarantines (FramingError, EOF in entropy decode, shape
            # mismatches from logically-corrupt streams, ...)
            return e

    def _serve_with_retry(
        self, requests: Sequence[Request], **kwargs
    ) -> tuple[list[np.ndarray], bool]:
        """``serve`` with bounded exponential backoff on transient arena
        admission faults; when retries exhaust, degrade the batch to the
        arena-free ``simple`` engine (exact result, no device residency)
        rather than failing it.  Returns ``(predictions, degraded)``."""
        from ..runtime.chaos import TransientError

        for attempt in range(self.max_retries + 1):
            try:
                return self.serve(requests, **kwargs), False
            except TransientError:
                self.transient_retries += 1
                if attempt < self.max_retries:
                    time.sleep(self.retry_backoff_s * (2 ** attempt))
        self.degraded_batches += 1
        kwargs = dict(kwargs)
        kwargs["engine"] = "simple"
        return self.serve(requests, **kwargs), True

    def serve_safe(
        self,
        requests: Sequence[Request],
        engine: str | None = None,
        block_trees: int | None = None,
        block_obs: int | None = None,
    ) -> list[RequestStatus]:
        """Fault-isolating ``serve``: one typed ``RequestStatus`` per
        request, in request order.

        Users whose deltas fail integrity checks or entropy decode are
        QUARANTINED — their requests come back ``status="quarantined"``
        with the failure in ``detail``, while every healthy user in the
        batch is served normally (one bad delta must not fail the
        batch).  Quarantine is sticky across batches until the user's
        delta changes (re-registration or migration bumps their registry
        version, triggering a re-probe) or ``release_quarantine``.
        Transient arena admission faults are retried with exponential
        backoff; if they persist, the batch degrades to the arena-free
        simple engine (exact predictions, no device residency) instead
        of failing."""
        if not requests:
            return []
        self._refresh_quarantine()
        probe_bt = block_trees or self._probe_block_trees(engine)
        for u in dict.fromkeys(u for u, _ in requests):
            if u in self._quarantined:
                # quarantine -> repair -> verify -> release (ISSUE 8):
                # a successful repair re-registers the delta; the probe
                # below then re-verifies the decode end to end before
                # the user is served again
                if not self._try_repair(u):
                    continue
            exc = self._probe_user(u, probe_bt)
            if exc is not None and self._try_repair(u):
                exc = self._probe_user(u, probe_bt)
            if exc is not None:
                was_attempted = self.repairer is not None
                self._quarantine(u, exc)
                if was_attempted:
                    # repair already failed (or did not survive the
                    # re-probe) — don't retry it every batch
                    self._quarantined[u]["repair_failed"] = True
        healthy = [
            (u, x) for u, x in requests if u not in self._quarantined
        ]
        preds: list[np.ndarray] = []
        degraded = False
        if healthy:
            preds, degraded = self._serve_with_retry(
                healthy, engine=engine, block_trees=block_trees,
                block_obs=block_obs,
            )
        it = iter(preds)
        out: list[RequestStatus] = []
        for u, _ in requests:
            if u in self._quarantined:
                out.append(RequestStatus(
                    user_id=u, status="quarantined",
                    detail=self._quarantined[u]["reason"],
                ))
            else:
                out.append(RequestStatus(
                    user_id=u, status="ok", prediction=next(it),
                    degraded=degraded,
                ))
        return out

    def predict(
        self, x_binned: np.ndarray, user_id: str | None = None, **kwargs
    ) -> np.ndarray:
        """Single-user convenience: one request, one prediction array.
        ``user_id`` defaults to the sole user of a one-user session."""
        if user_id is None:
            users = self.store.user_ids
            if len(users) != 1:
                raise ValueError(
                    f"store has {len(users)} users; pass user_id"
                )
            user_id = users[0]
        x = np.ascontiguousarray(x_binned, np.int32)
        return self.serve([(user_id, x)], **kwargs)[0]

    def stats(self) -> dict:
        """One dict for admission-control dashboards: arena occupancy,
        tile-cache per-user hit rates, plan-cache hit/miss counts, engine
        usage, the store's codebook-lifecycle drift summary (generation +
        fallback-cluster fraction — ``None`` for single-forest sessions;
        quarantined users are EXCLUDED from drift accounting, not counted
        as fallback users), the store's lossy report when quantization is
        on, the ``residency`` section when a residency budget is
        attached (``store.residency.attach_residency`` — ``None``
        otherwise), and the ``health`` section: quarantine set,
        integrity/retry/degradation counters, and the recluster journal
        state when a journaled lifecycle operation has run."""
        arena = self.store.arena
        journal = getattr(self.store, "journal", None)
        residency = getattr(self.store, "residency", None)
        return {
            "engine_counts": dict(self.engine_counts),
            "engine_timings": self.engine_timings(),
            "plan_cache": self.plan_cache.stats(),
            "tile_cache": self.store.cache.stats(),
            "arena": arena.stats() if arena is not None else None,
            "store": self.store.drift_stats(
                exclude=tuple(sorted(self._quarantined))
            ),
            "lossy": getattr(self.store, "lossy", None),
            "residency": (
                residency.stats() if residency is not None else None
            ),
            "health": {
                "n_quarantined": len(self._quarantined),
                "quarantined": {
                    u: {
                        "reason": info["reason"], "kind": info["kind"],
                    }
                    for u, info in sorted(self._quarantined.items())
                },
                "integrity_failures": self.integrity_failures,
                "transient_retries": self.transient_retries,
                "degraded_batches": self.degraded_batches,
                "repair_attempts": self.repair_attempts,
                "repairs": self.repairs,
                "last_repair_error": self.last_repair_error,
                "max_retries": self.max_retries,
                "retry_backoff_s": self.retry_backoff_s,
                "journal": (
                    journal.summary() if journal is not None else None
                ),
            },
        }
