"""Multi-tenant forest store runtime — the port of
``repro.store.runtime``.

``ForestStore`` is the registry: one fleet ``SharedCodebook`` plus one
``UserDelta`` per user, all byte-honest.  Decoded artifacts are cached at
two levels:

* hydrated ``CompressedForest`` objects (cheap: codebook resolution only,
  no entropy decode) — a plain dict, they are small;
* decoded HEAP TILES, keyed ``(user, block_trees, tile_index)`` in a
  tree-count-bounded cache (``TileCache``, GreedyDual by decode cost) —
  the expensive artifacts (full Huffman/LZW/arithmetic decode of the
  user's streams), so hot users skip entropy decode on repeat requests.

Serving goes through ``repro_torch.serving.ForestServer``, which gathers
many users' fused tiles from the store's device ``TileArena`` into one
ragged segment-aware kernel launch.  The registry keeps every codebook
generation its deltas still reference.

Port notes: the store lives on an explicit ``device`` (default
``"cuda"``; raises without a card): its arena's buffers are there and
``predict`` runs ``predict_compressed`` there.  Everything else (the
codebooks, deltas, RFT1 frames) is host numpy, copied from the
reference.  The ``residency`` and ``journal`` hooks are the reference's:
``store.residency.attach_residency`` sets the first and
``store.lifecycle.recluster`` / ``resume_recluster`` the second.
"""
from __future__ import annotations

import io
import threading
import zlib
from collections import OrderedDict
from typing import Iterable, Sequence

import numpy as np
import torch

from ..core.forest_codec import CompressedForest
from ..core.framing import (
    IntegrityError,
    check_crc,
    expect_magic,
    read_bytes,
    read_u16,
    read_u32,
    with_crc,
    write_bytes,
    write_u16,
    write_u32,
)
from ..core.tree import Forest
from ..device import resolve_device
from .codebook import SharedCodebook, build_shared_codebook
from .delta import UserDelta, encode_user_delta, hydrate, reconstruct_user
from .policy import GreedyDualClock, decode_cost

_MAGIC = b"RFT1"

Tile = tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]


def make_schema_arena(
    n_features: int,
    n_bins_per_feature: np.ndarray,
    capacity_trees: int = 16384,
    device: str | torch.device = "cuda",
):
    """Device tile arena for a schema on ``device``, or ``None`` when the
    schema's fused code word would overflow 2**24 (serving then falls back
    to ``engine="simple"``)."""
    from ..kernels.tree_predict.tree_predict import fused_threshold_base
    from .arena import TileArena

    try:
        return TileArena(
            n_features,
            fused_threshold_base(int(np.max(n_bins_per_feature)) - 1),
            capacity_trees=capacity_trees,
            device=device,
        )
    except ValueError:
        return None


class TileCache:
    """Decoded heap-tile cache, bounded by total resident TREES (a tile of
    t trees at heap width h costs ~t * h * 13 bytes; trees are the stable
    unit across users of different depths).

    Eviction is DECODE-COST-WEIGHTED (GreedyDual, ISSUE 3 satellite; the
    policy core is shared with the device tile arena — see
    ``store.policy``): a tile's priority is ``clock + trees * 2**depth``
    at insert/access — the reconstruction cost of the entropy decode it
    saves — the minimum-priority tile goes first (ties: least recently
    used), and the clock advances to each evicted priority so long-idle
    expensive tiles age out eventually.  Equal costs reduce exactly to
    LRU.  Per-user hit/miss counters feed admission-control decisions
    (``stats()``)."""

    def __init__(self, capacity_trees: int = 4096) -> None:
        self.capacity_trees = capacity_trees
        self._tiles: OrderedDict[tuple, Tile] = OrderedDict()
        self._prio: dict[tuple, tuple[float, int]] = {}
        self._gd = GreedyDualClock()
        self._resident_trees = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self._per_user: dict[str, list[int]] = {}  # user -> [hits, misses]

    def __len__(self) -> int:
        return len(self._tiles)

    def __contains__(self, key: tuple) -> bool:
        return key in self._tiles

    @staticmethod
    def _cost(tile: Tile) -> float:
        t, h = tile[0].shape
        return decode_cost(t, h)

    def _user_stat(self, key: tuple) -> list[int]:
        return self._per_user.setdefault(str(key[0]), [0, 0])

    def _touch(self, key: tuple, tile: Tile) -> None:
        self._prio[key] = self._gd.touch(self._cost(tile))
        self._tiles.move_to_end(key)

    def get(self, key: tuple) -> Tile | None:
        """The cached tile under ``key`` (refreshing its eviction
        priority), or ``None`` on a miss — both counted per user."""
        tile = self._tiles.get(key)
        if tile is None:
            self.misses += 1
            self._user_stat(key)[1] += 1
            return None
        self._touch(key, tile)
        self.hits += 1
        self._user_stat(key)[0] += 1
        return tile

    def record_decode_misses(self, user_id: str, n: int) -> None:
        """Count ``n`` tile decodes forced by a cold/partial run (the run
        probe in ``ForestStore.tiles`` bypasses per-tile ``get``)."""
        self.misses += n
        self._per_user.setdefault(user_id, [0, 0])[1] += n

    def put(self, key: tuple, tile: Tile) -> None:
        """Insert a decoded tile, evicting minimum-priority tiles until
        the resident-tree capacity holds."""
        if key in self._tiles:
            self._touch(key, tile)
            return
        self._tiles[key] = tile
        self._touch(key, tile)
        self._resident_trees += tile[0].shape[0]
        while (
            self._resident_trees > self.capacity_trees
            and len(self._tiles) > 1
        ):
            victim = min(
                (k for k in self._tiles if k != key),
                key=lambda k: self._prio[k],
            )
            prio, _ = self._prio.pop(victim)
            self._gd.evicted(prio)
            self._resident_trees -= self._tiles.pop(victim)[0].shape[0]
            self.evictions += 1

    def invalidate_user(self, user_id: str,
                        reset_stats: bool = True) -> None:
        """Drop every resident tile of one user.  ``reset_stats=True``
        (the delta-REPLACEMENT path, i.e. a ``user_version`` bump) also
        clears the user's hit/miss history — the new generation's hit
        rate must not be polluted by the old one's.  Residency DEMOTION
        passes ``reset_stats=False``: the content is unchanged, so the
        history stays meaningful across a reload."""
        stale = [k for k in self._tiles if k[0] == user_id]
        for k in stale:
            self._resident_trees -= self._tiles.pop(k)[0].shape[0]
            self._prio.pop(k, None)
        if reset_stats:
            self._per_user.pop(user_id, None)

    def stats(self) -> dict:
        """Cache occupancy and global + per-user hit/miss counters (the
        admission-control dashboard feed)."""
        per_user = {
            u: {
                "hits": h,
                "misses": m,
                "hit_rate": round(h / (h + m), 4) if h + m else 0.0,
            }
            for u, (h, m) in sorted(self._per_user.items())
        }
        return {
            "tiles": len(self._tiles),
            "resident_trees": self._resident_trees,
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
            "per_user": per_user,
        }


class ForestStore:
    """Registry of per-user delta-encoded forests over one shared codebook.

    The shared codebook is a LIVING artifact: the reference's
    ``recluster`` installs a successor generation and migrates user
    deltas onto it one by one.  The store therefore keeps every codebook
    generation still referenced by at least one delta (``install_codebook``
    retains the superseded current; ``drop_unreferenced_codebooks`` garbage
    collects once the last delta migrates), and every decode path resolves
    a delta against the generation it was encoded for — old- and
    new-generation users serve side by side mid-migration.
    """

    def __init__(
        self, shared: SharedCodebook, tile_cache_trees: int = 4096,
        arena_capacity_trees: int = 16384,
        device: str | torch.device = "cuda",
    ) -> None:
        self.device = resolve_device(device)
        self.shared = shared
        # superseded codebook generations still referenced by >=1 delta
        self._retained: dict[int, SharedCodebook] = {}
        self._deltas: dict[str, UserDelta] = {}
        self._hydrated: dict[str, CompressedForest] = {}
        self._tile_counts: dict[tuple, int] = {}
        self.cache = TileCache(tile_cache_trees)
        # registry version: bumped on every registry mutation.  Serving
        # keys its memoized plans/packs on the finer-grained PER-USER
        # versions below, so migrating one user invalidates only that
        # user's cached artifacts (ROADMAP "plan-cache partial
        # invalidation").
        self.version = 0
        self._user_versions: dict[str, int] = {}
        # store-level lossy report (set by build_store(lossy=...))
        self.lossy: dict | None = None
        # crash-safe recluster journal (set by lifecycle.recluster /
        # resume_recluster); surfaced through ForestServer.stats()["health"]
        self.journal = None
        # residency budget manager (set by store.residency.attach_residency);
        # surfaced through ForestServer.stats()["residency"]
        self.residency = None
        # device-resident fused-tile arena for the pipelined serving path;
        # None when the schema's fused code word would overflow 2**24 (the
        # serving driver then falls back to engine="simple")
        self.arena = make_schema_arena(
            shared.n_features, shared.n_bins_per_feature,
            arena_capacity_trees, device=self.device,
        )
        # the serving thread's ident (the one thread that uses the arena,
        # claimed by ``serve_path``) and the users re-registered off it
        # whose arena runs it has still to drop
        self._serving: int | None = None
        self._arena_drops: set[str] = set()
        self._drop_lock = threading.Lock()

    # ---------------- codebook generations --------------------------------
    @property
    def generation(self) -> int:
        """Generation of the CURRENT codebook (new users encode against it)."""
        return self.shared.generation

    @property
    def generations(self) -> list[int]:
        """Every resident codebook generation, ascending (current last)."""
        return sorted(self._retained) + [self.shared.generation]

    def codebook_for(self, generation: int) -> SharedCodebook:
        """The resident codebook of ``generation`` (current or retained)."""
        if generation == self.shared.generation:
            return self.shared
        try:
            return self._retained[generation]
        except KeyError:
            raise KeyError(
                f"codebook generation {generation} is not resident "
                f"(have {self.generations})"
            ) from None

    def install_codebook(self, shared: SharedCodebook) -> None:
        """Install a successor codebook as the current generation.  The
        superseded codebook is RETAINED while any delta still references
        it (dropped automatically once the last one migrates); resident
        caches stay valid — no delta changed."""
        if shared.generation <= self.shared.generation:
            raise ValueError(
                f"successor generation {shared.generation} must exceed "
                f"current generation {self.shared.generation}"
            )
        self._retained[self.shared.generation] = self.shared
        self.shared = shared
        self.version += 1
        self.drop_unreferenced_codebooks()

    def referenced_generations(self) -> set[int]:
        """Codebook generations referenced by at least one registered delta."""
        return {d.codebook_generation for d in self._deltas.values()}

    def drop_unreferenced_codebooks(self) -> list[int]:
        """Garbage-collect retained codebooks no delta references anymore
        (the end state of a migration).  Returns the dropped generations."""
        live = self.referenced_generations()
        dropped = [g for g in self._retained if g not in live]
        for g in dropped:
            del self._retained[g]
        return dropped

    # ---------------- registry --------------------------------------------
    @property
    def user_ids(self) -> list[str]:
        return list(self._deltas)

    def __contains__(self, user_id: str) -> bool:
        return user_id in self._deltas

    def user_version(self, user_id: str) -> int:
        """Per-user registration version — the validity token serving keys
        its memoized plans and gathered packs on.  Bumped whenever the
        user's delta is replaced by content that decodes differently;
        relabel-only migrations (bit-identical artifact) keep it, so a
        warm session crossing a migration invalidates only re-encoded
        users' cached packs."""
        return self._user_versions.get(user_id, 0)

    def add_user(self, user_id: str, forest: Forest, seed: int = 0) -> UserDelta:
        """Delta-encode ``forest`` against the CURRENT shared codebook and
        register it.  Works for fleet members and late-onboarded users alike
        (the latter may carry user-local clusters)."""
        delta = encode_user_delta(forest, self.shared, seed=seed)
        self.add_delta(user_id, delta)
        return delta

    def add_delta(self, user_id: str, delta: UserDelta) -> None:
        """Register a delta (new user or re-registration), invalidating
        every cached artifact derived from the user's previous delta."""
        self.codebook_for(delta.codebook_generation)  # must be resident
        self._deltas[user_id] = delta
        self.version += 1
        self._user_versions[user_id] = self.version
        self._hydrated.pop(user_id, None)
        self._tile_counts = {
            k: v for k, v in self._tile_counts.items() if k[0] != user_id
        }
        self.cache.invalidate_user(user_id)
        if self.arena is not None:
            self._drop_run(user_id)
        if self.residency is not None:
            self.residency.notify_registered(user_id, delta)

    def _drop_run(self, user_id: str) -> None:
        """Drop the user's arena run now on the serving thread (or before
        any thread has served), else leave it to the serving thread's next
        ``serve_path``: a registration on another thread (a driver
        migration on the scheduler's pump thread) must not pull a run out
        from under a gather in flight."""
        with self._drop_lock:
            if self._serving not in (None, threading.get_ident()):
                self._arena_drops.add(user_id)
                return
        self.arena.invalidate(user_id)

    def serve_path(self) -> None:
        """Claim the calling thread as the serving thread, the one that
        uses the device arena, and drop the arena runs of users that
        were re-registered on other threads since its last batch.
        ``ForestServer.execute`` calls this before it reads the arena, and
        ``arena_ensure`` before it admits."""
        with self._drop_lock:
            self._serving = threading.get_ident()
            drops, self._arena_drops = self._arena_drops, set()
        if self.arena is not None:
            for u in sorted(drops):
                self.arena.invalidate(u)

    def replace_delta_relabeled(self, user_id: str, delta: UserDelta) -> None:
        """Swap in a RELABELED delta — one whose decoded artifact is
        bit-identical to the resident one (cluster ids renamed onto a new
        codebook generation, streams untouched).  Decoded tiles, arena
        runs, and the user's serving version all survive: this is what
        lets a migration leave untouched users' warm state alone.  It
        drops no arena run, so it is safe on any thread."""
        if user_id not in self._deltas:
            raise KeyError(f"unknown user {user_id!r}")
        self.codebook_for(delta.codebook_generation)  # must be resident
        self._deltas[user_id] = delta
        self.version += 1
        # drop only the cheap hydrated object: it holds a reference to the
        # old generation's fit table; tiles/arena/packs are value-identical
        self._hydrated.pop(user_id, None)
        if self.residency is not None:
            # the decoded artifact is identical but the SERIALIZED bytes
            # are not (new generation's cluster ids): the disk shard no
            # longer matches, so demotion must write back first
            self.residency.notify_registered(user_id, delta)

    def delta(self, user_id: str) -> UserDelta:
        """The registered ``UserDelta`` for one user."""
        return self._deltas[user_id]

    def n_trees(self, user_id: str) -> int:
        """Tree count of one user's forest (from the delta header — no
        decode)."""
        return self._deltas[user_id].n_trees

    def max_depth(self, user_id: str) -> int:
        """Max tree depth of one user's forest (from the delta header)."""
        return self._deltas[user_id].max_depth

    # ---------------- decode paths ----------------------------------------
    def hydrate(self, user_id: str) -> CompressedForest:
        """Resolve one user's delta into an inline ``CompressedForest``
        (cached; codebook resolution only, no entropy decode), against the
        codebook generation the delta references."""
        res = self.residency
        if res is None:
            return self._hydrate_cached(user_id)
        res.touch(user_id)
        # pin across load + cache fill: budget enforcement (which can run
        # inside the lazy load's notify) must not demote the user
        # mid-hydrate — that would strand a decoded artifact in
        # ``_hydrated`` the demotion can no longer invalidate
        with res.pin((user_id,)):
            return self._hydrate_cached(user_id)

    def _hydrate_cached(self, user_id: str) -> CompressedForest:
        comp = self._hydrated.get(user_id)
        if comp is None:
            delta = self._deltas[user_id]
            comp = hydrate(delta, self.codebook_for(delta.codebook_generation))
            self._hydrated[user_id] = comp
        return comp

    def reconstruct(self, user_id: str) -> Forest:
        """Bit-exact original forest for this user."""
        delta = self._deltas[user_id]
        return reconstruct_user(
            delta, self.codebook_for(delta.codebook_generation)
        )

    def predict(self, user_id: str, x_binned: np.ndarray) -> np.ndarray:
        """Serve one user's predictions via the decode-side reference path
        (``predict_compressed``, on the store's device) — the oracle the
        kernels are checked against."""
        from ..core.compressed_predict import predict_compressed

        return predict_compressed(
            self.hydrate(user_id), x_binned, device=self.device
        )

    def tiles(self, user_id: str, block_trees: int = 32) -> list[Tile]:
        """Decoded heap tiles for one user, LRU-cached by (user, tile) so a
        hot user's repeat requests skip entropy decode entirely."""
        if self.residency is not None:
            self.residency.touch(user_id)
        run_key = (user_id, block_trees)
        n = self._tile_counts.get(run_key)
        if n is not None:
            keys = [(user_id, block_trees, i) for i in range(n)]
            # count hits only when the WHOLE run is resident — a partially
            # evicted run falls through to a full re-decode, so probing it
            # must not inflate the hit stats
            if all(k in self.cache for k in keys):
                return [self.cache.get(k) for k in keys]  # type: ignore[misc]
        from ..serving.pack import iter_heap_tiles

        tiles = list(iter_heap_tiles(self.hydrate(user_id), block_trees))
        self.cache.record_decode_misses(user_id, len(tiles))
        self._tile_counts[run_key] = len(tiles)
        for i, t in enumerate(tiles):
            self.cache.put((user_id, block_trees, i), t)
        return tiles

    def arena_pack(
        self, users: Sequence[str], block_trees: int = 8,
        pad_to: int | None = None, seg_ids: Sequence[int] | None = None,
    ):
        """Ensure every requested user is resident in the device tile arena
        (cold users pay one decode + fuse + upload), then INDEX-GATHER their
        runs into one packed (T_pad, H) device pair — the pipelined serving
        path's replacement for per-call host packing.

        Returns ``(code, fit, tree_seg, counts, max_depth)`` where
        ``max_depth`` is the arena-wide depth matching the common heap
        width (traversing a shallower user's trees at the arena depth just
        idles at leaves — results are unchanged)."""
        self.arena_ensure(users, block_trees)
        code, fit, tree_seg, counts = self.arena.gather(
            users, block_trees, pad_to=pad_to, seg_ids=seg_ids
        )
        return code, fit, tree_seg, counts, self.arena.max_depth

    def arena_ensure(
        self, users: Sequence[str], block_trees: int = 8
    ) -> None:
        """Admit every non-resident user in ONE arena append.  Callers that
        gather in several pieces (the sharded engine) MUST ensure the whole
        working set first: admissions can grow the arena's common heap
        width, which would leave earlier gathers at a stale width."""
        if self.arena is None:
            raise ValueError(
                "store schema is incompatible with the fused tile arena"
            )
        self.serve_path()
        missing = [u for u in users if u not in self.arena]
        if missing:  # one eviction pass + one buffer append for the batch
            self.arena.admit_many(
                [
                    (u, self.tiles(u, block_trees), self.max_depth(u))
                    for u in missing
                ],
                pinned=set(users),
            )

    # ---------------- drift observability ---------------------------------
    def drift_stats(self, exclude: tuple = ()) -> dict:
        """Codebook-lifecycle drift summary (generation, fallback-cluster
        fraction, fallback byte overhead) for dashboards —
        ``ForestServer.stats()`` surfaces this without reaching into store
        internals.  Memoized per (registry version, exclude set): the
        underlying ``drift_report`` re-serializes every delta, which a
        polling dashboard must not pay per call.  ``exclude`` names users
        to drop from the accounting (the serving layer passes its
        quarantined users — their deltas cannot be decoded).  Full
        report: ``store.lifecycle.drift_report``."""
        exclude = tuple(sorted(exclude))
        cached = getattr(self, "_drift_stats_cache", None)
        if cached is not None and cached[0] == (self.version, exclude):
            return cached[1]
        from .lifecycle import drift_report

        rep = drift_report(self, exclude=exclude)
        stats = {
            "codebook_generation": rep["codebook_generation"],
            "generations": rep["generations"],
            "n_users": rep["n_users"],
            "n_excluded_users": rep["n_excluded_users"],
            "fallback_user_fraction": rep["fallback_user_fraction"],
            "fallback_overhead_fraction": rep["fallback_overhead_fraction"],
        }
        self._drift_stats_cache = ((self.version, exclude), stats)
        return stats

    # ---------------- sizes + serialization -------------------------------
    def size_report(self) -> dict:
        """Byte accounting of everything the store would persist: every
        resident codebook generation (current + retained-for-migration)
        plus all user deltas."""
        shared_bytes = len(self.shared.to_bytes())
        retained_bytes = {
            g: len(cb.to_bytes()) for g, cb in sorted(self._retained.items())
        }
        per_user = {u: len(d.to_bytes()) for u, d in self._deltas.items()}
        return {
            "n_users": len(self._deltas),
            "codebook_generation": self.shared.generation,
            "shared_codebook_bytes": shared_bytes,
            "retained_codebook_bytes": retained_bytes,
            "user_delta_bytes_total": sum(per_user.values()),
            "total_bytes": (
                shared_bytes
                + sum(retained_bytes.values())
                + sum(per_user.values())
            ),
            "per_user_bytes": per_user,
            "lossy": self.lossy,
        }

    def to_bytes(self) -> bytes:
        """Serialize as one RFT1 frame (normative spec: docs/format.md):
        every resident codebook ascending by generation — the LAST is the
        current one — then the user deltas."""
        out = io.BytesIO()
        out.write(_MAGIC)
        codebooks = [self._retained[g] for g in sorted(self._retained)]
        codebooks.append(self.shared)
        write_u16(out, len(codebooks))
        for cb in codebooks:
            write_bytes(out, cb.to_bytes())
        write_u32(out, len(self._deltas))
        for user_id, delta in sorted(self._deltas.items()):
            write_bytes(out, user_id.encode("utf-8"))
            write_bytes(out, delta.to_bytes())
        return with_crc(out.getvalue())

    @classmethod
    def from_bytes(
        cls, data: bytes, tile_cache_trees: int = 4096,
        device: str | torch.device = "cuda",
    ) -> "ForestStore":
        """Parse one RFT1 frame (normative spec: docs/format.md) into a
        store on ``device``.  The CRC32 trailer is verified when present;
        corruption raises a typed ``core.framing.IntegrityError`` /
        ``TruncatedFrameError``."""
        inp = io.BytesIO(check_crc(data, "RFT1 store"))
        expect_magic(inp, _MAGIC, "RFT1 store")
        n_cb = read_u16(inp)
        if n_cb < 1:
            raise IntegrityError(
                "RFT1 store frame must carry at least one codebook"
            )
        codebooks = [
            SharedCodebook.from_bytes(read_bytes(inp)) for _ in range(n_cb)
        ]
        store = cls(
            codebooks[-1], tile_cache_trees=tile_cache_trees, device=device
        )
        for cb in codebooks[:-1]:
            store._retained[cb.generation] = cb
        n = read_u32(inp)
        for _ in range(n):
            user_id = read_bytes(inp).decode("utf-8")
            store.add_delta(user_id, UserDelta.from_bytes(read_bytes(inp)))
        store.drop_unreferenced_codebooks()
        return store


def _quantize_fleet(items, lossy):
    """Quantize every user's regression fit table onto ONE fleet-wide
    fixed-rate grid: the fleet fit-value table then holds at most
    2**fit_bits learned grid points, and the report carries the paper's
    §6 distortion bound for the store stats."""
    from ..core.lossy import quantize_fits

    if any(f.meta.task != "regression" for _, f in items):
        raise ValueError(
            "lossy fit quantization applies to regression fleets"
        )
    union = np.concatenate([
        np.asarray(f.fit_values, np.float64) for _, f in items
    ])
    lo, hi = float(union.min()), float(union.max())
    step = max(hi - lo, 1e-30) / (1 << lossy.fit_bits)
    quantized, max_err = [], 0.0
    for user_id, forest in items:
        # per-user dither seed: reusing one seed would draw IDENTICAL
        # dither vectors across users, correlating quantization errors
        # and voiding the independent-error model behind the bounds
        user_seed = (lossy.seed + zlib.crc32(user_id.encode())) & 0x7FFFFFFF
        qf, err = quantize_fits(
            forest, lossy.fit_bits, dithered=lossy.dithered,
            seed=user_seed, value_range=(lo, hi),
        )
        max_err = max(max_err, err)
        quantized.append((user_id, qf))
    grid_used = np.unique(np.concatenate([
        np.asarray(f.fit_values, np.float64) for _, f in quantized
    ]))
    report = {
        "fit_bits": lossy.fit_bits,
        "dithered": lossy.dithered,
        "grid_levels": 1 << lossy.fit_bits,
        "grid_levels_used": int(grid_used.size),
        "step": step,
        # §6 closed-form bounds: |error| <= step/2 (step with dither),
        # per-value quantization variance step^2 / 12
        "max_error_bound": step * (1.0 if lossy.dithered else 0.5),
        "max_abs_error": max_err,
        "distortion_bound": step * step / 12.0,
    }
    return quantized, report


def build_store(
    forests: dict[str, Forest] | Sequence[tuple[str, Forest]],
    k_max: int = 16,
    seed: int = 0,
    engine: str = "chunked",
    chunk_size: int = 65536,
    tile_cache_trees: int = 4096,
    arena_capacity_trees: int = 16384,
    lossy: "LossyConfig | None" = None,
    device: str | torch.device = "cuda",
) -> ForestStore:
    """Build a multi-tenant store from a fleet: fleet-scale Bregman
    clustering for the shared codebooks, then one delta per user.

    ``lossy`` (a ``core.lossy.LossyConfig``) turns the fleet fit table
    into a learned fixed-rate grid: every regression user's fits are
    quantized onto one fleet-wide 2**fit_bits-level grid BEFORE delta
    encoding, so the shared value table shrinks to at most ``2**fit_bits``
    entries and every existing lossless path (delta encode, hydrate,
    serve) applies unchanged — "lossy = preprocess, then lossless" (paper
    §7).  The measured max error and the §6 distortion bound land in
    ``store.lossy`` / ``size_report()``.

    ``device`` holds the store's arena and runs the dense clustering
    engine (the default chunked engine is host numpy)."""
    items: Iterable[tuple[str, Forest]] = (
        forests.items() if isinstance(forests, dict) else forests
    )
    items = list(items)
    device = resolve_device(device)
    lossy_report = None
    if lossy is not None:
        items, lossy_report = _quantize_fleet(items, lossy)
    shared = build_shared_codebook(
        [f for _, f in items], k_max=k_max, seed=seed,
        engine=engine, chunk_size=chunk_size, device=device,
    )
    store = ForestStore(
        shared, tile_cache_trees=tile_cache_trees,
        arena_capacity_trees=arena_capacity_trees, device=device,
    )
    for user_id, forest in items:
        store.add_user(user_id, forest, seed=seed)
    store.lossy = lossy_report
    return store
