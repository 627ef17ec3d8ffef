"""Forest store runtime — the part of ``repro.store.runtime`` that
single-forest serving needs.

* ``make_schema_arena`` — the device tile arena for a schema, on an
  explicit device;
* ``TileCache`` — the decoded heap-tile cache (GreedyDual by decode cost),
  copied from the reference;
* ``ForestStore`` — only the serving surface ``SingleForestStore``
  inherits: ``tiles``, ``arena_pack`` and ``arena_ensure``.  The fleet
  registry (``ForestStore.__init__``, ``from_bytes``, ``build_store``, the
  shared codebooks and user deltas) comes with the fleet slice (ROADMAP
  Queue 1 item 5) and raises ``NotImplementedError`` until then.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Sequence

import numpy as np
import torch

from .policy import GreedyDualClock, decode_cost

Tile = tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]

_FLEET = (
    "the fleet ForestStore (shared codebooks, user deltas, RFT1) is not "
    "ported yet: ROADMAP Queue 1 item 5"
)


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
    """The serving surface of the reference's multi-tenant ``ForestStore``.

    Subclasses (``serving.server.SingleForestStore``) provide the registry
    (``n_trees``, ``max_depth``, ``hydrate``, ``user_version``), ``cache``
    (a ``TileCache``), ``arena`` and ``residency``; this class supplies the
    decode-and-admit paths the serving engines call.  Constructing the
    fleet store itself waits for ROADMAP Queue 1 item 5."""

    def __init__(self, *_args, **_kwargs) -> None:
        raise NotImplementedError(_FLEET)

    @classmethod
    def from_bytes(cls, data: bytes, tile_cache_trees: int = 4096):
        """Parse an RFT1 store frame — not ported yet."""
        raise NotImplementedError(_FLEET)

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
        missing = [u for u in users if u not in self.arena]
        if missing:  # one eviction pass + one buffer append for the batch
            self.arena.admit_many(
                [
                    (u, self.tiles(u, block_trees), self.max_depth(u))
                    for u in missing
                ],
                pinned=set(users),
            )



def build_store(*_args, **_kwargs):
    """Build a multi-tenant store from a fleet — not ported yet."""
    raise NotImplementedError(_FLEET)
