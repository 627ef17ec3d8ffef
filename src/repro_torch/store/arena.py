"""Device-resident tile arena (ISSUE 3 tentpole piece 1).

PR 2 re-packed every request batch on the host: each call concatenated the
requested users' decoded heap tiles, re-padded them to a common heap width,
and re-uploaded the result.  The arena moves that work OFF the request
path: a user's decoded tiles are fused + padded + uploaded ONCE into a
persistent device buffer, and ``pack_request_batch`` degenerates to an
int64 row-index gather (``torch.index_select`` along the tree axis) — no
host concatenation, no re-padding, no re-upload for warm users.  The
buffers are torch tensors on the arena's ``device`` (default ``"cuda"``,
resolved by ``device.resolve_device``).

Layout: trees from all resident users pack row-contiguously into two
device arrays at the arena's common (padded) heap width —

* ``code``  (T_resident, H) float32 — FUSED node attributes
  ``(feature * TB + threshold) * 2 + is_internal`` (the pipelined kernel's
  single-gather-per-level layout, exact below 2**24);
* ``fit``   (T_resident, H) float32 — leaf payloads (class ids or fits).

The width grows monotonically as deeper users are admitted (rare: one
``torch.nn.functional.pad`` rebuild); admission appends rows; eviction
compacts survivors with one device gather.  Eviction is DECODE-COST-WEIGHTED (GreedyDual):
each run's priority is ``clock + trees * 2**depth`` at admission/access,
the minimum-priority non-pinned run is evicted first, and the clock
advances to the evicted priority — deep users (expensive to re-decode and
re-upload) outlive shallow ones at equal recency, and equal costs reduce
to plain LRU.

Every structural change (admission, eviction/compaction, width growth,
invalidation) bumps a monotonic ``epoch`` (an observability counter for
``stats()``).  Cache validity is finer-grained: each resident run carries
a per-run admission ``token`` (``run_token``), and the serving session's
``PlanCache`` validates a memoized cross-batch gather against exactly the
tokens of the users it covers — so evicting or re-admitting one user
invalidates only the packs containing that user, while compaction and
width growth (which leave gathered COPIES valid) invalidate nothing.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..kernels.tree_predict.tree_predict import (
    fuse_node_attrs,
    fused_code_limit,
    fused_threshold_base,
)
from .policy import GreedyDualClock, decode_cost

_F32_EXACT_INT = 1 << 24

Tile = tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]


class _Run:
    __slots__ = (
        "start", "n_trees", "cost", "priority", "last_access", "h", "depth",
        "token",
    )

    def __init__(self, start, n_trees, cost, priority, last_access, h,
                 depth, token):
        self.start = start
        self.n_trees = n_trees
        self.cost = cost
        self.priority = priority
        self.last_access = last_access
        self.h = h  # the run's OWN heap width (pre arena padding)
        self.depth = depth
        self.token = token  # admission id: per-run validity token


class TileArena:
    """Persistent padded-width device buffer of fused heap tiles, keyed by
    user run, with decode-cost-weighted (GreedyDual) eviction."""

    def __init__(
        self, n_features: int, threshold_base: int,
        capacity_trees: int = 16384,
        device: str | torch.device = "cuda",
    ) -> None:
        self.device = resolve_device(device)
        if fused_code_limit(n_features, threshold_base) >= _F32_EXACT_INT:
            raise ValueError(
                f"fused code word for d={n_features}, TB={threshold_base} "
                "exceeds 2**24; the arena's packed layout would corrupt"
            )
        self.n_features = n_features
        self.tb = threshold_base
        self.tb2 = 2 * threshold_base
        self.capacity_trees = capacity_trees
        self.max_depth = 0
        self.h = 0  # common padded heap width of the resident buffers
        self._code: torch.Tensor | None = None  # (T_resident, h) f32
        self._fit: torch.Tensor | None = None  # (T_resident, h) f32
        self._runs: dict[str, _Run] = {}
        self._gd = GreedyDualClock()
        self.admissions = 0
        self.evictions = 0
        self.gathers = 0
        self.compactions = 0
        self.epoch = 0  # bumped on any structural change (see module doc)
        # LAZY defragmentation (ISSUE 10): eviction/invalidation only
        # MARKS rows dead (O(1) per victim — gathers are index-based, so
        # holes are skipped naturally); the O(arena) compaction gather is
        # deferred until dead rows block an admission or cross this
        # fraction of capacity.
        self.dead_trees = 0
        self.defrag_threshold = 0.25
        # fault-injection hook: when set, called with the cold users'
        # ids at the top of admit_many, BEFORE any state mutates — see
        # runtime.chaos.TransientFaults and ForestServer's retry path
        self.admission_fault = None

    # ---------------- bookkeeping -----------------------------------------
    def __contains__(self, user_id: str) -> bool:
        return user_id in self._runs

    def run_token(self, user_id: str) -> int | None:
        """Per-run validity token: the admission id of the user's resident
        run, or ``None`` when the user is not resident.  A memoized
        cross-batch gather is valid exactly while every one of its users'
        tokens is unchanged — eviction or re-admission of one user
        invalidates only the packs containing that user (the serving
        session's partial invalidation), instead of the arena-wide
        ``epoch`` sweep."""
        run = self._runs.get(user_id)
        return None if run is None else run.token

    @property
    def resident_trees(self) -> int:
        return sum(r.n_trees for r in self._runs.values())

    @property
    def buffer_trees(self) -> int:
        """Physical device rows (live runs + not-yet-reclaimed dead rows)
        — the arena's true device footprint between compactions."""
        return 0 if self._code is None else int(self._code.shape[0])

    def stats(self) -> dict:
        """Occupancy and admission/eviction/gather counters."""
        return {
            "resident_users": len(self._runs),
            "resident_trees": self.resident_trees,
            "buffer_trees": self.buffer_trees,
            "dead_trees": self.dead_trees,
            "heap_width": self.h,
            "admissions": self.admissions,
            "evictions": self.evictions,
            "gathers": self.gathers,
            "compactions": self.compactions,
            "epoch": self.epoch,
        }

    def touch_users(self, users: Sequence[str]) -> None:
        """Record an access for resident runs WITHOUT gathering — a batch
        served from a memoized cross-batch pack must still refresh its
        users' eviction priorities."""
        for user_id in users:
            run = self._runs.get(user_id)
            if run is not None:
                self._touch(run)

    def invalidate(self, user_id: str) -> None:
        """Evict one user's resident run (delta replacement or residency
        demotion).  O(touched run): the rows are only MARKED dead — the
        compaction gather is deferred (``_maybe_compact``)."""
        run = self._runs.pop(user_id, None)
        if run is not None:
            self.dead_trees += run.n_trees
            self.epoch += 1
            self._maybe_compact()

    # ---------------- admission / eviction --------------------------------
    def _touch(self, run: _Run) -> None:
        run.priority, run.last_access = self._gd.touch(run.cost)

    def _compact(self) -> None:
        """Rebuild the device buffers with only surviving runs (one gather
        per attribute), re-basing every run's start offset and SHRINKING
        the common width/depth back to the survivors' maximum — evicting
        the one deep user must not inflate every later batch forever."""
        self.epoch += 1
        self.compactions += 1
        self.dead_trees = 0
        if not self._runs:
            self._code = self._fit = None
            self.h = 0
            self.max_depth = 0
            return
        idx_parts, off = [], 0
        for run in self._runs.values():
            idx_parts.append(np.arange(run.start, run.start + run.n_trees))
            run.start = off
            off += run.n_trees
        idx = torch.as_tensor(
            np.concatenate(idx_parts), dtype=torch.int64, device=self.device
        )
        self.h = max(run.h for run in self._runs.values())
        self.max_depth = max(run.depth for run in self._runs.values())
        # gather from the width-cut view: the result is a fresh contiguous
        # (T, h) buffer, and the old wider one is freed
        self._code = torch.index_select(self._code[:, : self.h], 0, idx)
        self._fit = torch.index_select(self._fit[:, : self.h], 0, idx)

    def _maybe_compact(self) -> None:
        """Reclaim dead rows once they cross ``defrag_threshold`` of
        capacity — bounding the footprint overhead of lazy eviction
        while amortizing the O(arena) gather over many retirements.
        Shape overhang compacts IMMEDIATELY: when the victim was the
        width/depth-determining run, every later batch would pay its
        padded width forever, so that (rare) case is worth the eager
        gather."""
        if not self.dead_trees:
            return
        if not self._runs:
            self._compact()
            return
        overhang = (
            max(run.h for run in self._runs.values()) < self.h
            or max(run.depth for run in self._runs.values())
            < self.max_depth
        )
        if (
            overhang
            or self.dead_trees
            >= self.defrag_threshold * self.capacity_trees
        ):
            self._compact()

    def _evict_for(self, need: int, pinned: set[str]) -> None:
        """GreedyDual: evict minimum-priority non-pinned runs until ``need``
        trees fit (ties broken oldest-access-first), advancing the clock.
        Victims' rows are marked dead, not compacted — but if the holes
        would push the PHYSICAL buffer past capacity after the append,
        one compaction reclaims them (capacity honesty: the device
        footprint bound holds at every admission)."""
        victims = []
        resident = self.resident_trees
        while resident + need > self.capacity_trees:
            candidates = [
                (r.priority, r.last_access, u)
                for u, r in self._runs.items() if u not in pinned
            ]
            if not candidates:
                break  # working set itself exceeds capacity: let it grow
            prio, _, user = min(candidates)
            run = self._runs.pop(user)
            resident -= run.n_trees
            self.dead_trees += run.n_trees
            self._gd.evicted(prio)
            victims.append(user)
            self.evictions += 1
        if victims:
            self.epoch += 1
        if self.dead_trees and self.buffer_trees + need > self.capacity_trees:
            self._compact()

    def _grow_width(self, h_new: int, max_depth: int) -> None:
        if self._code is not None and h_new > self.h:
            pad = (0, h_new - self.h)
            self._code = F.pad(self._code, pad)
            self._fit = F.pad(self._fit, pad)
        self.h = max(self.h, h_new)
        self.max_depth = max(self.max_depth, max_depth)

    def admit_many(
        self,
        items: Sequence[tuple[str, Sequence[Tile], int]],
        pinned: set[str] | None = None,
    ) -> None:
        """Fuse + pad + upload several users' decoded heap tiles in ONE
        eviction pass and ONE buffer append (a cold fleet sweep costs one
        device concatenate, not one per user).  ``items`` holds
        ``(user_id, tiles, max_depth)`` triples; already-resident users are
        just touched."""
        if self.admission_fault is not None:
            # fault-injection hook (runtime.chaos.TransientFaults): raises
            # TransientError BEFORE any arena state mutates, modeling a
            # failed device upload — the serving retry path depends on
            # admission being all-or-nothing
            self.admission_fault([u for u, _, _ in items])
        fused: list[tuple[str, np.ndarray, np.ndarray, int]] = []
        for user_id, tiles, max_depth in items:
            if user_id in self._runs:
                self._touch(self._runs[user_id])
                continue
            feats, thrs, fits, inters = (
                [t[k] for t in tiles] for k in range(4)
            )
            feature = np.concatenate(feats)
            threshold = np.concatenate(thrs)
            fit = np.concatenate(fits).astype(np.float32)
            inter = np.concatenate(inters)
            if int(threshold.max(initial=0)) >= self.tb:
                raise ValueError(
                    f"user {user_id!r} threshold symbols exceed the "
                    f"arena's field width TB={self.tb}"
                )
            fused.append(
                (user_id, fuse_node_attrs(feature, threshold, inter,
                                          self.tb),
                 fit, max_depth)
            )
        if not fused:
            return
        if pinned is None:
            pinned = {u for u, _, _, _ in fused}
        t_new = sum(c.shape[0] for _, c, _, _ in fused)
        self._evict_for(t_new, pinned)
        for _, code, _, max_depth in fused:
            self._grow_width(code.shape[1], max_depth)

        from ..serving.pack import pad_heap_width  # canonical pad helper

        code_rows = np.concatenate(
            [pad_heap_width(c, self.h) for _, c, _, _ in fused]
        )
        fit_rows = np.concatenate(
            [pad_heap_width(f, self.h) for _, _, f, _ in fused]
        )
        start = 0 if self._code is None else int(self._code.shape[0])
        code_d = torch.as_tensor(code_rows, device=self.device)
        fit_d = torch.as_tensor(fit_rows, device=self.device)
        if self._code is None:
            self._code, self._fit = code_d, fit_d
        else:
            self._code = torch.cat([self._code, code_d])
            self._fit = torch.cat([self._fit, fit_d])
        for user_id, code, _, max_depth in fused:
            t_u, h_u = code.shape
            cost = decode_cost(t_u, h_u)
            prio, tick = self._gd.touch(cost)
            self.admissions += 1
            self._runs[user_id] = _Run(
                start, t_u, cost, prio, tick, h_u, max_depth,
                token=self.admissions,
            )
            start += t_u
        self.epoch += 1

    def admit(
        self, user_id: str, tiles: Sequence[Tile], max_depth: int,
        pinned: set[str] | None = None,
    ) -> None:
        """Fuse + pad + upload one user's decoded heap tiles (the expensive
        one-time step the per-request path no longer pays)."""
        self.admit_many([(user_id, tiles, max_depth)], pinned=pinned)

    # ---------------- the hot path ----------------------------------------
    def gather(
        self, users: Sequence[str], block_trees: int = 8,
        pad_to: int | None = None,
        seg_ids: Sequence[int] | None = None,
    ):
        """Index-gather the requested users' resident runs into one packed
        (T_pad, H) pair of device arrays plus host segment ids.

        Returns ``(code, fit, tree_seg, counts)`` where ``tree_seg[r]`` is
        the position of row r's user in ``users`` (-1 for padding rows;
        override per-user ids with ``seg_ids`` — the sharded path keeps
        GLOBAL segment ids on per-shard gathers) and ``counts[s]`` is user
        s's tree count.  ``T_pad`` is padded up to a multiple of
        ``block_trees`` (or to ``pad_to``) so the pipelined kernel sees a
        handful of distinct shapes."""
        idx_parts, seg_parts, counts = [], [], []
        for s, user_id in enumerate(users):
            run = self._runs[user_id]
            self._touch(run)
            idx_parts.append(np.arange(run.start, run.start + run.n_trees))
            seg = s if seg_ids is None else int(seg_ids[s])
            seg_parts.append(np.full(run.n_trees, seg, np.int32))
            counts.append(run.n_trees)
        idx = (
            np.concatenate(idx_parts)
            if idx_parts else np.zeros(0, np.int64)
        )
        t = len(idx)
        t_pad = max(-(-t // block_trees) * block_trees, block_trees)
        if pad_to is not None:
            if pad_to % block_trees or pad_to < t_pad:
                raise ValueError(
                    f"pad_to={pad_to} must be a multiple of block_trees "
                    f">= {t_pad}"
                )
            t_pad = pad_to
        idx = np.pad(idx, (0, t_pad - t))  # pad rows re-read row 0 ...
        tree_seg = np.full(t_pad, -1, np.int32)  # ... but never match a row
        if t:
            tree_seg[:t] = np.concatenate(seg_parts)
        didx = torch.as_tensor(idx, dtype=torch.int64, device=self.device)
        self.gathers += 1
        return (
            torch.index_select(self._code, 0, didx),
            torch.index_select(self._fit, 0, didx),
            tree_seg,
            np.asarray(counts, np.int64),
        )
