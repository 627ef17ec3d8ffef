"""Engine execution for the serving session.

Each engine takes ``(store, plan, xb)`` and returns the raw per-row
aggregate (``(N, C)`` vote counts or ``(N,)`` fit sums) in ORIGINAL
request order — the server's finalize step turns that into per-request
predictions.  Kernels run on the store's device (``store.device``): the
Hopper kernels on a card, their plain PyTorch versions on the CPU.

The pipelined and sharded engines split into ``build_*_pack`` (arena
ensure + device index-gather + chunk ranges — the part ``PlanCache``
memoizes across batches) and ``run_*`` (the kernel launches, paid per
batch): K1 once, or K5 — one launch on each device of the session's
list over that device's tree shards, then one ordered sum.
``run_simple`` is the host-pack path kept as the differential oracle and
the fallback (K2).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .pack import pack_host_tiles
from .plan import ServePlan


def _n_classes(store) -> int:
    shared = store.shared
    return shared.n_classes if shared.task == "classification" else 0


class PipelinedPack(NamedTuple):
    """Arena-gathered device arrays + chunk ranges for one plan — the
    cross-batch memoizable artifact of the pipelined engine."""

    code: torch.Tensor  # (T_pad, H) f32 on the arena's device
    fit: torch.Tensor  # (T_pad, H) f32 on the arena's device
    tree_seg: np.ndarray  # (T_pad,) int32, -1 padding
    counts: np.ndarray  # (S,) int64
    max_depth: int
    chunk_lo: np.ndarray  # (ceil(N / block_obs),) int32
    chunk_hi: np.ndarray
    block_obs: int  # block_obs AFTER the min(N) clamp


class ShardedPack(NamedTuple):
    """Per-device gathers + ranges for the sharded engine.  Where the
    reference stacks the shards into one (S_dev, T_pad, H) array over its
    mesh, the port stacks each device's shards, in shard order, into one
    (k, T_pad, H) tensor there, which K5's launch reads as it is."""

    code: dict  # {device: (k, T_pad, H) f32}: devices[s]'s shards s
    fit: dict
    tree_seg: np.ndarray  # (S_dev, T_pad) int32
    chunk_lo: np.ndarray  # (S_dev, G) int32
    chunk_hi: np.ndarray
    max_depth: int
    block_obs: int
    devices: tuple  # the session's device list, one per shard


def _request_order(out: torch.Tensor, plan: ServePlan) -> np.ndarray:
    """Device aggregate in segment-sorted row order -> float64 host array
    in request order."""
    sorted_rows = out.cpu().numpy().astype(np.float64)
    total = np.empty_like(sorted_rows)
    total[plan.order] = sorted_rows
    return total


# ---------------------------------------------------------------------------
# simple — host tile pack + one K2 launch per tree chunk
# ---------------------------------------------------------------------------

def run_simple(store, plan: ServePlan, xb: np.ndarray) -> np.ndarray:
    """Host pack + one segmented-kernel launch per tree chunk over that
    chunk's row span.  Returns the (N, C) / (N,) aggregate in original
    request order."""
    from ..kernels.tree_predict.tree_predict import (
        forest_predict_agg_segmented,
    )

    device = store.device
    block_trees = plan.engine.block_trees
    block_obs = plan.engine.block_obs
    tree_pack, max_depth, _seg_trees = pack_host_tiles(
        store, plan.users, block_trees
    )
    feature, threshold, fit, is_internal, tree_seg = tree_pack
    n_classes = _n_classes(store)
    n, c_out = plan.n_rows, max(n_classes, 1)
    t = feature.shape[0]

    # Segments only overlap block-diagonally: sort rows by segment and run
    # each tree chunk against just the row span of the users it contains —
    # work stays ~sum_u T_u * N_u instead of T_total * N_total, while one
    # launch still serves several users' trees (the segment mask sorts out
    # chunk-boundary users).  Spans are padded to block_obs multiples
    # (rows) and the tree pack to a block_trees multiple with
    # non-matching sentinel segments, so every launch sees one tree shape.
    xb_s = np.ascontiguousarray(xb[plan.order])
    oseg_s = plan.oseg_s
    n_segs = plan.n_users
    seg_start = np.searchsorted(oseg_s, np.arange(n_segs))
    seg_end = np.searchsorted(oseg_s, np.arange(n_segs), side="right")

    # one upload of the whole pack and the rows; chunks are views
    pad_t = -t % block_trees
    tseg_p = np.concatenate([tree_seg, np.full(pad_t, -1, np.int32)])

    def up(a: np.ndarray, dtype) -> torch.Tensor:
        if pad_t:
            a = np.concatenate(
                [a, np.zeros((pad_t,) + a.shape[1:], a.dtype)]
            )
        return torch.as_tensor(a, dtype=dtype, device=device)

    feat_d = up(feature, torch.int32)
    thr_d = up(threshold, torch.int32)
    fit_d = up(fit, torch.float32)
    inter_d = up(is_internal, torch.bool)
    tseg_d = torch.as_tensor(tseg_p, dtype=torch.int32, device=device)
    xb_d = torch.as_tensor(xb_s, dtype=torch.int32, device=device)
    oseg_d = torch.as_tensor(oseg_s, dtype=torch.int32, device=device)

    total_sorted = torch.zeros(
        (n, c_out) if n_classes > 0 else (n,), dtype=torch.float64,
        device=device,
    )
    for lo in range(0, t, block_trees):
        hi = min(lo + block_trees, t)
        r0 = int(seg_start[int(tree_seg[lo])])
        r1 = int(seg_end[int(tree_seg[hi - 1])])
        if r1 <= r0:
            continue
        n_rows = r1 - r0
        n_pad = min(-(-n_rows // block_obs) * block_obs, n)
        r1p = min(r0 + n_pad, n)
        r0p = r1p - n_pad  # slide the window instead of materializing pads
        cs = slice(lo, lo + block_trees)
        part = forest_predict_agg_segmented(
            xb_d[r0p:r1p],
            oseg_d[r0p:r1p],
            tseg_d[cs],
            feat_d[cs],
            thr_d[cs],
            fit_d[cs],
            inter_d[cs],
            max_depth=max_depth,
            n_classes=n_classes,
            block_trees=block_trees,
            block_obs=block_obs,
            engine="simple",
        )  # launched async; the host keeps slicing and submitting
        total_sorted[r0p:r1p] += part.to(torch.float64)
    return _request_order(total_sorted, plan)


# ---------------------------------------------------------------------------
# pipelined — arena index-gather + ONE K1 launch
# ---------------------------------------------------------------------------

def build_pipelined_pack(store, plan: ServePlan) -> PipelinedPack:
    """The gather stage: ensure residency, index-gather the plan's users'
    runs, compute per-row-block chunk ranges.  Memoized by ``PlanCache``
    keyed on the plan signature, validated per user (registry version +
    arena run token)."""
    from ..kernels.tree_predict.tree_predict import segment_chunk_ranges

    bt = plan.engine.block_trees
    code, fit, tree_seg, counts, max_depth = store.arena_pack(
        list(plan.users), bt
    )
    bo = min(plan.engine.block_obs, plan.n_rows)
    chunk_lo, chunk_hi = segment_chunk_ranges(
        plan.oseg_s, tree_seg, bt, bo
    )
    return PipelinedPack(
        code, fit, tree_seg, counts, max_depth, chunk_lo, chunk_hi, bo
    )


def run_pipelined(
    store, plan: ServePlan, pack: PipelinedPack, xb: np.ndarray
) -> np.ndarray:
    """The single K1 launch over a (possibly cached) gathered pack.
    Returns the aggregate in request order."""
    from ..kernels.tree_predict.tree_predict import (
        forest_predict_agg_segmented_packed,
    )

    xb_s = np.ascontiguousarray(xb[plan.order])
    out = forest_predict_agg_segmented_packed(
        xb_s, plan.oseg_s, pack.code, pack.fit, pack.tree_seg,
        pack.chunk_lo, pack.chunk_hi, pack.max_depth, store.arena.tb2,
        n_classes=_n_classes(store),
        block_trees=plan.engine.block_trees, block_obs=pack.block_obs,
    )
    return _request_order(out, plan)


# ---------------------------------------------------------------------------
# sharded — tree axis partitioned across devices + one ordered sum (K5)
# ---------------------------------------------------------------------------

def build_sharded_pack(store, plan: ServePlan, devices) -> ShardedPack:
    """Per-device gathers under one shared width: admit the WHOLE batch
    before any per-shard gather (a later shard's cold admission may grow
    the arena heap width, which would leave earlier shards' gathered
    arrays at a stale narrower width), bin-pack users by tree count, then
    gather each shard with GLOBAL segment ids and stack each device's
    shards (``devices``, the session's list) on it."""
    from ..kernels.tree_predict.ops import partition_segments_by_load
    from ..kernels.tree_predict.tree_predict import segment_chunk_ranges

    bt = plan.engine.block_trees
    devices = tuple(devices)
    n_dev = len(devices)
    store.arena_ensure(list(plan.users), bt)
    shards = partition_segments_by_load(plan.seg_trees, n_dev)
    # per-shard users ascend by segment id: sorted rows keep ranges tight
    shards = [sorted(s) for s in shards]
    t_pad = max(
        max(
            (-(-int(plan.seg_trees[s].sum()) // bt) * bt
             for s in map(np.asarray, shards) if len(s)),
            default=bt,
        ),
        bt,
    )
    bo = min(plan.engine.block_obs, plan.n_rows)
    codes, fits, tsegs, los, his = [], [], [], [], []
    max_depth = 0
    for shard in shards:
        shard_users = [plan.users[s] for s in shard]
        code, fit, tseg, _, max_depth = store.arena_pack(
            shard_users, bt, pad_to=t_pad, seg_ids=shard
        )
        lo, hi = segment_chunk_ranges(plan.oseg_s, tseg, bt, bo)
        codes.append(code)
        fits.append(fit)
        tsegs.append(tseg)
        los.append(lo)
        his.append(hi)

    def by_device(tiles):
        return {dev: torch.stack([t for t, d in zip(tiles, devices)
                                  if d == dev]).to(dev)
                for dev in dict.fromkeys(devices)}

    return ShardedPack(
        by_device(codes), by_device(fits), np.stack(tsegs), np.stack(los),
        np.stack(his), max_depth, bo, devices,
    )


def run_sharded(
    store, plan: ServePlan, pack: ShardedPack, xb: np.ndarray
) -> np.ndarray:
    """K5: one launch on each device over its shards, the partials summed
    on the first device in shard order.  Returns the aggregate in request
    order."""
    from ..kernels.tree_predict.ops import (
        forest_predict_agg_segmented_sharded,
    )

    xb_s = np.ascontiguousarray(xb[plan.order])
    out = forest_predict_agg_segmented_sharded(
        xb_s, plan.oseg_s, pack.code, pack.fit, pack.tree_seg,
        pack.chunk_lo, pack.chunk_hi, pack.max_depth, store.arena.tb2,
        n_classes=_n_classes(store),
        block_trees=plan.engine.block_trees, block_obs=pack.block_obs,
        devices=pack.devices,
    )
    return _request_order(out, plan)
