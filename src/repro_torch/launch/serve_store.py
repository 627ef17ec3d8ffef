"""Ragged multi-tenant serving driver and the pipelined STAGE helpers —
the port of ``repro.launch.serve_store``.

Serving goes through the session API:

    from repro_torch.serving import ForestServer
    server = ForestServer(store, device="cuda")
    plan = server.plan(requests)     # grouping + cost-model engine choice
    preds = server.execute(plan, [x for _, x in requests])

The pipelined STAGE helpers (``pack_pipelined_batch`` /
``run_pipelined_kernel`` / ``finalize_pipelined_batch``) are the
un-memoized baseline: the same stages the session composes, without its
plan cache.

    PYTHONPATH=src python -m repro_torch.launch.serve_store --users 40 \
        --requests 64 --rows 256 --engine pipelined --device cuda

``--device`` defaults to ``cuda`` and raises without a card; ``--device
cpu`` runs the kernels' plain versions.  ``--engine sharded`` spreads the
batch's trees over every visible card (K5).
"""
from __future__ import annotations

import argparse
import time
from typing import NamedTuple, Sequence

import numpy as np

from ..serving.pack import (
    group_requests as _group_requests,
    pad_heap_width as _pad_heap_width,  # canonical home: serving.pack
    pack_host_tiles,
)
from ..store.runtime import ForestStore

Request = tuple[str, np.ndarray]


def pack_request_batch(
    store: ForestStore,
    requests: Sequence[Request],
    block_trees: int = 32,
):
    """Group a mixed-user batch for the segmented kernel (the host
    packing of ``engine="simple"``, kept for oracles and tests; the
    canonical pieces live in ``serving.pack``)."""
    users, _seg_of, xb, obs_seg, row_slices = _group_requests(requests)
    tree_pack, max_depth, seg_trees = pack_host_tiles(
        store, users, block_trees
    )
    return xb, obs_seg, row_slices, tree_pack, max_depth, seg_trees


def _finalize(
    store: ForestStore,
    requests: Sequence[Request],
    row_slices,
    total: np.ndarray,
    task: str,
) -> list[np.ndarray]:
    out: list[np.ndarray] = []
    for (user_id, _), sl in zip(requests, row_slices):
        if task == "classification":
            out.append(total[sl].argmax(-1).astype(np.float64))
        else:
            out.append(
                total[sl].astype(np.float64)
                / max(store.n_trees(user_id), 1)
            )
    return out


def _empty_preds(requests):
    return [np.zeros(len(x), np.float64) for _, x in requests]


# ---------------------------------------------------------------------------
# pipelined stage helpers — the un-memoized baseline; the session API
# composes the same stages through serving.engines.
# ---------------------------------------------------------------------------

class PipelinedBatch(NamedTuple):
    """Output of ``pack_pipelined_batch``: everything the one K1 launch
    needs, plus the row bookkeeping to undo the segment sort."""

    xb_s: np.ndarray
    oseg_s: np.ndarray
    code: object  # (T_pad, H) device
    fit: object  # (T_pad, H) device
    tree_seg: np.ndarray
    chunk_lo: np.ndarray
    chunk_hi: np.ndarray
    max_depth: int
    block_trees: int
    block_obs: int
    order: np.ndarray
    row_slices: list


def pack_pipelined_batch(
    store, requests, block_trees: int = 8, block_obs: int = 128,
) -> PipelinedBatch | None:
    """Pipelined pack stage: group rows, arena index-gather, segment sort,
    chunk ranges.  Returns None for an all-empty batch.  (Public so the
    benchmark times the EXACT stage the engine runs.)"""
    from ..kernels.tree_predict.tree_predict import segment_chunk_ranges

    users, _seg_of, xb, obs_seg, row_slices = _group_requests(requests)
    n = len(xb)
    if n == 0:
        return None
    code, fit, tree_seg, counts, max_depth = store.arena_pack(
        users, block_trees
    )
    # rows sorted by segment id == arena gather order, so each row block's
    # needed chunk range is tight (block-diagonal work in one launch)
    order = np.argsort(obs_seg, kind="stable")
    xb_s = np.ascontiguousarray(xb[order])
    oseg_s = np.ascontiguousarray(obs_seg[order])
    block_obs = min(block_obs, n)
    chunk_lo, chunk_hi = segment_chunk_ranges(
        oseg_s, tree_seg, block_trees, block_obs
    )
    return PipelinedBatch(
        xb_s, oseg_s, code, fit, tree_seg, chunk_lo, chunk_hi, max_depth,
        block_trees, block_obs, order, row_slices,
    )


def run_pipelined_kernel(store, pb: PipelinedBatch):
    """Pipelined kernel stage: the single K1 launch."""
    from ..kernels.tree_predict.tree_predict import (
        forest_predict_agg_segmented_packed,
    )

    task = store.shared.task
    n_classes = store.shared.n_classes if task == "classification" else 0
    return forest_predict_agg_segmented_packed(
        pb.xb_s, pb.oseg_s, pb.code, pb.fit, pb.tree_seg, pb.chunk_lo,
        pb.chunk_hi, pb.max_depth, store.arena.tb2, n_classes=n_classes,
        block_trees=pb.block_trees, block_obs=pb.block_obs,
    )


def finalize_pipelined_batch(
    store, requests, pb: PipelinedBatch, out
) -> list[np.ndarray]:
    """Pipelined finalize stage: unsort + per-request argmax/mean."""
    task = store.shared.task
    out = out.cpu().numpy().astype(np.float64)
    total = np.empty_like(out)
    total[pb.order] = out
    return _finalize(store, requests, pb.row_slices, total, task)


def serve_pipelined_uncached(
    store, requests, block_trees: int = 8, block_obs: int = 128,
) -> list[np.ndarray]:
    """The pipelined path composed stage by stage WITHOUT the session plan
    cache — the baseline the cross-batch gather memoization is measured
    against."""
    pb = pack_pipelined_batch(store, requests, block_trees, block_obs)
    if pb is None:
        return _empty_preds(requests)
    out = run_pipelined_kernel(store, pb)
    return finalize_pipelined_batch(store, requests, pb, out)


def main(argv: Sequence[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--users", type=int, default=40)
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--rows", type=int, default=256,
                    help="rows per request")
    ap.add_argument("--task", choices=("classification", "regression"),
                    default="classification")
    ap.add_argument("--depth", type=int, default=6)
    ap.add_argument("--block-trees", type=int, default=None)
    ap.add_argument("--engine", default=None,
                    choices=("simple", "pipelined", "sharded"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from ..device import resolve_device
    from ..serving import ForestServer
    from ..store import build_store, make_request_batch, make_synthetic_fleet

    dev = resolve_device(args.device)
    fleet = make_synthetic_fleet(
        args.users, task=args.task, max_depth=args.depth, seed=args.seed
    )
    t0 = time.time()
    store = build_store(fleet, device=dev)
    t_build = time.time() - t0
    rep = store.size_report()
    server = ForestServer(store, device=dev)
    requests = make_request_batch(
        store, args.requests, args.rows, args.seed
    )
    plan = server.plan(requests, engine=args.engine,
                       block_trees=args.block_trees)
    server.execute(plan, [x for _, x in requests])  # build + warm caches
    t0 = time.time()
    preds = server.execute(plan, [x for _, x in requests])
    t_serve = time.time() - t0
    n_rows = sum(len(x) for _, x in requests)

    mismatch = 0
    for (user_id, x), p in zip(requests[:8], preds[:8]):
        ref = store.predict(user_id, x)
        if args.task == "classification":
            mismatch += int((p != ref).sum())
        else:
            mismatch += int(np.max(np.abs(p - ref)) > 1e-4)
    stats = server.stats()
    stats["tile_cache"].pop("per_user", None)  # too chatty for the demo
    print(
        f"store: {rep['n_users']} users, "
        f"{rep['total_bytes']} bytes total "
        f"({rep['shared_codebook_bytes']} shared codebook), "
        f"built in {t_build:.1f}s\n"
        f"plan: engine={plan.engine.name} ({plan.engine.reason}), "
        f"{plan.n_users} users / {plan.t_pad} padded trees / "
        f"{plan.n_row_blocks} row blocks\n"
        f"ragged batch: {len(requests)} requests / {n_rows} rows in "
        f"{t_serve * 1e3:.1f} ms ({n_rows / t_serve:.0f} rows/s)\n"
        f"session stats: {stats}\n"
        f"parity vs per-user predict_compressed (8 requests): "
        f"{mismatch} mismatches"
    )


if __name__ == "__main__":
    main()
