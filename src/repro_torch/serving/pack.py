"""Host-side packing for the serving session API (ISSUE 4).

One canonical home for the request-batch layout machinery that PR 1-3
scattered across ``launch/serve_forest.py`` and ``launch/serve_store.py``:

* ``pad_heap_width`` — THE heap-width padding helper (previously duplicated
  between ``serve_store._pad_heap_width`` and the arena's pad path);
* ``tree_to_heap`` / ``iter_heap_tiles`` — compressed bytes → heap-form
  tree tiles (moved from ``launch.serve_forest``, which re-exports them);
* ``batch_layout`` / ``group_requests`` — mixed-user request batches →
  segment ids, row slices, and the segment-sort permutation;
* ``pack_host_tiles`` — the PR 2 host tile pack kept for the ``simple``
  engine (the differential oracle / baseline).

Everything here is pure host work over numpy arrays — the plan side of the
plan/execute split.  Device gathers live in ``serving.engines``.
"""
from __future__ import annotations

from typing import Iterator, Sequence

import numpy as np

from ..core.forest_codec import CompressedForest
from ..core.tree import Tree

Request = tuple[str, np.ndarray]
Tile = tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]


def pad_heap_width(tile_arr: np.ndarray, h: int) -> np.ndarray:
    """Pad a (t, h_u) heap-form tile to heap width ``h`` with zero columns
    (no copy when the width already matches — the hot fleet path).  The one
    canonical implementation; ``launch.serve_store`` and the device arena
    both route through it."""
    t, h_u = tile_arr.shape
    if h_u == h:
        return tile_arr
    if h_u > h:
        raise ValueError(f"cannot shrink heap width {h_u} -> {h}")
    out = np.zeros((t, h), dtype=tile_arr.dtype)
    out[:, :h_u] = tile_arr
    return out


def tree_to_heap(
    tree: Tree,
    fit_values: np.ndarray | None,
    feature: np.ndarray,
    threshold: np.ndarray,
    fit: np.ndarray,
    is_internal: np.ndarray,
) -> None:
    """Write one preorder compact tree into heap-form rows (node i ->
    children 2i+1 / 2i+2), the layout the Pallas kernel traverses."""
    stack = [(0, 0)]  # (preorder node id, heap slot)
    left, right = tree.children_left, tree.children_right
    feat, thr, nfit = tree.feature, tree.threshold, tree.node_fit
    while stack:
        i, slot = stack.pop()
        if feat[i] >= 0:
            feature[slot] = feat[i]
            threshold[slot] = thr[i]
            is_internal[slot] = True
            stack.append((int(right[i]), 2 * slot + 2))
            stack.append((int(left[i]), 2 * slot + 1))
        elif fit_values is not None:
            fit[slot] = fit_values[int(nfit[i])]
        else:
            fit[slot] = float(nfit[i])


def iter_heap_tiles(
    comp: CompressedForest, block_trees: int
) -> Iterator[Tile]:
    """Stream (feature, threshold, fit, is_internal) heap tiles of up to
    ``block_trees`` trees each, decoded on the fly from the compressed
    bytes — host memory holds one tile, not the forest."""
    from ..core.compressed_predict import iter_trees

    n_heap = (1 << (comp.max_depth + 1)) - 1
    fit_values = (
        comp.fit_values if comp.meta.task == "regression" else None
    )
    buf: list[Tree] = []

    def pack(trees: list[Tree]) -> Tile:
        t = len(trees)
        feature = np.zeros((t, n_heap), np.int32)
        threshold = np.zeros((t, n_heap), np.int32)
        fit = np.zeros((t, n_heap), np.float32)
        is_internal = np.zeros((t, n_heap), bool)
        for k, tree in enumerate(trees):
            tree_to_heap(
                tree, fit_values,
                feature[k], threshold[k], fit[k], is_internal[k],
            )
        return feature, threshold, fit, is_internal

    for tree in iter_trees(comp):
        buf.append(tree)
        if len(buf) == block_trees:
            yield pack(buf)
            buf = []
    if buf:
        yield pack(buf)


def batch_layout(
    request_users: Sequence[str], row_counts: Sequence[int]
):
    """Row bookkeeping for a mixed-user batch, from the batch SIGNATURE
    alone (user ids + per-request row counts — no row data needed, so a
    ``ServePlan`` can be built and cached without touching X).

    Returns ``(users, seg_of, obs_seg, row_slices, order, oseg_s)``:
    users in first-appearance order (their position IS their segment id),
    the per-row segment id array, per-request row slices into the
    concatenated block, the stable segment-sort permutation, and the
    sorted segment ids."""
    users: list[str] = []
    seg_of: dict[str, int] = {}
    for user_id in request_users:
        if user_id not in seg_of:
            seg_of[user_id] = len(users)
            users.append(user_id)
    oseg_parts, row_slices = [], []
    off = 0
    for user_id, n in zip(request_users, row_counts):
        oseg_parts.append(np.full(int(n), seg_of[user_id], np.int32))
        row_slices.append(slice(off, off + int(n)))
        off += int(n)
    obs_seg = (
        np.concatenate(oseg_parts) if oseg_parts else np.zeros(0, np.int32)
    )
    order = np.argsort(obs_seg, kind="stable")
    return users, seg_of, obs_seg, row_slices, order, obs_seg[order]


def group_requests(requests: Sequence[Request]):
    """Legacy-shaped grouping (rows included): users, seg_of, the (N, d)
    int32 row block, per-row segment ids, per-request row slices."""
    users, seg_of, obs_seg, row_slices, _, _ = batch_layout(
        [u for u, _ in requests], [len(x) for _, x in requests]
    )
    xb_parts = [np.ascontiguousarray(x, np.int32) for _, x in requests]
    xb = (
        np.concatenate(xb_parts) if xb_parts else np.zeros((0, 0), np.int32)
    )
    return users, seg_of, xb, obs_seg, row_slices


def concat_rows(X: Sequence[np.ndarray]) -> np.ndarray:
    """Concatenate per-request row blocks into one (N, d) int32 array."""
    parts = [np.ascontiguousarray(x, np.int32) for x in X]
    return np.concatenate(parts) if parts else np.zeros((0, 0), np.int32)


def pack_host_tiles(store, users: Sequence[str], block_trees: int = 32):
    """The PR 2 host tile pack (``engine="simple"``): every requested
    user's decoded heap tiles concatenated at the batch-max heap width.

    Returns ``(tree_pack, max_depth, seg_trees)`` where ``tree_pack`` is
    ``(feature, threshold, fit, is_internal, tree_seg)`` and
    ``seg_trees[s]`` is user s's tree count.  Re-padding only happens for
    users whose heap width differs from the batch maximum
    (``pad_heap_width`` is a no-op otherwise)."""
    max_depth = max(store.max_depth(u) for u in users)
    h = (1 << (max_depth + 1)) - 1
    feats, thrs, fits, inters, tsegs = [], [], [], [], []
    for s, user_id in enumerate(users):
        for feature, threshold, fit, is_internal in store.tiles(
            user_id, block_trees
        ):
            feats.append(pad_heap_width(feature, h))
            thrs.append(pad_heap_width(threshold, h))
            fits.append(pad_heap_width(fit, h))
            inters.append(pad_heap_width(is_internal, h))
            tsegs.append(np.full(feature.shape[0], s, np.int32))
    tree_pack = (
        np.concatenate(feats),
        np.concatenate(thrs),
        np.concatenate(fits),
        np.concatenate(inters),
        np.concatenate(tsegs),
    )
    seg_trees = np.array([store.n_trees(u) for u in users], np.int64)
    return tree_pack, max_depth, seg_trees
