"""Prediction straight from the compressed format (paper §5).

The serving path is a streamed decode→predict pipeline: every per-cluster
Huffman stream is decoded wholesale with the table-driven vectorized decoder
(``vechuff.VectorHuffman.decode``: width-12 LUT over every bit offset +
prefix-doubling chain extraction, no per-bit Python loop), and ``iter_trees``
then reassembles trees one at a time by advancing plain integer cursors
through the pre-decoded symbol arrays in global preorder.  The working set is
O(#symbols) decoded ints plus ONE tree's structure — storage still holds only
the compressed bytes, which is the paper's subscriber-device scenario.  The
batched traversal runs as torch gathers on the session device, or as numpy
gathers when the caller asks for the CPU.

Note on laziness: routing through a node requires its variable name, and the
variable name determines which split-value stream every descendant uses — so
variable names of preorder-preceding nodes must be decoded even off-path.
The paper's claim is the memory bound and the direct-from-bytes operation,
which is exactly what this module delivers; tests assert bit-exact agreement
with the uncompressed forest.

``engine="bitwise"`` preserves the original bit-at-a-time dict-lookup decoder
as a differential oracle and as the benchmark baseline
(``benchmarks/serve_forest.py`` reports before/after numbers against it).
"""
from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from ..device import resolve_device
from .bitio import BitReader
from .forest_codec import ClusteredComponent, CompressedForest
from .lz import lzw_decode_bits
from .tree import Tree
from .zaks import zaks_decode


def _component_symbol_lists(c: ClusteredComponent) -> list[list[int]]:
    """Decode every cluster stream of one component up front.

    Huffman clusters go through the vectorized table-driven decoder;
    arithmetic clusters (two-class fits) are whole-sequence by construction.
    Returns Python lists: cursor consumption in ``iter_trees`` is a hot
    per-node loop and list indexing is ~3x cheaper than numpy scalars.
    """
    return [
        dec.decode(s, n).tolist() if n else []
        for dec, s, n in zip(c.decoders(), c.streams, c.n_symbols)
    ]


def iter_trees(comp: CompressedForest, engine: str = "table") -> Iterator[Tree]:
    """Stream trees one at a time from the compressed bytes.

    engine="table" (default): array-at-a-time — all cluster streams are
    decoded vectorized, then trees are assembled with integer cursors.
    engine="bitwise": the original per-bit decoder (differential oracle).
    """
    if engine == "bitwise":
        yield from _iter_trees_bitwise(comp)
        return
    if engine != "table":
        raise ValueError(f"unknown decode engine: {engine!r}")

    meta = comp.meta
    d = meta.n_features
    zaks_all = lzw_decode_bits(comp.zaks_payload, comp.zaks_total_bits)

    vars_seqs = _component_symbol_lists(comp.vars_comp)
    split_seqs = {
        v: _component_symbol_lists(c) for v, c in comp.splits_comp.items()
    }
    fits_seqs = _component_symbol_lists(comp.fits_comp)
    vars_cur = [0] * len(vars_seqs)
    split_cur = {v: [0] * len(s) for v, s in split_seqs.items()}
    fits_cur = [0] * len(fits_seqs)

    v_map = comp.vars_comp.kid_to_cluster.tolist()
    s_map = {v: c.kid_to_cluster.tolist() for v, c in comp.splits_comp.items()}
    f_map = comp.fits_comp.kid_to_cluster.tolist()

    off = 0
    for tlen in comp.zaks_lengths:
        bits = zaks_all[off : off + int(tlen)]
        off += int(tlen)
        left, right, is_leaf = zaks_decode(bits)
        n = len(bits)
        leftl = left.tolist()
        rightl = right.tolist()
        leafl = is_leaf.tolist()
        feature = [-1] * n
        threshold = [-1] * n
        fit = [0] * n
        depth = [0] * n
        fvar = [-1] * n
        for i in range(n):
            kid = depth[i] * (d + 1) + fvar[i] + 1
            if not leafl[i]:
                c = v_map[kid]
                k = vars_cur[c]
                vars_cur[c] = k + 1
                v = vars_seqs[c][k]
                feature[i] = v
                sc = s_map[v][kid]
                cur = split_cur[v]
                k = cur[sc]
                cur[sc] = k + 1
                threshold[i] = split_seqs[v][sc][k]
                dd = depth[i] + 1
                lc, rc = leftl[i], rightl[i]
                depth[lc] = dd
                fvar[lc] = v
                depth[rc] = dd
                fvar[rc] = v
            fc = f_map[kid]
            k = fits_cur[fc]
            fits_cur[fc] = k + 1
            fit[i] = fits_seqs[fc][k]
        yield Tree(
            np.array(feature, dtype=np.int32),
            np.array(threshold, dtype=np.int32),
            left,
            right,
            np.array(fit, dtype=np.int64),
        )


def _iter_trees_bitwise(comp: CompressedForest) -> Iterator[Tree]:
    """Original node-at-a-time decoder: one dict lookup per BIT, reference
    LZW/Zaks/arithmetic implementations throughout (kept as the differential
    oracle and the seed-faithful benchmark 'before' baseline)."""
    from .lz import lzw_decode_bits_reference
    from .zaks import zaks_decode_reference

    meta = comp.meta
    d = meta.n_features
    zaks_all = lzw_decode_bits_reference(comp.zaks_payload, comp.zaks_total_bits)

    vars_dec = comp.vars_comp.decoders()
    vars_readers = [BitReader(s) for s in comp.vars_comp.streams]
    split_dec = {v: c.decoders() for v, c in comp.splits_comp.items()}
    split_readers = {
        v: [BitReader(s) for s in c.streams]
        for v, c in comp.splits_comp.items()
    }
    fits_dec = comp.fits_comp.decoders()
    if comp.fits_comp.coder == "arithmetic":
        # range decoding is whole-sequence per cluster; decode once, then
        # stream with cursors (still O(#fits) ints, not O(forest) trees).
        fits_seqs = [
            dec.decode_reference(s, n) if n else np.zeros(0, np.int64)
            for dec, s, n in zip(
                fits_dec, comp.fits_comp.streams, comp.fits_comp.n_symbols
            )
        ]
        fits_readers = None
    else:
        fits_seqs = None
        fits_readers = [BitReader(s) for s in comp.fits_comp.streams]
    fits_cursor = [0] * max(
        len(comp.fits_comp.codebook_lengths), len(comp.fits_comp.centroid_freqs)
    )

    off = 0
    for tlen in comp.zaks_lengths:
        bits = zaks_all[off : off + int(tlen)]
        off += int(tlen)
        left, right, is_leaf = zaks_decode_reference(bits)
        n = len(bits)
        feature = np.full(n, -1, dtype=np.int32)
        threshold = np.full(n, -1, dtype=np.int32)
        fit = np.zeros(n, dtype=np.int64)
        depth = np.zeros(n, dtype=np.int32)
        fvar = np.full(n, -1, dtype=np.int32)
        for i in range(n):
            kid = int(depth[i]) * (d + 1) + int(fvar[i]) + 1
            if not is_leaf[i]:
                c = int(comp.vars_comp.kid_to_cluster[kid])
                v = vars_dec[c].decode_symbol_bitwise(vars_readers[c])
                feature[i] = v
                sc = int(comp.splits_comp[v].kid_to_cluster[kid])
                threshold[i] = split_dec[v][sc].decode_symbol_bitwise(
                    split_readers[v][sc]
                )
                for ch in (left[i], right[i]):
                    depth[ch] = depth[i] + 1
                    fvar[ch] = v
            fc = int(comp.fits_comp.kid_to_cluster[kid])
            if fits_seqs is not None:
                fit[i] = fits_seqs[fc][fits_cursor[fc]]
            else:
                fit[i] = fits_dec[fc].decode_symbol_bitwise(fits_readers[fc])
            fits_cursor[fc] += 1
        yield Tree(feature, threshold, left, right, fit)


class StackedForest:
    """Decoded forest as padded (T, max_nodes) arrays ready for the batched
    traversal.  Leaves self-loop (children point at the leaf itself), so a
    fixed ``max_depth`` level loop needs no active mask; ``feature`` and
    ``threshold`` are clamped to >= 0 (their value at a self-looping leaf is
    irrelevant to routing)."""

    __slots__ = ("feature", "threshold", "left", "right", "fit", "max_depth")

    def __init__(self, trees: list[Tree], max_depth: int):
        t = len(trees)
        m = max(tr.n_nodes for tr in trees)
        self.max_depth = max_depth
        self.feature = np.zeros((t, m), dtype=np.int32)
        self.threshold = np.zeros((t, m), dtype=np.int32)
        self.left = np.zeros((t, m), dtype=np.int32)
        self.right = np.zeros((t, m), dtype=np.int32)
        self.fit = np.zeros((t, m), dtype=np.int32)
        for k, tr in enumerate(trees):
            nn = tr.n_nodes
            leaf = tr.feature < 0
            ids = np.arange(nn, dtype=np.int32)
            self.feature[k, :nn] = np.maximum(tr.feature, 0)
            self.threshold[k, :nn] = np.maximum(tr.threshold, 0)
            self.left[k, :nn] = np.where(leaf, ids, tr.children_left)
            self.right[k, :nn] = np.where(leaf, ids, tr.children_right)
            self.fit[k, :nn] = tr.node_fit


def stacked_forest(comp: CompressedForest) -> StackedForest:
    """Decode + stack, memoized on the CompressedForest instance: a serving
    process decodes once and predicts many batches against the same bytes."""
    cached = getattr(comp, "_stacked_cache", None)
    if cached is None:
        cached = StackedForest(list(iter_trees(comp)), comp.max_depth)
        comp._stacked_cache = cached
    return cached


def _torch_leaf_fits(
    sf: StackedForest, x_binned: np.ndarray, device: torch.device
) -> np.ndarray:
    """The batched traversal as torch gathers on ``device``: (T, N) leaf
    ``node_fit`` per (tree, observation).  ``idx`` is updated in place
    level by level instead of building a new array per level."""
    def up(a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, dtype=torch.int64, device=device)

    feat, thr, lft, rgt, fit = (
        up(a) for a in (sf.feature, sf.threshold, sf.left, sf.right, sf.fit)
    )
    xb_t = up(np.ascontiguousarray(x_binned.T))  # (d, N)
    t, n = feat.shape[0], x_binned.shape[0]
    idx = torch.zeros((t, n), dtype=torch.int64, device=device)
    for _ in range(sf.max_depth):
        fe = torch.gather(feat, 1, idx)
        xv = torch.gather(xb_t, 0, fe)  # xb_t[fe[t, j], j]
        go_left = xv <= torch.gather(thr, 1, idx)
        idx.copy_(
            torch.where(
                go_left, torch.gather(lft, 1, idx), torch.gather(rgt, 1, idx)
            )
        )
    return torch.gather(fit, 1, idx).cpu().numpy()


def _batched_leaf_fits(
    sf: StackedForest, x_binned: np.ndarray, device: torch.device
) -> np.ndarray:
    """(T, N) leaf ``node_fit`` per (tree, observation): one traversal over
    ALL trees at once — the level loop runs max-depth times, not
    n_trees * depth times.  Routing is all-integer, so the result is
    bit-exact regardless of backend (torch gathers on a CUDA device, numpy
    gathers on the CPU)."""
    x_binned = np.ascontiguousarray(x_binned, dtype=np.int32)
    if device.type != "cpu":
        return _torch_leaf_fits(sf, x_binned, device)
    xb_t = np.ascontiguousarray(x_binned.T)
    cols = np.arange(x_binned.shape[0])[None, :]
    idx = np.zeros((sf.feature.shape[0], x_binned.shape[0]), dtype=np.int32)
    for _ in range(sf.max_depth):
        fe = np.take_along_axis(sf.feature, idx, axis=1)
        go_left = xb_t[fe, cols] <= np.take_along_axis(sf.threshold, idx, axis=1)
        idx = np.where(
            go_left,
            np.take_along_axis(sf.left, idx, axis=1),
            np.take_along_axis(sf.right, idx, axis=1),
        )
    return np.take_along_axis(sf.fit, idx, axis=1)


def predict_compressed(
    comp: CompressedForest,
    x_binned: np.ndarray,
    engine: str = "table",
    device: str | torch.device = "cuda",
) -> np.ndarray:
    """Ensemble prediction for binned observations ``x_binned`` (n, d),
    decoding directly from the compressed representation.

    ``device`` is where the ``"table"`` engine's batched traversal runs
    (default ``"cuda"``; ``"cpu"`` takes the numpy gathers).  The bitwise
    engine is host-only.

    Returns (n,) float predictions: mean of fit values (regression) or
    majority vote (classification).  Integer traversal and per-tree
    accumulation order are identical to the original node-at-a-time
    implementation, so outputs are bit-exact across engines."""
    meta = comp.meta
    n = x_binned.shape[0]
    if engine == "table":
        leaf_fits = _batched_leaf_fits(
            stacked_forest(comp), x_binned, resolve_device(device)
        )
        if meta.task == "classification":
            bc = np.bincount(
                ((np.arange(n) * meta.n_classes)[None, :] + leaf_fits).ravel(),
                minlength=n * meta.n_classes,
            )
            votes = bc.reshape(n, meta.n_classes)
            return votes.argmax(axis=1).astype(np.float64)
        acc = np.zeros(n, dtype=np.float64)
        vals = comp.fit_values[leaf_fits]  # (T, N) float64
        for row in vals:  # sequential per-tree adds: seed accumulation order
            acc += row
        return acc / max(len(vals), 1)

    rows = np.arange(n)
    if meta.task == "classification":
        votes = np.zeros((n, meta.n_classes), dtype=np.int64)
    else:
        acc = np.zeros(n, dtype=np.float64)
    n_trees = 0
    for tree in iter_trees(comp, engine=engine):
        idx = np.zeros(n, dtype=np.int64)
        # vectorized traversal: all observations step down together
        while True:
            feat = tree.feature[idx]
            active = feat >= 0
            if not active.any():
                break
            f = np.maximum(feat, 0)
            go_left = x_binned[rows, f] <= tree.threshold[idx]
            nxt = np.where(go_left, tree.children_left[idx], tree.children_right[idx])
            idx = np.where(active, nxt, idx)
        leaf_fit = tree.node_fit[idx]
        if meta.task == "classification":
            votes[rows, leaf_fit.astype(np.int64)] += 1
        else:
            acc += comp.fit_values[leaf_fit.astype(np.int64)]
        n_trees += 1
    if meta.task == "classification":
        return votes.argmax(axis=1).astype(np.float64)
    return acc / max(n_trees, 1)
