"""Histogram CART in PyTorch — the port of ``repro.forest.cart``:
level-wise growth over fixed-shape heap arrays, for a batch of trees at
once on an explicit device.

Every tree is a perfect-heap layout of ``2^(max_depth+1) - 1`` slots:
node ``i`` has children ``2i+1`` / ``2i+2``.  Growth is level-synchronous:
per level, one histogram over the flattened ``(trees, nodes * d * B)``
grid (``index_add_``), cumulative sums along the bins, Gini (classification)
or variance (regression) gains, the per-node ``mtry`` feature mask, and one
``argmax`` per node.  Splits are chosen over pre-binned feature values,
``mtry`` features are drawn per NODE as in Breiman's random forest, and
bootstrap resampling is expressed as integer sample weights — the
reference's semantics, operation for operation in float32.

The reference draws each level's feature-subsampling uniforms inside the
tree with its PRNG key; here the caller passes them (``node_scores``), so
a test can feed both packages the same draws.

Sums: classification statistics are integer-valued and exact in any
order, so they accumulate with ``index_add_``.  Regression sums of
``w * y`` and ``w * y^2`` are float32, where the order of the adds
shows in the last bits; ``fixed_order_sums`` adds each histogram bin's
values in ascending order of value, so the sums depend only on which
values fall in which bin — not on the order of the rows, nor on the
order atomics would land in on a card — and one seed grows one forest
from call to call on every device.  The card and the CPU still add the
partials of other steps (cumulative sums along the bins) in their own
orders, so a card-grown tree can part from a CPU-grown one at a
near-tied split (``tests/test_torch_forest.py`` and ``chip_smoke.py``
bound the gain gap at such nodes).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

_NEG = -1e30


def fixed_order_sums(idx: torch.Tensor, vals: torch.Tensor,
                     size: int) -> torch.Tensor:
    """``out[i]`` = the sum of the float32 ``vals`` whose ``idx`` is ``i``
    (``size`` bins), each bin's values added in ascending order of value.

    One sort of 64-bit keys (bin in the high word, the value's bits in
    an order-preserving form in the low word) puts every bin's values in
    that order; equal keys are equal values, so the order is fixed by the
    multiset of (bin, value) pairs alone.  ``segment_reduce`` then adds
    each run of one bin in a fixed pattern: the sums are the same bits
    whatever the order of the inputs, from call to call."""
    if size >= 1 << 31:
        raise ValueError(f"{size} histogram bins do not fit the sort key")
    bits = vals.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    # negative floats reverse their order; positive ones sort above them
    ordered = torch.where(
        bits >= 0x80000000, bits ^ 0xFFFFFFFF, bits | 0x80000000
    )
    key, perm = torch.sort((idx << 32) | ordered)
    bins, counts = torch.unique_consecutive(key >> 32, return_counts=True)
    out = torch.zeros(size, dtype=vals.dtype, device=vals.device)
    out[bins] = torch.segment_reduce(vals[perm], "sum", lengths=counts)
    return out


def _regression_hist(stats, active, base, col, size: int) -> torch.Tensor:
    """(size, 3) histogram of ``[w, w * y, w * y^2]`` over the rows that
    are active at this level and drawn (w > 0; the others add zeros).
    The counts are integers, exact in any order; the float sums go
    through ``fixed_order_sums``."""
    s, n, k = stats.shape
    d = col.shape[1]
    keep = torch.nonzero((active & (stats[..., 0] > 0)).reshape(-1))[:, 0]
    idx = (base.reshape(-1)[keep][:, None] + col[keep % n]).reshape(-1)
    src = stats.reshape(s * n, k)[keep].repeat_interleave(d, dim=0)
    counts = torch.zeros(size, dtype=stats.dtype, device=stats.device)
    counts.index_add_(0, idx, src[:, 0])
    sums = [fixed_order_sums(idx, src[:, j], size) for j in range(1, k)]
    return torch.stack([counts, *sums], -1)


@dataclass(frozen=True)
class CartConfig:
    n_features: int
    n_bins: int  # max bins over features (histogram width)
    max_depth: int = 8
    mtry: int = 0  # 0 => d/3 (reg) or sqrt(d) (cls), set in forest.py
    min_samples_leaf: int = 1
    task: str = "classification"  # or "regression"
    n_classes: int = 2

    @property
    def n_heap(self) -> int:
        return (1 << (self.max_depth + 1)) - 1


def grow_tree(
    xb: torch.Tensor,
    y_enc: torch.Tensor,
    w: torch.Tensor,
    node_scores: torch.Tensor,
    cfg: CartConfig,
):
    """Grow one tree, or a batch of S trees on the same rows.

    xb:          (n, d) integer bin ids
    y_enc:       (n, C) float32 — one-hot classes, or [y, y^2] for regression
    w:           (n,) or (S, n) float32 bootstrap weights (integer counts)
    node_scores: (H, d) or (S, H, d) float32 uniforms for the per-node
                 feature draw; row ``i`` is heap node ``i``'s draw, so level
                 ``l`` reads rows ``[2^l - 1, 2^(l+1) - 1)``

    All tensors lie on one device, where the tree grows.  Returns heap
    arrays (with a leading S axis when ``w`` has one):
      feature     (H,) int32   split feature, -1 where leaf/dead
      threshold   (H,) int32   split bin (go left iff bin <= threshold)
      node_fit    (H, C) float32  per-node fitted value/class scores
      is_internal (H,) bool
      node_count  (H,) float32  (diagnostics / min-leaf accounting)
    """
    single = w.dim() == 1
    if single:
        w, node_scores = w[None], node_scores[None]
    s, n = w.shape
    d, b = cfg.n_features, cfg.n_bins
    c = y_enc.shape[1]
    h = cfg.n_heap
    if tuple(node_scores.shape) != (s, h, d):
        raise ValueError(
            f"node_scores has shape {tuple(node_scores.shape)}, expected "
            f"{(s, h, d)}"
        )
    dev = xb.device
    f32 = torch.float32

    feature = torch.full((s, h), -1, dtype=torch.int32, device=dev)
    threshold = torch.full((s, h), -1, dtype=torch.int32, device=dev)
    node_fit = torch.zeros((s, h, c), dtype=f32, device=dev)
    is_internal = torch.zeros((s, h), dtype=torch.bool, device=dev)
    node_count = torch.zeros((s, h), dtype=f32, device=dev)

    # per-sample state: current heap position; -2 once settled in a leaf
    pos = torch.zeros((s, n), dtype=torch.int64, device=dev)
    xb = xb.long()
    # per-sample statistics [w, w * y_enc] share one scatter
    stats = torch.cat([w[..., None], w[..., None] * y_enc[None]], -1)
    col = torch.arange(d, device=dev)[None, :] * b + xb  # (n, d)
    tree_ids = torch.arange(s, device=dev)[:, None]
    rows = torch.arange(n, device=dev)[None, :]
    mtry = max(cfg.mtry, 1)

    for level in range(cfg.max_depth + 1):
        lo = (1 << level) - 1
        n_nodes = 1 << level
        rel = pos - lo
        active = (rel >= 0) & (rel < n_nodes)
        relc = rel.clamp(0, n_nodes - 1)

        # ---- histograms: (S, n_nodes, d, B) counts and (.., C) sums -------
        base = (tree_ids * n_nodes + relc) * (d * b)  # (S, n)
        size = s * n_nodes * d * b
        if cfg.task == "regression":
            hist = _regression_hist(stats, active, base, col, size)
        else:  # integer counts: exact in any order
            idx = (base[:, :, None] + col[None]).reshape(-1)
            src = torch.where(active[..., None], stats, 0.0)
            src = src[:, :, None, :].expand(s, n, d, 1 + c).reshape(-1, 1 + c)
            hist = torch.zeros((size, 1 + c), dtype=f32, device=dev)
            hist.index_add_(0, idx, src)
            del idx, src
        hist = hist.reshape(s, n_nodes, d, b, 1 + c)
        cnt, ysum = hist[..., 0], hist[..., 1:]

        # ---- node totals & fits -------------------------------------------
        cnt_node = cnt[:, :, 0, :].sum(-1)  # (S, n_nodes)
        ysum_node = ysum[:, :, 0].sum(-2)  # (S, n_nodes, C)
        fit = ysum_node / cnt_node.clamp(min=1.0)[..., None]

        # ---- split scores -------------------------------------------------
        cl = cnt.cumsum(-1)  # (S, n_nodes, d, B) left count at bin <= t
        yl = ysum.cumsum(-2)  # (S, n_nodes, d, B, C)
        cr = cnt_node[..., None, None] - cl
        yr = ysum_node[:, :, None, None, :] - yl
        if cfg.task == "regression":
            # y_enc = [y, y^2]; gain = SSE reduction
            s1l, s1r = yl[..., 0], yr[..., 0]
            score = s1l**2 / cl.clamp(min=1e-9) + s1r**2 / cr.clamp(min=1e-9)
            parent = ysum_node[..., 0] ** 2 / cnt_node.clamp(min=1e-9)
        else:
            # Gini gain ∝ sum_c nLc^2/nL + nRc^2/nR - nc^2/n
            score = (yl**2).sum(-1) / cl.clamp(min=1e-9) + (yr**2).sum(
                -1
            ) / cr.clamp(min=1e-9)
            parent = (ysum_node**2).sum(-1) / cnt_node.clamp(min=1e-9)
        gain = score - parent[..., None, None]  # (S, n_nodes, d, B)
        del yl, yr, score

        valid = (cl >= cfg.min_samples_leaf) & (cr >= cfg.min_samples_leaf)
        # per-node mtry feature draw: the mtry smallest uniforms (stable
        # order, as the reference's double argsort ranks them)
        order = torch.argsort(
            node_scores[:, lo:lo + n_nodes], dim=-1, stable=True
        )
        fmask = torch.zeros((s, n_nodes, d), dtype=torch.bool, device=dev)
        fmask.scatter_(-1, order[..., :mtry], True)
        gain = torch.where(valid & fmask[..., None], gain, _NEG)

        flat = gain.reshape(s, n_nodes, d * b)
        best = flat.argmax(-1)  # first maximum, as jnp.argmax
        best_gain = flat.gather(-1, best[..., None])[..., 0]
        best_f = (best // b).to(torch.int32)
        best_t = (best % b).to(torch.int32)
        del gain, flat, cl, cr, valid

        can_split = (
            (best_gain > 1e-7)
            & (cnt_node >= 2 * cfg.min_samples_leaf)
            & (level < cfg.max_depth)
        )

        sl = slice(lo, lo + n_nodes)
        feature[:, sl] = torch.where(can_split, best_f, -1)
        threshold[:, sl] = torch.where(can_split, best_t, -1)
        node_fit[:, sl] = fit
        is_internal[:, sl] = can_split & (cnt_node > 0)
        node_count[:, sl] = cnt_node

        # ---- route samples ------------------------------------------------
        nf = best_f.gather(1, relc).long().clamp(0, d - 1)
        nt = best_t.gather(1, relc)
        split_here = can_split.gather(1, relc) & active
        go_left = xb[rows, nf] <= nt
        child = torch.where(go_left, 2 * pos + 1, 2 * pos + 2)
        pos = torch.where(split_here, child, torch.where(active, -2, pos))

    out = (feature, threshold, node_fit, is_internal, node_count)
    return tuple(a[0] for a in out) if single else out


def heap_children(h: int):
    """Left and right child slots of every slot of an ``h``-slot heap
    (-1 past the end), as host int arrays."""
    i = np.arange(h)
    left = 2 * i + 1
    right = 2 * i + 2
    left[left >= h] = -1
    right[right >= h] = -1
    return left, right
