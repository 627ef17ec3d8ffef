"""Compare two forests grown from the same rows and the same draws.

Float32 split gains computed in another summation order (another
package, or atomics on a card) can resolve a near-tie between two
candidate splits the other way; from that node down the two trees
differ.  ``first_divergence`` finds, per tree, the first heap node (level
order, so every ancestor agrees) whose split differs, and recomputes both
candidate splits' gains in float64 from the rows that reach it.  A
divergence is a tie flip when the two gains agree to float32 precision.
"""
from __future__ import annotations

import numpy as np


def _gain(xb, y_enc, w, feature: int, threshold: int, internal: bool,
          task: str) -> float:
    """Float64 impurity gain of splitting these rows at (feature,
    threshold); 0 for a leaf.  Regression scores column 0 of ``y_enc``
    (the SSE reduction), classification every column (Gini)."""
    if not internal:
        return 0.0
    cols = y_enc[:, :1] if task == "regression" else y_enc
    wy = w[:, None] * cols
    left = xb[:, feature] <= threshold
    n, s = w.sum(), wy.sum(0)
    nl, sl = w[left].sum(), wy[left].sum(0)
    nr, sr = n - nl, s - sl
    return float(
        (sl**2).sum() / max(nl, 1e-9) + (sr**2).sum() / max(nr, 1e-9)
        - (s**2).sum() / max(n, 1e-9)
    )


def first_divergence(a, b, tree: int, xb, y_enc, w) -> dict | None:
    """For tree ``tree`` of ForestModels ``a`` and ``b`` grown on binned
    rows ``xb`` (n, d) with targets ``y_enc`` (n, C) and that tree's
    bootstrap weights ``w`` (n,): None if the splits agree everywhere,
    else ``{"node", "gain_a", "gain_b", "rel_gap"}`` at the first heap node
    where feature, threshold or is_internal differ."""
    fa, ta, ia = a.feature[tree], a.threshold[tree], a.is_internal[tree]
    fb, tb, ib = b.feature[tree], b.threshold[tree], b.is_internal[tree]
    diff = np.nonzero((fa != fb) | (ta != tb) | (ia != ib))[0]
    if not len(diff):
        return None
    node = int(diff[0])
    xb = np.asarray(xb)
    idx = np.zeros(len(xb), np.int64)
    rows = np.arange(len(xb))
    for _ in range(int(np.log2(node + 1))):  # the node's level
        go_left = xb[rows, np.clip(fa[idx], 0, None)] <= ta[idx]
        idx = np.where(ia[idx], np.where(go_left, 2 * idx + 1, 2 * idx + 2), idx)
    here = idx == node
    args = (
        xb[here], np.asarray(y_enc, np.float64)[here],
        np.asarray(w, np.float64)[here],
    )
    task = a.cfg.task
    ga = _gain(*args, int(fa[node]), int(ta[node]), bool(ia[node]), task)
    gb = _gain(*args, int(fb[node]), int(tb[node]), bool(ib[node]), task)
    scale = max(abs(ga), abs(gb))
    return {
        "node": node, "gain_a": ga, "gain_b": gb,
        "rel_gap": abs(ga - gb) / scale if scale > 0 else 0.0,
    }
