"""Conditional empirical-model extraction (Algorithm 1, lines 4-21).

Model keys follow the paper's relaxation (§3.2.2): a node's model depends
only on its DEPTH and its FATHER'S VARIABLE NAME; split-value models
additionally condition on the node's own variable (and are clustered
per-variable, Algorithm 1 line 39).

Key id layout: ``kid = depth * (d + 1) + (father_var + 1)`` with
``father_var = -1`` for roots, so the model space has ``T * (d+1)`` slots
(the paper's d*T up to the root convention).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .tree import Forest, Tree


def key_id(depth: np.ndarray, father_var: np.ndarray, d: int) -> np.ndarray:
    return depth.astype(np.int64) * (d + 1) + (father_var.astype(np.int64) + 1)


@dataclass
class NodeRecords:
    """Flat per-node records over the whole forest, in global preorder
    (tree 0 nodes in preorder, then tree 1, ...) — the canonical symbol
    emission order for every stream."""

    tree_id: np.ndarray
    depth: np.ndarray
    father_var: np.ndarray  # -1 at roots
    var: np.ndarray  # -1 at leaves
    split: np.ndarray  # -1 at leaves
    fit: np.ndarray
    is_leaf: np.ndarray


def extract_records(forest: Forest) -> NodeRecords:
    ts, ds, fs, vs, sp, ft, lf = [], [], [], [], [], [], []
    for ti, tree in enumerate(forest.trees):
        depth = tree.depths()
        parent = tree.parents()
        fvar = np.where(parent >= 0, tree.feature[np.maximum(parent, 0)], -1)
        ts.append(np.full(tree.n_nodes, ti, dtype=np.int32))
        ds.append(depth)
        fs.append(fvar.astype(np.int32))
        vs.append(tree.feature)
        sp.append(tree.threshold)
        ft.append(tree.node_fit)
        lf.append(tree.is_leaf)
    return NodeRecords(
        tree_id=np.concatenate(ts),
        depth=np.concatenate(ds),
        father_var=np.concatenate(fs),
        var=np.concatenate(vs),
        split=np.concatenate(sp),
        fit=np.concatenate(ft),
        is_leaf=np.concatenate(lf),
    )


def var_name_counts(rec: NodeRecords, d: int, t_max: int) -> np.ndarray:
    """(T*(d+1), d+1) counts of P_vn = P(var | depth, father's var).

    Column d is the LEAF symbol: the Zaks sequence already distinguishes
    leaves, so leaves are NOT coded in the vars stream — but internal nodes
    are, with alphabet exactly the d variables. We therefore only count
    internal nodes, over alphabet d.
    """
    mask = ~rec.is_leaf
    kid = key_id(rec.depth[mask], rec.father_var[mask], d)
    sym = rec.var[mask].astype(np.int64)
    counts = np.zeros((t_max * (d + 1), d), dtype=np.int64)
    np.add.at(counts, (kid, sym), 1)
    return counts


def split_counts(rec: NodeRecords, d: int, t_max: int, n_bins: np.ndarray):
    """Per-variable dict: var -> (T*(d+1), B_v) counts of
    P_sv = P(split value | depth, var, father's var)."""
    out = {}
    for v in range(d):
        mask = (~rec.is_leaf) & (rec.var == v)
        if not mask.any():
            continue
        kid = key_id(rec.depth[mask], rec.father_var[mask], d)
        sym = rec.split[mask].astype(np.int64)
        counts = np.zeros((t_max * (d + 1), int(n_bins[v])), dtype=np.int64)
        np.add.at(counts, (kid, sym), 1)
        out[v] = counts
    return out


def fit_counts(rec: NodeRecords, d: int, t_max: int, n_fit_symbols: int):
    """(T*(d+1), n_fit_symbols) counts of P(fit | depth, father's var).
    Every node (internal AND leaf) carries a fit (§3.3)."""
    kid = key_id(rec.depth, rec.father_var, d)
    sym = rec.fit.astype(np.int64)
    counts = np.zeros((t_max * (d + 1), n_fit_symbols), dtype=np.int64)
    np.add.at(counts, (kid, sym), 1)
    return counts


def alpha_vars(d: int) -> float:
    """Paper: alpha = log2(d) + d for variable-name dictionaries."""
    return float(np.log2(max(d, 2)) + d)


def alpha_splits(meta_numeric: bool, n_train: int, c_v: int) -> float:
    """Numeric: log2(n) + C (split is an index into observed values);
    categorical: log2(C) + C."""
    if meta_numeric:
        return float(np.log2(max(n_train, 2)) + c_v)
    return float(np.log2(max(c_v, 2)) + c_v)


def alpha_fits(task: str, n_fit_symbols: int) -> float:
    """Classification: log2(#classes) + #classes.  Regression: each
    dictionary line carries a 64-bit value (paper's orthodox losslessness)
    plus the symbol id."""
    if task == "classification":
        return float(np.log2(max(n_fit_symbols, 2)) + n_fit_symbols)
    return float(64.0 + np.log2(max(n_fit_symbols, 2)))
