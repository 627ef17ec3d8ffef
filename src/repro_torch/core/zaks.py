"""Zaks sequences for tree structure (paper §3.1, after Zaks 1980).

Preorder walk; internal node -> 1, leaf -> 0.  For a tree with n internal
nodes the sequence has length 2n+1 and is uniquely decodable.  Validity
(paper conditions i-iii): starts with 1 (unless the tree is a single leaf),
#0 = #1 + 1, and no proper prefix satisfies that property.
"""
from __future__ import annotations

import numpy as np

from .tree import Tree


def zaks_encode(tree: Tree) -> np.ndarray:
    """Preorder 1/0 labels. Assumes ``tree`` is stored in preorder."""
    return (~tree.is_leaf).astype(np.uint8)


def zaks_is_valid(bits: np.ndarray) -> bool:
    bits = np.asarray(bits, dtype=np.int64)
    if len(bits) == 0 or len(bits) % 2 == 0:
        return False
    # running excess of 0s over 1s must first hit +1 exactly at the end
    excess = np.cumsum(1 - 2 * bits)
    return bool(excess[-1] == 1 and (excess[:-1] < 1).all())


def zaks_decode(bits: np.ndarray):
    """Rebuild preorder structure arrays from a Zaks sequence (vectorized).

    Returns ``(children_left, children_right, is_leaf)`` with -1 for absent
    children; node ids are preorder positions (matching :func:`zaks_encode`).

    In preorder, an internal node ``i``'s left child is ``i + 1`` and its
    right child follows the left subtree.  With the running excess
    ``c = cumsum(+1 for leaf, -1 for internal)``, the subtree rooted at ``j``
    ends at the first ``k >= j`` with ``c[k] == c[j-1] + 1`` (the excess walks
    in +-1 steps, so the first time it reaches that level is the subtree
    boundary).  All boundaries are found at once with one lexicographic
    searchsorted over ``(c, position)`` keys — no per-node Python loop.
    """
    bits = np.asarray(bits, dtype=np.uint8)
    n = len(bits)
    if not zaks_is_valid(bits):
        raise ValueError("invalid Zaks sequence")
    left = np.full(n, -1, dtype=np.int32)
    right = np.full(n, -1, dtype=np.int32)
    internal = np.flatnonzero(bits)
    if internal.size:
        c = np.cumsum(1 - 2 * bits.astype(np.int64))
        left[internal] = internal + 1
        shift = n + 2  # make every key component positive
        keys = np.sort((c + shift) * (n + 1) + np.arange(n))
        want = (c[internal] + 1 + shift) * (n + 1) + (internal + 1)
        p = np.searchsorted(keys, want, side="left")
        ends = keys[p] % (n + 1)  # end of each left subtree
        right[internal] = ends + 1
    return left, right, bits == 0


def zaks_decode_reference(bits: np.ndarray):
    """Original stack-based parse (differential oracle for the vectorized
    :func:`zaks_decode`; also the seed-faithful benchmark baseline)."""
    bits = np.asarray(bits, dtype=np.uint8)
    n = len(bits)
    left = np.full(n, -1, dtype=np.int32)
    right = np.full(n, -1, dtype=np.int32)

    # iterative parse (trees can be deep): explicit stack of pending slots
    pos = 0
    stack: list[tuple[int, int]] = []  # (parent id, 0=left pending/1=right)
    root = 0
    first = True
    while pos < n:
        me = pos
        is_internal = bits[pos]
        pos += 1
        if first:
            first = False
            root = me
        else:
            parent, side = stack.pop()
            if side == 0:
                left[parent] = me
            else:
                right[parent] = me
        if is_internal:
            stack.append((me, 1))  # right parsed after the whole left subtree
            stack.append((me, 0))
    if stack or root != 0:
        raise ValueError("invalid Zaks sequence")
    return left, right, bits == 0


def split_concatenated(bits: np.ndarray, lengths: np.ndarray) -> list[np.ndarray]:
    out = []
    off = 0
    for L in lengths:
        out.append(bits[off : off + int(L)])
        off += int(L)
    return out
