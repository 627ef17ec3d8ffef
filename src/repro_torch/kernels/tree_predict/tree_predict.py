"""Batched random-forest inference — the port of
``repro.kernels.tree_predict.tree_predict``: the segmented serving engines
(K1, K2) and the whole-forest entries (K3, K4).

Layout: trees in heap form (node i -> children 2i+1 / 2i+2), so traversal
is pure arithmetic + indexed loads, no pointers.  Trees and observations
carry int32 segment (user) ids, and a (tree, obs) pair contributes only
when the ids match: many users' forests pack into ONE tree axis and one
launch serves a mixed batch.  Per row the result is the (N, C) vote
counts (classification) or the (N,) fit sum (regression).

Two segmented engines, as in the reference (``engine=`` on the wrapper):

* ``"pipelined"`` — K1, ``forest_predict_agg_segmented_packed``: fused
  node attributes (``(feature * TB + threshold) * 2 + is_internal`` as one
  float32 code word, exact below 2**24) and per-row-block chunk ranges
  (``segment_chunk_ranges``) so a row block walks only the tree chunks
  whose segments it shares;
* ``"simple"`` — K2, the unfused oracle over separate feature / threshold
  / is_internal tables, every tree chunk, masking ``tree_id < T`` as well.

K5, the sharded engine (``ops.forest_predict_agg_segmented_sharded``),
has no kernel of its own: K1 per tree shard on each device of a list,
then the shards' partials summed in shard order (``_launch_seg_sharded``,
plain version ``_seg_sharded_plain``).

Two whole-forest entries, no segments:

* ``forest_predict_agg`` — K3: per row the (N, C) votes or (N,) fit sum
  over every tree (``ops.predict_forest_kernel``);
* ``forest_predict`` — K4: the unaggregated (T, N) leaf fit of every
  (tree, row) pair (``ops.predict_forest_kernel_per_tree``).

On the card K3 and K4 first complete each heap (``_pack_records_plain``
is the plain twin of that prologue): a node below a leaf copies the
leaf's fit, so every walk takes the same ``_walk_depth`` levels without
a stop test (``_walk_records_plain``), reading one word a level — 4
bytes (``NARROW``) where ``d <= 2**15`` and every ``|threshold| <
2**15``, else 8 (``WIDE``), the form chosen from the maxima the 2**24
guard reads (``_record_form``) — and one fit where it ends.  Their
tiling and work partition come from the library (``forest_config``;
plain twin ``_forest_config``, CTA by CTA ``_forest_work``).

K1 and K2 share one kernel on the card: a CTA holds a few rows of one
row block and walks many slices of the block's chunk range at once (8
trees a thread), keeping the slices whose trees' segments fall in its
rows' segment range; each walk takes ``min(max_depth, h.bit_length())``
uniform levels (``_walk_stay_put_plain``), K1's word decoded by shift and
mask (``_decode_plain``); sums are folded in (chunk, tree) order, so they
equal the plain versions bit for bit.  The tiling comes from the library
(``seg_config``; plain twin ``_seg_config``, CTA by CTA ``_seg_work``).

Every kernel reads a heap index at or past the heap width ``H`` (a
``max_depth`` deeper than the heap) as feature 0, threshold 0, not
internal, fit 0 — what the Pallas kernels read from their zero-padded
heaps — and so do the plain versions.  The ``ref`` twins clamp instead,
as the reference's jnp oracles do.

Dispatch is by the tensors' device.  An entry takes numpy arrays or
tensors; the device of its tensor arguments (which must agree, and at
least one must be a tensor) selects the path, and numpy arguments move
there.  On the CPU the entry runs the kernel's plain PyTorch version
(``_seg_packed_plain``, ``_seg_simple_plain``, ``_seg_sharded_plain``,
``_agg_plain_unseg``, ``_per_tree_plain``).  On a CUDA device it launches
the hand-written Hopper kernel in ``csrc/tree_predict.cu`` or raises — it
never falls back to the plain version.  ``LAUNCHES`` counts the CUDA launches of each kernel, so a run
can show that it went through them.  The reference's ``interpret=``
keyword has no meaning here and is dropped.

Precision guard: the reference routes node attributes through float32
one-hot contractions, exact only below 2**24; the port keeps its
``ValueError``s at the same boundary (``_validate_f32_exact``) so both
packages accept and refuse the same inputs, although an indexed load
would not need the guard.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .ref import _one_hot_votes

_F32_EXACT_INT = 1 << 24  # float32 has a 24-bit significand

#: Largest dynamic shared memory a CTA may use on Hopper (227 KB).
_MAX_SMEM_BYTES = 232448

#: CUDA launches of each kernel since the last reset.
LAUNCHES = {
    "seg_packed": 0, "seg_simple": 0, "agg": 0, "per_tree": 0,
    "seg_sharded": 0,
}

_P = ctypes.c_void_p
_I = ctypes.c_int
_IP = ctypes.POINTER(_I)
_SIGNATURES = {
    "tp_seg_packed": ([_P] * 8 + [_I] * 9 + [_P], _I),
    "tp_seg_simple": ([_P] * 8 + [_I] * 8 + [_P], _I),
    "tp_agg": ([_P] * 8 + [_I] * 8 + [_P], _I),
    "tp_per_tree": ([_P] * 7 + [_I] * 7 + [_P], _I),
    "tp_forest_config": ([_I] * 9 + [_IP], _I),
    "tp_seg_config": ([_I] * 10 + [_IP], _I),
    "tp_error_string": ([_I], ctypes.c_char_p),
}

#: K3 / K4 node-word forms: 4 bytes (the int16 threshold and the clamped
#: feature) or 8 (feature, threshold); the fits lie in a float32 array
#: beside the words.
NARROW, WIDE = 0, 1
_WORD_INTS = {NARROW: 1, WIDE: 2}
_NARROW_LIMIT = 1 << 15

#: What ``forest_config`` reports, in the library's order (``ForestCfg``).
CONFIG_KEYS = (
    "form", "mode", "walks", "threads", "depth", "levels", "staged",
    "group", "n_groups", "x_smem", "dpad", "smem", "resident", "splits",
    "rows_per_split", "splits_last", "rows_last", "grid", "partials",
)
#: ``mode`` values: K4, K3 votes in registers (C <= 8), K3 votes by integer
#: atomics (C > 8), K3 sums.
PER_TREE, VOTES, VOTE_ATOMIC, SUM = 0, 1, 2, 3
#: The library's constants (``kThreads``, ``kTreeBytes``, ``kXBytes``,
#: ``kMinGroup``, ``kSumLevels``, ``kRegClasses``).
_THREADS, _TREE_BYTES, _X_BYTES = 512, 96 * 1024, 136 * 1024
_MIN_GROUP, _SUM_LEVELS, _REG_CLASSES = 8, 8, 8

#: What ``seg_config`` reports for a K1 / K2 launch, in the library's order
#: (``SegCfg``).
SEG_CONFIG_KEYS = (
    "mode", "decode", "threads", "rows", "cols", "walks", "slices", "values",
    "rounds", "depth", "levels", "staged", "x_smem", "dpad", "smem", "tiles",
    "resident", "grid",
)
#: ``mode`` values: sums folded in chunk order, votes counted in shared
#: memory, votes by integer atomics into the output (a vote table past
#: ``_SEG_COUNT_BYTES``).
SEG_SUMS, SEG_VOTES, SEG_VOTE_ATOMIC = 0, 1, 2
#: ``decode`` values: K2's separate tables; K1's code word by shift and
#: mask (``tb2`` a power of two) or by floor division.
TABLES, SHIFT, DIVIDE = 0, 1, 2
#: The library's constants (``kSegThreads``, ``kSegWalks``, ``kSegValues``,
#: ``kSegMinRows``, ``kSegMaxRows``, ``kSegXBytes``, ``kSegCountBytes``,
#: ``kSegStageBytes``, ``kSegMinLevels``, ``kSegStagedBytes``).
_SEG_THREADS, _SEG_WALKS, _SEG_VALUES = 256, 8, 8
_SEG_MIN_ROWS, _SEG_MAX_ROWS = 8, 128
_SEG_X_BYTES, _SEG_COUNT_BYTES = 48 * 1024, 32 * 1024
_SEG_STAGE_BYTES, _SEG_MIN_LEVELS, _SEG_STAGED_BYTES = 128 * 1024, 3, 8


def reset_launches() -> None:
    """Set every launch count to 0."""
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _validate_f32_exact(max_depth: int, d: int, **arrays) -> dict[str, int]:
    """Raise if a value the reference routes through the float32 one-hot
    path could exceed the exactly-representable integer range; return
    each array's largest absolute value (0 when empty), which K3 and K4
    choose their record form from.

    Host numpy arrays are checked with numpy (free); tensors are checked
    with torch, which costs a device sync on a card — hot loops (the
    pipelined serving engine) pass numpy rows so the check never blocks
    the launch."""
    h = (1 << (max_depth + 1)) - 1
    if h >= _F32_EXACT_INT:
        raise ValueError(
            f"max_depth={max_depth} gives {h} heap nodes >= 2**24; node ids "
            "would corrupt in the float32 one-hot gathers"
        )
    if d >= _F32_EXACT_INT:
        raise ValueError(f"n_features={d} >= 2**24 overflows float32 gathers")
    maxima = {}
    for name, arr in arrays.items():
        if isinstance(arr, torch.Tensor):
            top = int(torch.max(torch.abs(arr))) if arr.numel() else 0
        else:
            arr = np.asarray(arr)
            top = int(np.max(np.abs(arr))) if arr.size else 0
        if top >= _F32_EXACT_INT:
            raise ValueError(
                f"{name} contains values >= 2**24, not exactly representable "
                "in the float32 one-hot gathers"
            )
        maxima[name] = top
    return maxima


def _record_form(d: int, max_abs_threshold: int) -> int:
    """K3 / K4's record form: ``NARROW`` when the clamped feature fits 15
    bits (``d <= 2**15``) and every threshold int16 (``|threshold| <
    2**15``), else ``WIDE``."""
    if d <= _NARROW_LIMIT and max_abs_threshold < _NARROW_LIMIT:
        return NARROW
    return WIDE


# ---------------------------------------------------------------------------
# Host helpers of the pipelined engine (copied from the reference)
# ---------------------------------------------------------------------------

def fused_threshold_base(max_threshold: int) -> int:
    """``TB``: threshold field width of the fused code word, rounded up to a
    power of two so every decode divide/floor is exact in float32."""
    return 1 << max(int(max_threshold), 1).bit_length()


def fuse_node_attrs(
    feature: np.ndarray, threshold: np.ndarray, is_internal: np.ndarray,
    tb: int,
) -> np.ndarray:
    """Pack (feature, threshold, is_internal) into one float32 code table:
    ``code = (feature * TB + threshold) * 2 + is_internal``.  Requires
    non-negative fields, ``threshold < TB``, and the packed range below
    2**24 (caller-checked via ``fused_code_limit``)."""
    code = (
        np.asarray(feature, np.int64) * (2 * tb)
        + np.asarray(threshold, np.int64) * 2
        + np.asarray(is_internal, np.int64)
    )
    return code.astype(np.float32)


def fused_code_limit(d: int, tb: int) -> int:
    """Largest code word the fused packing can produce: feature d-1,
    threshold TB-1, internal 1."""
    return (d - 1) * 2 * tb + (tb - 1) * 2 + 1


def segment_chunk_ranges(
    obs_seg: np.ndarray,  # (N,) int32, any order (sorted => tight ranges)
    tree_seg: np.ndarray,  # (T_pad,) int32, -1 = padding
    block_trees: int,
    block_obs: int,
) -> tuple[np.ndarray, np.ndarray]:
    """Per observation block, the [lo, hi) range of tree chunks whose
    segment set intersects the block's — the kernel's chunk-loop bounds.

    Always CORRECT for any ordering (the in-kernel segment mask filters
    non-matching pairs); TIGHT when rows and trees are sorted by segment,
    where it recovers the block-diagonal work bound ~sum_u T_u * N_u."""
    obs_seg = np.asarray(obs_seg, np.int64)
    tree_seg = np.asarray(tree_seg, np.int64)
    n, t_pad = len(obs_seg), len(tree_seg)
    n_chunks = t_pad // block_trees
    g = max(-(-n // block_obs), 1)
    n_segs = int(max(obs_seg.max(initial=0), tree_seg.max(initial=0))) + 1
    # membership matrices via one flat scatter each; segment -1 (padding)
    # lands in the dropped 0th column
    chunk_of = np.repeat(np.arange(n_chunks), block_trees)
    seg_in_chunk = np.zeros((n_chunks, n_segs + 1), bool)
    seg_in_chunk[chunk_of, np.clip(tree_seg, -1, n_segs - 1) + 1] = True
    block_of = np.repeat(np.arange(g), block_obs)[:n]
    seg_in_block = np.zeros((g, n_segs + 1), bool)
    seg_in_block[block_of, np.clip(obs_seg, -1, n_segs - 1) + 1] = True
    need = seg_in_block[:, 1:] @ seg_in_chunk[:, 1:].T  # (g, n_chunks)
    any_ = need.any(1)
    lo = np.where(any_, need.argmax(1), 0).astype(np.int32)
    hi = np.where(
        any_, n_chunks - need[:, ::-1].argmax(1), 0
    ).astype(np.int32)
    return lo, hi


# ---------------------------------------------------------------------------
# Plain PyTorch versions of the kernels
# ---------------------------------------------------------------------------

#: Plain versions walk trees in slices of about this many (tree, row,
#: class) cells, so their (T, N) intermediates stay bounded.
_PLAIN_CELLS = 1 << 26


def _per_tree_plain(
    xb, feature, threshold, fit, is_internal, max_depth: int,
    block_trees: int = 8, block_obs: int = 256,
) -> torch.Tensor:
    """Plain version of K4: the (T, N) leaf fit of every (tree, row) pair.
    An index at or past the heap width reads feature 0, threshold 0, not
    internal and fit 0 (one zero column appended to each heap), where the
    ``ref`` twin clamps to the last slot.  The block sizes do not change
    the result; they are taken so the plain version and the launch share
    one signature."""
    n, d = xb.shape
    t, h = feature.shape

    def padded(a):
        return torch.cat([a, a.new_zeros((t, 1))], dim=1)

    feature, threshold, fit = padded(feature), padded(threshold), padded(fit)
    inter = padded(is_internal.to(torch.bool))
    xb_t = xb.T.contiguous()  # (d, N)
    idx = torch.zeros((t, n), dtype=torch.int64, device=xb.device)
    for _ in range(max_depth):
        at = idx.clamp(max=h)
        fe = torch.gather(feature, 1, at).to(torch.int64).clamp(0, d - 1)
        go_left = torch.gather(xb_t, 0, fe) <= torch.gather(threshold, 1, at)
        child = torch.where(go_left, 2 * idx + 1, 2 * idx + 2)
        idx = torch.where(torch.gather(inter, 1, at), child, idx)
    return torch.gather(fit, 1, idx.clamp(max=h))


def _agg_plain(
    xb, obs_seg, tree_seg, feature, threshold, fit, is_internal,
    max_depth: int, n_classes: int, block_trees: int, n_trees: int,
    chunk_ranges=None,
) -> torch.Tensor:
    """Masked aggregate in the kernels' own summation order: per chunk of
    ``block_trees`` trees, the masked leaves summed in tree order, then
    the chunk sums added to the row's total chunk by chunk.  Trees at or
    past ``n_trees`` never contribute (K2's and K3's ``tree_id < T``
    mask); ``obs_seg = tree_seg = None`` drops the segment mask (K3).
    ``chunk_ranges = (chunk_lo, chunk_hi, block_obs)`` limits each row
    block to its chunks, as K1 does."""
    t = feature.shape[0]
    n = xb.shape[0]
    c_out = max(n_classes, 1)
    out = torch.zeros(
        (n, n_classes) if n_classes > 0 else (n,), dtype=torch.float32,
        device=xb.device,
    )
    step = block_trees * max(1, _PLAIN_CELLS // max(block_trees * n * c_out, 1))
    for lo in range(0, t, step):
        hi = min(lo + step, t)
        leaf = _per_tree_plain(
            xb, feature[lo:hi], threshold[lo:hi], fit[lo:hi],
            is_internal[lo:hi], max_depth,
        )  # (S, N)
        ids = torch.arange(lo, hi, device=xb.device)
        valid = (ids < n_trees)[:, None].expand(hi - lo, n)
        if tree_seg is not None:
            valid = valid & (tree_seg[lo:hi, None] == obs_seg[None, :])
        if chunk_ranges is not None:
            c_lo, c_hi, bo = chunk_ranges
            block = torch.arange(n, device=xb.device) // bo
            chunk = (ids // block_trees)[:, None]
            valid = valid & (chunk >= c_lo[block][None, :]) & (
                chunk < c_hi[block][None, :]
            )
        if n_classes > 0:  # integer-valued counts: any order is exact
            out += (_one_hot_votes(leaf, n_classes) * valid[..., None]).sum(0)
            continue
        contrib = torch.where(valid, leaf, torch.zeros_like(leaf))
        pad = -(hi - lo) % block_trees
        if pad:
            contrib = torch.cat([contrib, contrib.new_zeros((pad, n))])
        chunks = contrib.reshape(-1, block_trees, n)
        sums = chunks[:, 0].clone()
        for j in range(1, block_trees):
            sums += chunks[:, j]
        for c in range(sums.shape[0]):
            out += sums[c]
    return out


def _unfuse(code: torch.Tensor, tb2: int):
    """Exact integer decode of fused code words (floor semantics)."""
    code_i = code.to(torch.int32)
    feature = torch.div(code_i, tb2, rounding_mode="floor")
    rem = code_i - feature * tb2
    return feature, torch.div(rem, 2, rounding_mode="floor"), (rem % 2) == 1


def _seg_packed_plain(
    xb, obs_seg, code, fit, tree_seg, chunk_lo, chunk_hi, max_depth: int,
    tb2: int, n_classes: int = 0, block_trees: int = 8,
    block_obs: int = 128,
) -> torch.Tensor:
    """Plain version of K1 on the same tensors: a row block sees only the
    chunks in its ``[chunk_lo, chunk_hi)`` range, as in the kernel."""
    feature, threshold, is_internal = _unfuse(code, tb2)
    return _agg_plain(
        xb, obs_seg, tree_seg, feature, threshold, fit, is_internal,
        max_depth, n_classes, block_trees, code.shape[0],
        chunk_ranges=(chunk_lo.long(), chunk_hi.long(), block_obs),
    )


def _seg_simple_plain(
    xb, obs_seg, tree_seg, feature, threshold, fit, is_internal,
    max_depth: int, n_classes: int = 0, block_trees: int = 32,
    block_obs: int = 256,
) -> torch.Tensor:
    """Plain version of K2 on the same tensors."""
    return _agg_plain(
        xb, obs_seg, tree_seg, feature, threshold, fit, is_internal,
        max_depth, n_classes, block_trees, feature.shape[0],
    )


def _agg_plain_unseg(
    xb, feature, threshold, fit, is_internal, max_depth: int,
    n_classes: int = 0, block_trees: int = 8, block_obs: int = 256,
) -> torch.Tensor:
    """Plain version of K3 on the same tensors: every tree, no segments.
    ``block_obs`` does not change the result; it is taken so the plain
    version and the launch share one signature."""
    return _agg_plain(
        xb, None, None, feature, threshold, fit, is_internal, max_depth,
        n_classes, block_trees, feature.shape[0],
    )


def _sum_shards(parts) -> torch.Tensor:
    """K5's reduction (the reference's ``psum``) in a fixed order: the
    shards' (N, C) partials summed on the first shard's device, shard 0
    first."""
    total = parts[0]
    for part in parts[1:]:
        total = total + part.to(total.device)
    return total


def _seg_sharded_plain(
    xb, obs_seg, code, fit, tree_seg, chunk_lo, chunk_hi, max_depth: int,
    tb2: int, n_classes: int = 0, block_trees: int = 8,
    block_obs: int = 128,
) -> torch.Tensor:
    """Plain version of K5: every argument but the scalars is a sequence
    with one tensor per shard (rows and their segment ids replicated
    onto each shard's device); K1's plain version per shard, then the
    same ordered sum."""
    return _sum_shards([
        _seg_packed_plain(*shard, max_depth, tb2, n_classes, block_trees,
                          block_obs)
        for shard in zip(xb, obs_seg, code, fit, tree_seg, chunk_lo,
                         chunk_hi)
    ])


def _walk_depth(h: int, max_depth: int) -> int:
    """The levels every K3 / K4 walk takes through the completed heap: to
    ``max_depth`` or to the heap's last level, whichever comes first."""
    return min(max_depth, h.bit_length() - 1)


def _leaf_stride(depth: int) -> int:
    """Per tree in K3 / K4's scratch: words of the ``2**depth - 1`` nodes
    above the last level walked and fits of its ``2**depth`` nodes, each
    padded to at least 4 (16-byte copies)."""
    return max(1 << depth, 4)


def _pack_records_plain(feature, threshold, fit, is_internal, d: int,
                        form: int, max_depth: int):
    """Plain twin of K3 / K4's prologue: the completed heap's (words, fits),
    (T, ws) each, ``ws = _leaf_stride(depth)``: the words of the nodes
    above level ``depth = _walk_depth(h, max_depth)`` and the fits of the
    nodes on it.  A node below a leaf, or below a child past the heap,
    copies that stop (word 0, the stop's fit; fit 0 past the heap); any
    other node keeps its feature (clamped to [0, d - 1]), threshold and
    fit, except that an internal node of the heap's last level has fit 0
    when ``max_depth`` reaches past the heap.  ``NARROW`` words are int32
    ``threshold << 16 | feature``, ``WIDE`` words (T, ws, 2) int32
    (feature, threshold); the padding is zero."""
    t, h = feature.shape
    lh, depth = h.bit_length(), _walk_depth(h, max_depth)
    ws, first_leaf = _leaf_stride(depth), (1 << depth) - 1
    width = 2 * first_leaf + 1  # the nodes of levels 0..depth
    dev = feature.device

    def padded(a, dtype):
        out = torch.zeros((t, max(width, h)), dtype=dtype, device=dev)
        out[:, :h] = a
        return out[:, :width]

    inter = padded(is_internal.to(torch.bool), torch.bool)
    fit_p = padded(fit.to(torch.float32), torch.float32)
    # the shallowest strict ancestor where a walk stops (-1: none), level
    # by level from the root; a node past the heap is no internal node
    stop = torch.full((t, width), -1, dtype=torch.int64, device=dev)
    for lv in range(1, depth + 1):
        js = torch.arange((1 << lv) - 1, (1 << (lv + 1)) - 1, device=dev)
        ps = (js - 1) // 2
        here = torch.where(inter[:, ps], -1, ps.expand(t, -1))
        stop[:, js] = torch.where(stop[:, ps] >= 0, stop[:, ps], here)
    copy = stop >= 0
    leaves = slice(first_leaf, width)
    cut = inter[:, leaves] & (depth == lh - 1) & (max_depth >= lh)
    fits = torch.zeros((t, ws), dtype=torch.float32, device=dev)
    fits[:, :first_leaf + 1] = torch.where(
        copy[:, leaves], torch.gather(fit_p, 1, stop[:, leaves].clamp(min=0)),
        torch.where(cut, 0.0, fit_p[:, leaves]))
    above = slice(0, first_leaf)
    feat = padded(feature.to(torch.int64).clamp(0, d - 1), torch.int64)
    thr = padded(threshold.to(torch.int64), torch.int64)
    feat = feat[:, above].masked_fill(copy[:, above], 0)
    thr = thr[:, above].masked_fill(copy[:, above], 0)
    if form == NARROW:  # int64 -> int32 wraps: the threshold's sign bit
        word = (((thr & 0xFFFF) << 16) | feat).to(torch.int32)
        words = torch.zeros((t, ws), dtype=torch.int32, device=dev)
    else:
        word = torch.stack([feat, thr], dim=-1).to(torch.int32)
        words = torch.zeros((t, ws, 2), dtype=torch.int32, device=dev)
    words[:, :first_leaf] = word
    return words, fits


def _unpack_records_plain(words: torch.Tensor, form: int):
    """(feature, threshold) of packed words, decoded as the kernel decodes
    them."""
    if form == NARROW:
        return words & 0xFFFF, words >> 16
    return words[..., 0], words[..., 1]


def _walk_records_plain(xb, words, fits, form: int, h: int,
                        max_depth: int) -> torch.Tensor:
    """The (T, N) leaves of K3 / K4's walk over a completed heap:
    ``_walk_depth(h, max_depth)`` uniform levels, one word each, no clamp
    and no stop; the answer is the fit of the node where the walk ends."""
    feature, threshold = _unpack_records_plain(words, form)
    t, n = feature.shape[0], xb.shape[0]
    depth = _walk_depth(h, max_depth)
    xb_t = xb.T.contiguous()
    idx = torch.zeros((t, n), dtype=torch.int64, device=xb.device)
    for _ in range(depth):
        go_right = (torch.gather(xb_t, 0, torch.gather(feature, 1, idx).long())
                    > torch.gather(threshold, 1, idx))
        idx = 2 * idx + 1 + go_right.long()
    return torch.gather(fits, 1, idx - ((1 << depth) - 1))


def _round_up(a: int, b: int) -> int:
    return -(-a // b) * b


def _staged_words(levels: int) -> int:
    """Words a K3 / K4 CTA stages per tree for ``levels`` staged levels
    (at most the walk's depth): the top ``2**levels - 1`` nodes as a power
    of two of at least 4."""
    return 0 if levels == 0 else max(1 << levels, 4)


def _row_ranges(n: int, t: int, trees: int, resident: int):
    """(splits, rows per split) of ``trees`` trees' rows when ``resident``
    CTAs share ``t`` trees by tree count."""
    want = max(resident * trees // t, 1)
    rows = _round_up(-(-n // want), 32)
    return -(-n // rows), rows


def _forest_config(t: int, h: int, n: int, d: int, max_depth: int,
                   n_classes: int, per_tree: bool, block_trees: int,
                   form: int, resident: int) -> dict[str, int]:
    """Plain twin of the library's ``forest_config`` (``forest_tile``, then
    ``forest_grid`` over ``resident`` CTAs, which the library reads from
    the SM count and the kernel's occupancy): K3 / K4's tiling and work
    partition, keyed by ``CONFIG_KEYS``."""
    n_classes = 0 if per_tree else n_classes
    c = {"form": form, "threads": _THREADS}
    c["mode"] = (PER_TREE if per_tree else SUM if n_classes == 0
                 else VOTES if n_classes <= _REG_CLASSES else VOTE_ATOMIC)
    c["depth"] = depth = _walk_depth(h, max_depth)
    word = 4 * _WORD_INTS[form]
    c["dpad"] = d | 1
    # the x tile, when it fits, comes out of the trees' budget
    tile = c["threads"] * c["dpad"] * 4
    c["x_smem"] = int(tile <= _X_BYTES)
    x_bytes = _round_up(tile, 16) if c["x_smem"] else 0
    budget = min(_TREE_BYTES, _MAX_SMEM_BYTES - 16 - x_bytes)
    unit = block_trees if c["mode"] == SUM else 1  # votes: any order
    g_min = min(_round_up(t, unit), _round_up(_MIN_GROUP, unit))
    levels = depth  # the words walked; not the leaf fits
    # sums: one group of every tree when their top levels fit (groups of
    # whole chunks leave a small last group)
    one_group = c["mode"] == SUM and (
        t * word * _staged_words(min(levels, _SUM_LEVELS)) <= budget)
    need = t if one_group else g_min
    while levels > 0 and need * word * _staged_words(levels) > budget:
        levels -= 1
    c["levels"] = levels
    c["staged"] = _staged_words(levels)
    per = word * c["staged"]
    g_max = max(budget // per // unit * unit, unit) if per else t
    if g_max >= t:
        c["group"], c["n_groups"] = t, 1
    else:
        groups = -(-t // g_max)
        c["group"] = _round_up(-(-t // groups), unit)
        c["n_groups"] = -(-t // c["group"])
    slots = _round_up(c["group"], 8)  # 8 walks unless a quarter idles
    c["walks"] = 4 if 4 * (slots - c["group"]) > slots else 8
    c["smem"] = 16 + c["group"] * per + x_bytes
    if c["smem"] > _MAX_SMEM_BYTES:
        raise ValueError("the forest tiling needs more shared memory than "
                         "a Hopper CTA has")
    c["resident"] = resident
    c["splits"], c["rows_per_split"] = _row_ranges(n, t, c["group"], resident)
    c["splits_last"], c["rows_last"] = _row_ranges(
        n, t, t - (c["n_groups"] - 1) * c["group"], resident)
    c["grid"] = (c["n_groups"] - 1) * c["splits"] + c["splits_last"]
    c["partials"] = int(not per_tree and c["n_groups"] > 1)
    return {k: c[k] for k in CONFIG_KEYS}


def _forest_work(cfg: dict, t: int, n: int):
    """Each CTA's (trees, rows) under ``cfg``, in the kernel's assignment:
    CTAs ``[0, (n_groups - 1) * splits)`` take the full groups, ``splits``
    row ranges each, the rest the last group."""
    full = (cfg["n_groups"] - 1) * cfg["splits"]
    for b in range(cfg["grid"]):
        last = b >= full
        g = cfg["n_groups"] - 1 if last else b // cfg["splits"]
        split = b - full if last else b % cfg["splits"]
        rows = cfg["rows_last"] if last else cfg["rows_per_split"]
        t0, r0 = g * cfg["group"], split * rows
        yield (range(t0, min(t, t0 + cfg["group"])),
               range(r0, min(n, r0 + rows)))


def _decode_plain(code: torch.Tensor, tb2: int):
    """K1's decode of its code words, as the kernel does it: shift and
    mask where ``tb2`` is a power of two (the arithmetic shift floors
    negative words), else floor division; equal to ``_unfuse``."""
    if tb2 & (tb2 - 1):
        return _unfuse(code, tb2)
    c = code.to(torch.int32)
    rem = c & (tb2 - 1)
    return c >> (tb2.bit_length() - 1), rem >> 1, (rem & 1) == 1


def _walk_stay_put_plain(xb, feature, threshold, fit, is_internal,
                         max_depth: int) -> torch.Tensor:
    """The (T, N) leaves of K1 / K2's walk: ``min(max_depth,
    h.bit_length())`` uniform levels from the root (after them every walk
    has stopped or left the heap), each reading node idx's word by a
    select — the zero word past the heap: feature 0, threshold 0, not
    internal — and stepping ``idx = internal ? child : idx``; the fit where
    it ends, 0 past the heap."""
    n, d = xb.shape
    t, h = feature.shape
    xb_t = xb.T.contiguous()
    inter = is_internal.to(torch.bool)
    idx = torch.zeros((t, n), dtype=torch.int64, device=xb.device)
    for _ in range(min(max_depth, h.bit_length())):
        inside = idx < h
        at = idx.clamp(max=h - 1)
        fe = torch.where(inside, torch.gather(feature, 1, at), 0)
        th = torch.where(inside, torch.gather(threshold, 1, at), 0)
        step = inside & torch.gather(inter, 1, at)
        right = torch.gather(xb_t, 0, fe.long().clamp(0, d - 1)) > th
        idx = torch.where(step, 2 * idx + 1 + right.long(), idx)
    return torch.where(idx < h, torch.gather(fit, 1, idx.clamp(max=h - 1)),
                       torch.zeros((), dtype=fit.dtype))


def _seg_size(c: dict, n: int, block_obs: int, n_classes: int,
              rows: int) -> None:
    """The fields of a K1 / K2 configuration that follow from ``rows``."""
    c["rows"], c["cols"] = rows, _SEG_THREADS // rows
    c["x_smem"] = int(rows * c["dpad"] * 4 <= _SEG_X_BYTES)
    counts = rows * n_classes * 4
    c["mode"] = (SEG_SUMS if n_classes <= 0 else
                 SEG_VOTES if counts <= _SEG_COUNT_BYTES else SEG_VOTE_ATOMIC)
    x_bytes = _round_up(rows * c["dpad"] * 4, 16) if c["x_smem"] else 0
    table = {SEG_SUMS: _SEG_THREADS * _SEG_VALUES * 4, SEG_VOTES: counts,
             SEG_VOTE_ATOMIC: 0}[c["mode"]]
    # K2 stages the top levels of a pass's trees, one slice a column, as
    # many as fit (none if fewer than _SEG_MIN_LEVELS)
    levels = c["depth"] if c["decode"] == TABLES else 0
    while levels > 0 and (c["cols"] * _SEG_WALKS * (1 << levels)
                          * _SEG_STAGED_BYTES > _SEG_STAGE_BYTES):
        levels -= 1
    c["levels"] = levels if levels >= _SEG_MIN_LEVELS else 0
    c["staged"] = 1 << c["levels"] if c["levels"] else 0
    c["rounds"] = 1 if c["levels"] else _SEG_VALUES // c["values"]
    c["smem"] = (x_bytes + _round_up(table, 16)
                 + c["cols"] * _SEG_WALKS * c["staged"] * _SEG_STAGED_BYTES)
    c["tiles"] = -(-min(block_obs, n) // rows)
    c["grid"] = -(-n // block_obs) * c["tiles"]


def _seg_config(n: int, d: int, t: int, h: int, max_depth: int,
                n_classes: int, block_trees: int, block_obs: int,
                tb2: int | None, resident: int) -> dict[str, int]:
    """Plain twin of the library's ``seg_config``: K1's (``tb2`` its code
    word's) or K2's (``tb2=None``) tiling over ``resident`` CTAs, which the
    library reads from the SM count and the kernel's occupancy; keyed by
    ``SEG_CONFIG_KEYS``.  A CTA holds ``rows`` rows of one row block (the
    fewest, a power of two from 8 to 128, whose grid fits ``resident``)
    and walks ``cols`` slices of their chunk range at once, a slice being
    a chunk of up to 8 trees or 8 trees of a larger one; K2's CTAs hold at
    least 16 rows, so their 16 columns stage a level more of their trees."""
    if (n < 1 or d < 1 or t < 0 or h < 0 or block_trees < 1
            or block_obs < 1 or (tb2 is not None and tb2 < 1)
            or t * h >= 1 << 31):
        raise ValueError("the segmented kernels take n, d, block_trees, "
                         "block_obs and tb2 >= 1 and t * h < 2**31")
    c = {"threads": _SEG_THREADS, "walks": _SEG_WALKS, "resident": resident}
    c["decode"] = (TABLES if tb2 is None else
                   SHIFT if tb2 & (tb2 - 1) == 0 else DIVIDE)
    c["slices"] = -(-block_trees // _SEG_WALKS)
    c["values"] = 1 if c["slices"] == 1 else _SEG_WALKS
    c["depth"] = min(max_depth, h.bit_length())
    c["dpad"] = d | 1
    rows = 2 * _SEG_MIN_ROWS if tb2 is None else _SEG_MIN_ROWS
    _seg_size(c, n, block_obs, n_classes, rows)
    while rows < _SEG_MAX_ROWS and c["grid"] > resident:
        rows *= 2
        _seg_size(c, n, block_obs, n_classes, rows)
    return {k: c[k] for k in SEG_CONFIG_KEYS}


def _seg_work(cfg: dict, obs_seg, tree_seg, block_trees: int,
              block_obs: int, chunk_lo=None, chunk_hi=None):
    """Each K1 / K2 CTA's rows and the trees of the slices it keeps, in
    order, as the kernel assigns them: CTA ``b`` holds tile ``b % tiles``
    of row block ``b // tiles`` against that block's chunks (every chunk
    when ``chunk_lo`` is None); of each window of ``threads`` slices it
    keeps those with a tree whose segment lies in its rows' segment range,
    and kept slice ``i`` is walked by column ``i % cols``, ``cols * rounds``
    a pass.  Trees past the real ones are listed; the kernel masks them."""
    obs_seg, tree_seg = np.asarray(obs_seg), np.asarray(tree_seg)
    n, t = len(obs_seg), len(tree_seg)
    n_chunks = -(-t // block_trees)
    rows, tiles, parts = cfg["rows"], cfg["tiles"], cfg["slices"]
    for b in range(cfg["grid"]):
        blk = b // tiles
        r0 = blk * block_obs + (b % tiles) * rows
        end = min(blk * block_obs + block_obs, r0 + rows, n)
        if end <= r0:
            continue
        lo, hi = 0, n_chunks
        if chunk_lo is not None:
            lo, hi = max(int(chunk_lo[blk]), 0), min(int(chunk_hi[blk]),
                                                     n_chunks)
        seg_lo, seg_hi = obs_seg[r0:end].min(), obs_seg[r0:end].max()
        slices = []
        for j in range(max(hi - lo, 0) * parts):
            t0 = (lo + j // parts) * block_trees + (j % parts) * _SEG_WALKS
            trees = range(t0, t0 + min(
                _SEG_WALKS, block_trees - (j % parts) * _SEG_WALKS))
            segs = tree_seg[trees.start:min(trees.stop, t)]
            if ((segs >= seg_lo) & (segs <= seg_hi)).any():
                slices.append(trees)
        yield range(r0, end), slices


# ---------------------------------------------------------------------------
# CUDA launches
# ---------------------------------------------------------------------------

def _library() -> ctypes.CDLL:
    from ..build import load

    return load("tree_predict", _SIGNATURES)


def _check(name: str, t: torch.Tensor, dtype, shape, device) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _grid_config(n: int, block_trees: int, block_obs: int) -> None:
    if block_trees < 1 or block_obs < 1:
        raise ValueError("block_trees and block_obs must be positive")
    if n >= 1 << 31:
        raise ValueError(f"{n} rows do not fit the kernels' int32 row index")


def _launch_config(n: int, d: int, t: int, h: int, block_trees: int,
                   block_obs: int, tb2: int | None = None) -> None:
    """What K1 (``tb2`` given) and K2 refuse: no rows or features, blocks
    below 1, a code word base below 1 (its decode divides by it), more
    rows than an int32 row index holds, and heaps of ``t * h >= 2**31``
    nodes (32-bit node offsets).  Their shared memory does not grow with
    ``block_trees`` or ``block_obs``, so no block size is refused."""
    _grid_config(n, block_trees, block_obs)
    if n < 1 or d < 1:
        raise ValueError(f"the segmented kernels need rows and features, "
                         f"got n={n}, d={d}")
    if tb2 is not None and tb2 < 1:
        raise ValueError(f"tb2={tb2}: the code word decode divides by it")
    if t * h >= 1 << 31:
        raise ValueError(f"{t} x {h} heap nodes pass the kernels' 32-bit "
                         "node offsets")


def _raise_on(err: int, fn: str) -> None:
    if err:
        msg = _library().tp_error_string(err).decode()
        raise RuntimeError(f"{fn} failed: CUDA error {err} ({msg})")


def seg_config(n: int, d: int, t: int, h: int, max_depth: int,
               n_classes: int, block_trees: int, block_obs: int,
               tb2: int | None = None) -> dict[str, int]:
    """K1's (``tb2`` its code word's) or K2's (``tb2=None``) configuration
    on the current card, as the library computes it for a launch
    (``SEG_CONFIG_KEYS``)."""
    out = (_I * len(SEG_CONFIG_KEYS))()
    _raise_on(
        _library().tp_seg_config(
            n, d, t, h, max_depth, n_classes, block_trees, block_obs,
            0 if tb2 is None else tb2, int(tb2 is None), out,
        ),
        "tp_seg_config",
    )
    return dict(zip(SEG_CONFIG_KEYS, out))


def _launch_seg_packed(
    xb, obs_seg, code, fit, tree_seg, chunk_lo, chunk_hi, max_depth: int,
    tb2: int, n_classes: int = 0, block_trees: int = 8,
    block_obs: int = 128,
) -> torch.Tensor:
    """Launch K1 on the card: CTAs of a few rows of one row block, each
    walking many chunks of the block's range at once (``seg_config``).
    Inputs must already have the kernel's dtypes and be contiguous on one
    CUDA device."""
    dev = code.device
    n, d = xb.shape
    t_pad, h = code.shape
    _launch_config(n, d, t_pad, h, block_trees, block_obs, tb2)
    g = -(-n // block_obs)
    _check("xb", xb, torch.int32, (n, d), dev)
    _check("obs_seg", obs_seg, torch.int32, (n,), dev)
    _check("code", code, torch.float32, (t_pad, h), dev)
    _check("fit", fit, torch.float32, (t_pad, h), dev)
    _check("tree_seg", tree_seg, torch.int32, (t_pad,), dev)
    _check("chunk_lo", chunk_lo, torch.int32, (g,), dev)
    _check("chunk_hi", chunk_hi, torch.int32, (g,), dev)
    if t_pad % block_trees:
        raise ValueError("T_pad must be a multiple of block_trees")
    if dev.type != "cuda":
        raise ValueError(f"K1 launches on a CUDA device, got {dev}")
    out = torch.empty(
        (n, n_classes) if n_classes > 0 else (n,), dtype=torch.float32,
        device=dev,
    )
    lib = _library()
    with torch.cuda.device(dev):
        err = lib.tp_seg_packed(
            xb.data_ptr(), obs_seg.data_ptr(), code.data_ptr(),
            fit.data_ptr(), tree_seg.data_ptr(), chunk_lo.data_ptr(),
            chunk_hi.data_ptr(), out.data_ptr(), n, d, t_pad, h, max_depth,
            tb2, n_classes, block_trees, block_obs,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on(err, "tp_seg_packed")
    LAUNCHES["seg_packed"] += 1
    return out


def _launch_seg_simple(
    xb, obs_seg, tree_seg, feature, threshold, fit, is_internal,
    max_depth: int, n_classes: int = 0, block_trees: int = 32,
    block_obs: int = 256,
) -> torch.Tensor:
    """Launch K2 on the card: K1's kernel over the separate tables and
    every chunk of ``block_trees`` trees, masking ``tree_id < T``, the top
    levels of its trees staged in shared memory."""
    dev = feature.device
    n, d = xb.shape
    t, h = feature.shape
    _launch_config(n, d, t, h, block_trees, block_obs)
    _check("xb", xb, torch.int32, (n, d), dev)
    _check("obs_seg", obs_seg, torch.int32, (n,), dev)
    _check("tree_seg", tree_seg, torch.int32, (t,), dev)
    _check("feature", feature, torch.int32, (t, h), dev)
    _check("threshold", threshold, torch.int32, (t, h), dev)
    _check("fit", fit, torch.float32, (t, h), dev)
    _check("is_internal", is_internal, torch.bool, (t, h), dev)
    if dev.type != "cuda":
        raise ValueError(f"K2 launches on a CUDA device, got {dev}")
    out = torch.empty(
        (n, n_classes) if n_classes > 0 else (n,), dtype=torch.float32,
        device=dev,
    )
    lib = _library()
    with torch.cuda.device(dev):
        err = lib.tp_seg_simple(
            xb.data_ptr(), obs_seg.data_ptr(), tree_seg.data_ptr(),
            feature.data_ptr(), threshold.data_ptr(), fit.data_ptr(),
            is_internal.data_ptr(), out.data_ptr(), n, d, t, h, max_depth,
            n_classes, block_trees, block_obs,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on(err, "tp_seg_simple")
    LAUNCHES["seg_simple"] += 1
    return out


def _check_heaps(xb, feature, threshold, fit, is_internal, dev):
    n, d = xb.shape
    t, h = feature.shape
    _check("xb", xb, torch.int32, (n, d), dev)
    _check("feature", feature, torch.int32, (t, h), dev)
    _check("threshold", threshold, torch.int32, (t, h), dev)
    _check("fit", fit, torch.float32, (t, h), dev)
    _check("is_internal", is_internal, torch.bool, (t, h), dev)


def forest_config(t: int, h: int, n: int, d: int, max_depth: int,
                  n_classes: int, per_tree: bool, block_trees: int,
                  form: int) -> dict[str, int]:
    """K3's (``per_tree`` False) or K4's configuration on the current
    card, as the library computes it for a launch (``CONFIG_KEYS``)."""
    out = (_I * len(CONFIG_KEYS))()
    _raise_on(
        _library().tp_forest_config(
            t, h, n, d, max_depth, n_classes, int(per_tree), block_trees,
            form, out,
        ),
        "tp_forest_config",
    )
    return dict(zip(CONFIG_KEYS, out))


def _forest_launch_args(xb, feature, threshold, fit, is_internal, name,
                        max_depth, block_trees, block_obs, form):
    """Checks shared by K3's and K4's launches; the record form (read from
    the thresholds when not given) and the scratch of node words and
    fits.  A given ``NARROW`` form is refused where d > 2**15; that every
    |threshold| < 2**15 is the caller's to guarantee (reading it would
    sync the card)."""
    dev = feature.device
    _check_heaps(xb, feature, threshold, fit, is_internal, dev)
    t, h = feature.shape
    d = xb.shape[1]
    if form == NARROW and d > _NARROW_LIMIT:
        raise ValueError(f"narrow records hold d <= 2**15 features, got {d}")
    if dev.type != "cuda":
        raise ValueError(f"{name} launches on a CUDA device, got {dev}")
    _grid_config(xb.shape[0], block_trees, block_obs)
    if form is None:
        top = int(threshold.abs().max()) if threshold.numel() else 0
        form = _record_form(d, top)
    ws = _leaf_stride(_walk_depth(h, max_depth))
    records = torch.empty((t * ws * (_WORD_INTS[form] + 1),),
                          dtype=torch.int32, device=dev)
    return dev, form, records


def _launch_agg(
    xb, feature, threshold, fit, is_internal, max_depth: int,
    n_classes: int = 0, block_trees: int = 8, block_obs: int = 256,
    form: int | None = None,
) -> torch.Tensor:
    """Launch K3 on the card: the record prologue, the forest kernel (a
    CTA per tree group and row range, ``forest_config``) and, when the
    trees span several groups, the pass that folds their chunk sums or
    turns their integer votes into floats.  ``block_obs`` does not change
    the launch; it is taken so the launch and its plain version share one
    signature."""
    dev, form, records = _forest_launch_args(
        xb, feature, threshold, fit, is_internal, "K3", max_depth,
        block_trees, block_obs, form,
    )
    n, d = xb.shape
    t, h = feature.shape
    cfg = forest_config(t, h, n, d, max_depth, n_classes, False,
                        block_trees, form)
    partial = None
    if cfg["mode"] == SUM and cfg["partials"]:
        partial = torch.empty((-(-t // block_trees), n), dtype=torch.float32,
                              device=dev)
    out = torch.zeros(
        (n, n_classes) if n_classes > 0 else (n,), dtype=torch.float32,
        device=dev,
    )
    lib = _library()
    with torch.cuda.device(dev):
        err = lib.tp_agg(
            xb.data_ptr(), feature.data_ptr(), threshold.data_ptr(),
            fit.data_ptr(), is_internal.data_ptr(), records.data_ptr(),
            None if partial is None else partial.data_ptr(), out.data_ptr(),
            n, d, t, h, max_depth, n_classes, block_trees, form,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on(err, "tp_agg")
    LAUNCHES["agg"] += 1
    return out


def _launch_per_tree(
    xb, feature, threshold, fit, is_internal, max_depth: int,
    block_trees: int = 8, block_obs: int = 256, form: int | None = None,
) -> torch.Tensor:
    """Launch K4 on the card: the record prologue, then the forest kernel
    writing (T, N) along rows.  ``block_trees`` and ``block_obs`` do not
    change the launch; they are taken so the launch and its plain version
    share one signature."""
    dev, form, records = _forest_launch_args(
        xb, feature, threshold, fit, is_internal, "K4", max_depth,
        block_trees, block_obs, form,
    )
    n, d = xb.shape
    t, h = feature.shape
    out = torch.empty((t, n), dtype=torch.float32, device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        err = lib.tp_per_tree(
            xb.data_ptr(), feature.data_ptr(), threshold.data_ptr(),
            fit.data_ptr(), is_internal.data_ptr(), records.data_ptr(),
            out.data_ptr(), n, d, t, h, max_depth, block_trees, form,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on(err, "tp_per_tree")
    LAUNCHES["per_tree"] += 1
    return out


def _launch_seg_sharded(
    xb, obs_seg, code, fit, tree_seg, chunk_lo, chunk_hi, max_depth: int,
    tb2: int, n_classes: int = 0, block_trees: int = 8,
    block_obs: int = 128,
) -> torch.Tensor:
    """K5 on the cards: K1 launched on each shard's CUDA device over that
    shard's trees against the replicated rows, then the partials summed
    on the first shard's device in shard order.  Arguments as in
    ``_seg_sharded_plain``; every shard's tensors must lie on one CUDA
    device."""
    for c in code:
        if c.device.type != "cuda":
            raise ValueError(f"K5 launches on CUDA devices, got {c.device}")
    parts = [
        _launch_seg_packed(*shard, max_depth, tb2, n_classes, block_trees,
                           block_obs)
        for shard in zip(xb, obs_seg, code, fit, tree_seg, chunk_lo,
                         chunk_hi)
    ]
    out = _sum_shards(parts)
    LAUNCHES["seg_sharded"] += 1
    return out


# ---------------------------------------------------------------------------
# Public entries
# ---------------------------------------------------------------------------

def _device_of(*arrays) -> torch.device:
    """The one device of the tensor arguments (numpy arrays follow it)."""
    devices = {a.device for a in arrays if isinstance(a, torch.Tensor)}
    if not devices:
        raise TypeError(
            "pass at least one argument as a torch.Tensor: its device "
            "selects the CUDA kernel or, on the CPU, its plain version"
        )
    if len(devices) > 1:
        raise ValueError(
            f"tensor arguments lie on several devices: {sorted(map(str, devices))}"
        )
    return devices.pop()


def _on(a, dtype, device) -> torch.Tensor:
    if isinstance(a, np.ndarray):
        a = np.ascontiguousarray(a)
    return torch.as_tensor(a, dtype=dtype, device=device).contiguous()


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def forest_predict_agg_segmented_packed(
    xb,  # (N, d) int32
    obs_seg,  # (N,) int32
    code,  # (T_pad, H) float32 fused node attrs (fuse_node_attrs)
    fit,  # (T_pad, H) float32
    tree_seg,  # (T_pad,) int32, -1 marks padding trees
    chunk_lo,  # (ceil(N / block_obs),) int32
    chunk_hi,  # (ceil(N / block_obs),) int32
    max_depth: int,
    tb2: int,  # 2 * fused_threshold_base(...)
    n_classes: int = 0,
    block_trees: int = 8,
    block_obs: int = 128,
) -> torch.Tensor:
    """Low-level pipelined entry (K1) for PRE-FUSED tree tiles (the device
    tile arena stores this layout): one launch.  ``T_pad`` must be a
    positive multiple of ``block_trees`` with padding trees marked
    ``tree_seg == -1``.  Returns (N, C) votes or (N,) sums on the
    arguments' device."""
    dev = _device_of(xb, obs_seg, code, fit, tree_seg, chunk_lo, chunk_hi)
    t_pad, _ = code.shape
    n, d = xb.shape
    if t_pad % block_trees != 0 or t_pad == 0:
        raise ValueError(
            f"T_pad={t_pad} must be a positive multiple of "
            f"block_trees={block_trees}"
        )
    if n_classes > 0 and n_classes >= _F32_EXACT_INT:
        raise ValueError("n_classes >= 2**24 overflows float32 vote counts")
    # value-check code only when it is a host array: device-resident code
    # comes from the arena, whose constructor already rejects schemas that
    # could reach 2**24 — re-reducing it here would force a device sync on
    # every serving batch
    arrays = {"xb": xb}
    if isinstance(code, np.ndarray):
        arrays["code"] = code
    _validate_f32_exact(max_depth, d, **arrays)
    block_obs = min(block_obs, n)
    if n == 0:
        shape = (0, n_classes) if n_classes > 0 else (0,)
        return torch.zeros(shape, dtype=torch.float32, device=dev)
    args = (
        _on(xb, torch.int32, dev),
        _on(obs_seg, torch.int32, dev).reshape(-1),
        _on(code, torch.float32, dev),
        _on(fit, torch.float32, dev),
        _on(tree_seg, torch.int32, dev).reshape(-1),
        _on(chunk_lo, torch.int32, dev),
        _on(chunk_hi, torch.int32, dev),
    )
    run = _seg_packed_plain if dev.type == "cpu" else _launch_seg_packed
    return run(
        *args, max_depth, int(tb2), n_classes, block_trees, block_obs
    )


def _forest_predict_agg_segmented_simple(
    xb, obs_seg, tree_seg, feature, threshold, fit, is_internal,
    max_depth, n_classes, block_trees, block_obs, device,
):
    """The unfused segmented engine (K2) — the ``engine="simple"`` oracle
    and the fallback for schemas whose fused code word would reach 2**24."""
    t, _ = feature.shape
    n, d = xb.shape
    _validate_f32_exact(
        max_depth, d, feature=feature, threshold=threshold, xb=xb
    )
    if n_classes > 0 and n_classes >= _F32_EXACT_INT:
        raise ValueError("n_classes >= 2**24 overflows float32 vote counts")
    if n == 0 or t == 0:
        shape = (n, n_classes) if n_classes > 0 else (n,)
        return torch.zeros(shape, dtype=torch.float32, device=device)
    args = (
        _on(xb, torch.int32, device),
        _on(obs_seg, torch.int32, device).reshape(-1),
        _on(tree_seg, torch.int32, device).reshape(-1),
        _on(feature, torch.int32, device),
        _on(threshold, torch.int32, device),
        _on(fit, torch.float32, device),
        _on(is_internal, torch.bool, device),
    )
    run = _seg_simple_plain if device.type == "cpu" else _launch_seg_simple
    return run(
        *args, max_depth, n_classes, min(block_trees, t), min(block_obs, n)
    )


def forest_predict_agg_segmented(
    xb,  # (N, d) int32
    obs_seg,  # (N,) or (N, 1) int32 segment (user) id per row
    tree_seg,  # (T,) or (T, 1) int32 segment (user) id per tree
    feature,  # (T, H) int32
    threshold,  # (T, H) int32
    fit,  # (T, H) float32 (class ids for classification)
    is_internal,  # (T, H) bool
    max_depth: int,
    n_classes: int = 0,
    block_trees: int = 8,
    block_obs: int = 256,
    engine: str | None = None,
) -> torch.Tensor:
    """Ragged multi-tenant serving entry: per-row ensemble aggregation
    restricted to the trees whose segment id matches the row's.

    Trees from MANY users' forests concatenate along the T axis and a
    mixed batch of many users' observations along N; one call returns, per
    row, the (N,) fit sum / (N, C) vote counts over that row's own forest
    only.  Segment ids are compared as int32, so any int32 id is safe.

    ``engine``: ``"pipelined"`` (fused attributes, K1), ``"simple"`` (K2),
    or ``None`` to pick ``"pipelined"`` whenever the batch is non-empty,
    the node attributes are non-negative, and the fused code word fits
    below 2**24.
    """
    dev = _device_of(
        xb, obs_seg, tree_seg, feature, threshold, fit, is_internal
    )
    t, _ = feature.shape
    n, d = xb.shape
    obs_seg = obs_seg.reshape(-1)
    tree_seg = tree_seg.reshape(-1)
    if engine is None or engine == "pipelined":
        eligible = t > 0 and n > 0
        if eligible:
            feat_h = _host(feature)
            thr_h = _host(threshold)
            tb = fused_threshold_base(int(thr_h.max(initial=0)))
            eligible = (
                int(feat_h.min(initial=0)) >= 0
                and int(thr_h.min(initial=0)) >= 0
                and fused_code_limit(d, tb) < _F32_EXACT_INT
            )
        if not eligible:
            if engine == "pipelined":
                raise ValueError(
                    "engine='pipelined' needs non-negative feature/threshold "
                    "arrays whose fused code word fits below 2**24 (and a "
                    "non-empty batch)"
                )
            engine = "simple"
        else:
            code = fuse_node_attrs(feat_h, thr_h, _host(is_internal), tb)
            fit_h = _host(fit).astype(np.float32)
            block_trees = min(block_trees, t)
            t_pad = -(-t // block_trees) * block_trees
            tseg_h = _host(tree_seg).astype(np.int32)
            pad = t_pad - t
            if pad:
                code = np.pad(code, ((0, pad), (0, 0)))
                fit_h = np.pad(fit_h, ((0, pad), (0, 0)))
                tseg_h = np.pad(tseg_h, (0, pad), constant_values=-1)
            oseg_h = _host(obs_seg).astype(np.int32)
            block_obs = min(block_obs, n)
            chunk_lo, chunk_hi = segment_chunk_ranges(
                oseg_h, tseg_h, block_trees, block_obs
            )
            return forest_predict_agg_segmented_packed(
                xb, oseg_h, _on(code, torch.float32, dev),
                _on(fit_h, torch.float32, dev), tseg_h, chunk_lo, chunk_hi,
                max_depth, 2 * tb, n_classes=n_classes,
                block_trees=block_trees, block_obs=block_obs,
            )
    if engine != "simple":
        raise ValueError(f"unknown segmented engine {engine!r}")
    return _forest_predict_agg_segmented_simple(
        xb, obs_seg, tree_seg, feature, threshold, fit, is_internal,
        max_depth, n_classes, block_trees, block_obs, dev,
    )


def _forest_inputs(xb, feature, threshold, fit, is_internal, max_depth):
    """Shared checks of the whole-forest entries (K3, K4): the device,
    the reference's 2**24 guards, the inputs moved there, and the record
    form the guard's threshold maximum allows."""
    dev = _device_of(xb, feature, threshold, fit, is_internal)
    d = xb.shape[1]
    maxima = _validate_f32_exact(
        max_depth, d, feature=feature, threshold=threshold, xb=xb
    )
    args = (
        _on(xb, torch.int32, dev),
        _on(feature, torch.int32, dev),
        _on(threshold, torch.int32, dev),
        _on(fit, torch.float32, dev),
        _on(is_internal, torch.bool, dev),
    )
    return dev, args, _record_form(d, maxima["threshold"])


def forest_predict(
    xb,  # (N, d) int32
    feature,  # (T, H) int32
    threshold,  # (T, H) int32
    fit,  # (T, H) float32
    is_internal,  # (T, H) bool
    max_depth: int,
    block_trees: int = 8,
    block_obs: int = 256,
) -> torch.Tensor:
    """Returns (T, N) per-(tree, obs) leaf fits (K4) on the arguments'
    device."""
    dev, args, form = _forest_inputs(
        xb, feature, threshold, fit, is_internal, max_depth
    )
    t, n = feature.shape[0], xb.shape[0]
    if n == 0 or t == 0:
        return torch.zeros((t, n), dtype=torch.float32, device=dev)
    if dev.type == "cpu":
        return _per_tree_plain(*args, max_depth, min(block_trees, t),
                               min(block_obs, n))
    return _launch_per_tree(*args, max_depth, min(block_trees, t),
                            min(block_obs, n), form=form)


def forest_predict_agg(
    xb,  # (N, d) int32
    feature,  # (T, H) int32
    threshold,  # (T, H) int32
    fit,  # (T, H) float32 (class ids for classification)
    is_internal,  # (T, H) bool
    max_depth: int,
    n_classes: int = 0,
    block_trees: int = 8,
    block_obs: int = 256,
) -> torch.Tensor:
    """Whole-forest entry with in-kernel ensemble aggregation (K3).

    Returns (N,) summed leaf fits when ``n_classes == 0`` (regression;
    divide by T for the ensemble mean) or (N, C) per-class vote counts
    otherwise, on the arguments' device.  Sums run per chunk of
    ``block_trees`` trees in tree order, then chunk by chunk."""
    dev, args, form = _forest_inputs(
        xb, feature, threshold, fit, is_internal, max_depth
    )
    if n_classes > 0 and n_classes >= _F32_EXACT_INT:
        raise ValueError("n_classes >= 2**24 overflows float32 vote counts")
    t, n = feature.shape[0], xb.shape[0]
    if n == 0 or t == 0:
        shape = (n, n_classes) if n_classes > 0 else (n,)
        return torch.zeros(shape, dtype=torch.float32, device=dev)
    blocks = (min(block_trees, t), min(block_obs, n))
    if dev.type == "cpu":
        return _agg_plain_unseg(*args, max_depth, n_classes, *blocks)
    return _launch_agg(*args, max_depth, n_classes, *blocks, form=form)
