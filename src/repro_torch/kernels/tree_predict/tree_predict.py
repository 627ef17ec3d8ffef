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
_SIGNATURES = {
    "tp_seg_packed": ([_P] * 8 + [_I] * 9 + [_P], _I),
    "tp_seg_simple": ([_P] * 8 + [_I] * 8 + [_P], _I),
    "tp_agg": ([_P] * 6 + [_I] * 8 + [_P], _I),
    "tp_per_tree": ([_P] * 6 + [_I] * 7 + [_P], _I),
    "tp_error_string": ([_I], ctypes.c_char_p),
}


def reset_launches() -> None:
    """Set every launch count to 0."""
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _validate_f32_exact(max_depth: int, d: int, **arrays) -> None:
    """Raise if a value the reference routes through the float32 one-hot
    path could exceed the exactly-representable integer range.

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
    for name, arr in arrays.items():
        if isinstance(arr, torch.Tensor):
            if not arr.numel():
                continue
            big = int(torch.max(torch.abs(arr))) >= _F32_EXACT_INT
        else:
            arr = np.asarray(arr)
            if not arr.size:
                continue
            big = int(np.max(np.abs(arr))) >= _F32_EXACT_INT
        if big:
            raise ValueError(
                f"{name} contains values >= 2**24, not exactly representable "
                "in the float32 one-hot gathers"
            )


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


def _launch_config(n: int, block_trees: int, block_obs: int) -> None:
    """Grid checks plus the shared-memory pair buffer of K1-K3."""
    _grid_config(n, block_trees, block_obs)
    if block_trees * block_obs * 4 > _MAX_SMEM_BYTES:
        raise ValueError(
            f"block_trees * block_obs = {block_trees * block_obs} pairs "
            "need more shared memory than a Hopper CTA has"
        )


def _raise_on(err: int, fn: str) -> None:
    if err:
        msg = _library().tp_error_string(err).decode()
        raise RuntimeError(f"{fn} failed: CUDA error {err} ({msg})")


def _launch_seg_packed(
    xb, obs_seg, code, fit, tree_seg, chunk_lo, chunk_hi, max_depth: int,
    tb2: int, n_classes: int = 0, block_trees: int = 8,
    block_obs: int = 128,
) -> torch.Tensor:
    """Launch K1 on the card: one CTA per fixed block of ``block_obs``
    rows.  Inputs must already have the kernel's dtypes and be contiguous
    on one CUDA device."""
    dev = code.device
    if dev.type != "cuda":
        raise ValueError(f"K1 launches on a CUDA device, got {dev}")
    n, d = xb.shape
    t_pad, h = code.shape
    g = -(-n // block_obs)
    _check("xb", xb, torch.int32, (n, d), dev)
    _check("obs_seg", obs_seg, torch.int32, (n,), dev)
    _check("code", code, torch.float32, (t_pad, h), dev)
    _check("fit", fit, torch.float32, (t_pad, h), dev)
    _check("tree_seg", tree_seg, torch.int32, (t_pad,), dev)
    _check("chunk_lo", chunk_lo, torch.int32, (g,), dev)
    _check("chunk_hi", chunk_hi, torch.int32, (g,), dev)
    _launch_config(n, block_trees, block_obs)
    if t_pad % block_trees:
        raise ValueError("T_pad must be a multiple of block_trees")
    out = torch.zeros(
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
    """Launch K2 on the card: one CTA per block of ``block_obs`` rows,
    every chunk of ``block_trees`` trees."""
    dev = feature.device
    if dev.type != "cuda":
        raise ValueError(f"K2 launches on a CUDA device, got {dev}")
    n, d = xb.shape
    t, h = feature.shape
    _check("xb", xb, torch.int32, (n, d), dev)
    _check("obs_seg", obs_seg, torch.int32, (n,), dev)
    _check("tree_seg", tree_seg, torch.int32, (t,), dev)
    _check("feature", feature, torch.int32, (t, h), dev)
    _check("threshold", threshold, torch.int32, (t, h), dev)
    _check("fit", fit, torch.float32, (t, h), dev)
    _check("is_internal", is_internal, torch.bool, (t, h), dev)
    _launch_config(n, block_trees, block_obs)
    out = torch.zeros(
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


def _launch_agg(
    xb, feature, threshold, fit, is_internal, max_depth: int,
    n_classes: int = 0, block_trees: int = 8, block_obs: int = 256,
) -> torch.Tensor:
    """Launch K3 on the card: one CTA per block of ``block_obs`` rows,
    every chunk of ``block_trees`` trees, no segment test."""
    dev = feature.device
    if dev.type != "cuda":
        raise ValueError(f"K3 launches on a CUDA device, got {dev}")
    n, d = xb.shape
    t, h = feature.shape
    _check_heaps(xb, feature, threshold, fit, is_internal, dev)
    _launch_config(n, block_trees, block_obs)
    out = torch.zeros(
        (n, n_classes) if n_classes > 0 else (n,), dtype=torch.float32,
        device=dev,
    )
    lib = _library()
    with torch.cuda.device(dev):
        err = lib.tp_agg(
            xb.data_ptr(), feature.data_ptr(), threshold.data_ptr(),
            fit.data_ptr(), is_internal.data_ptr(), out.data_ptr(), n, d, t,
            h, max_depth, n_classes, block_trees, block_obs,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on(err, "tp_agg")
    LAUNCHES["agg"] += 1
    return out


def _launch_per_tree(
    xb, feature, threshold, fit, is_internal, max_depth: int,
    block_trees: int = 8, block_obs: int = 256,
) -> torch.Tensor:
    """Launch K4 on the card: a CTA per block of ``block_obs`` rows and
    ``block_trees`` trees, a row per thread, writing (T, N) along rows."""
    dev = feature.device
    if dev.type != "cuda":
        raise ValueError(f"K4 launches on a CUDA device, got {dev}")
    n, d = xb.shape
    t, h = feature.shape
    _check_heaps(xb, feature, threshold, fit, is_internal, dev)
    _grid_config(n, block_trees, block_obs)
    out = torch.empty((t, n), dtype=torch.float32, device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        err = lib.tp_per_tree(
            xb.data_ptr(), feature.data_ptr(), threshold.data_ptr(),
            fit.data_ptr(), is_internal.data_ptr(), out.data_ptr(), n, d, t,
            h, max_depth, block_trees, block_obs,
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
    the reference's 2**24 guards, and the inputs moved there."""
    dev = _device_of(xb, feature, threshold, fit, is_internal)
    _validate_f32_exact(
        max_depth, xb.shape[1], feature=feature, threshold=threshold, xb=xb
    )
    args = (
        _on(xb, torch.int32, dev),
        _on(feature, torch.int32, dev),
        _on(threshold, torch.int32, dev),
        _on(fit, torch.float32, dev),
        _on(is_internal, torch.bool, dev),
    )
    return dev, args


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
    dev, args = _forest_inputs(
        xb, feature, threshold, fit, is_internal, max_depth
    )
    t, n = feature.shape[0], xb.shape[0]
    if n == 0 or t == 0:
        return torch.zeros((t, n), dtype=torch.float32, device=dev)
    run = _per_tree_plain if dev.type == "cpu" else _launch_per_tree
    return run(*args, max_depth, min(block_trees, t), min(block_obs, n))


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
    dev, args = _forest_inputs(
        xb, feature, threshold, fit, is_internal, max_depth
    )
    if n_classes > 0 and n_classes >= _F32_EXACT_INT:
        raise ValueError("n_classes >= 2**24 overflows float32 vote counts")
    t, n = feature.shape[0], xb.shape[0]
    if n == 0 or t == 0:
        shape = (n, n_classes) if n_classes > 0 else (n,)
        return torch.zeros(shape, dtype=torch.float32, device=dev)
    run = _agg_plain_unseg if dev.type == "cpu" else _launch_agg
    return run(
        *args, max_depth, n_classes, min(block_trees, t), min(block_obs, n)
    )
