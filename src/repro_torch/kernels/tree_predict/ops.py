"""ForestModel-level prediction through the whole-forest kernels, plus the
multi-device sharded entry for the segmented serving kernel — the port of
``repro.kernels.tree_predict.ops``.

The model-level entries take ``device`` (default ``"cuda"``; raises
without a card, ``"cpu"`` runs the kernels' plain versions) where the
reference takes ``interpret``.  The sharded entry (K5) takes the explicit
device list it shards over (``devices``) where the reference shards over
the devices JAX sees."""
from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from ...device import resolve_device, resolve_devices
from . import tree_predict as tp
from .tree_predict import forest_predict, forest_predict_agg


def _heap_tensors(model, dev):
    """The model's heap tables on ``dev``, with each node's scalar leaf
    value: its class (argmax of the fit) or its regression fit."""
    cfg = model.cfg
    if cfg.task == "classification":
        fit = model.node_fit.argmax(-1).astype(np.float32)
    else:
        fit = np.ascontiguousarray(model.node_fit[..., 0], np.float32)

    def up(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=dev)

    return (
        up(model.feature, torch.int32), up(model.threshold, torch.int32),
        up(fit, torch.float32), up(model.is_internal, torch.bool),
    )


def predict_forest_kernel(
    model, x_raw: np.ndarray, device: str | torch.device = "cuda"
) -> np.ndarray:
    """Ensemble prediction matching ``repro_torch.forest.predict_forest``,
    but through K3 (votes / fit sums reduced in-kernel).  Returns (n,)
    predictions on the host."""
    dev = resolve_device(device)
    xb = torch.as_tensor(model.binner.transform(x_raw), device=dev)
    cfg = model.cfg
    feature, threshold, fit, inter = _heap_tensors(model, dev)
    if cfg.task == "classification":
        votes = forest_predict_agg(
            xb, feature, threshold, fit, inter, max_depth=cfg.max_depth,
            n_classes=cfg.n_classes,
        )  # (N, C)
        return votes.argmax(-1).cpu().numpy()
    sums = forest_predict_agg(
        xb, feature, threshold, fit, inter, max_depth=cfg.max_depth,
    )  # (N,)
    return (sums / model.n_trees).cpu().numpy()


def predict_forest_kernel_per_tree(
    model, x_raw: np.ndarray, device: str | torch.device = "cuda"
) -> np.ndarray:
    """(T, N) per-tree leaf fits through K4 (kept for sigma^2-style
    per-tree diagnostics and as a parity reference), on the host."""
    dev = resolve_device(device)
    xb = torch.as_tensor(model.binner.transform(x_raw), device=dev)
    feature, threshold, fit, inter = _heap_tensors(model, dev)
    return forest_predict(
        xb, feature, threshold, fit, inter, max_depth=model.cfg.max_depth,
    ).cpu().numpy()


# ---------------------------------------------------------------------------
# Sharded ragged tree axis (K5)
# ---------------------------------------------------------------------------

def partition_segments_by_load(
    seg_trees: np.ndarray, n_shards: int
) -> list[list[int]]:
    """Greedy bin-pack of segment (user) ids onto ``n_shards`` devices by
    per-segment tree count: heaviest segment first onto the least-loaded
    shard.  Returns one list of segment ids per shard (possibly empty)."""
    seg_trees = np.asarray(seg_trees, np.int64)
    shards: list[list[int]] = [[] for _ in range(n_shards)]
    loads = np.zeros(n_shards, np.int64)
    for s in np.argsort(-seg_trees, kind="stable"):
        k = int(np.argmin(loads))
        shards[k].append(int(s))
        loads[k] += int(seg_trees[s])
    return shards


def estimate_shard_speedup(seg_trees: np.ndarray, n_shards: int) -> float:
    """Predicted sharded-engine speedup for a batch: total tree load over
    the heaviest shard's load under the greedy bin-pack (1.0 = one user
    dominates and sharding buys nothing; ``n_shards`` = perfectly even).
    The serving session's engine cost model compares this against its
    minimum-speedup threshold instead of blindly sharding on any
    multi-device host."""
    seg_trees = np.asarray(seg_trees, np.int64)
    total = int(seg_trees.sum())
    if total == 0 or n_shards <= 1:
        return 1.0
    shards = partition_segments_by_load(seg_trees, n_shards)
    max_load = max(
        (sum(int(seg_trees[s]) for s in shard) for shard in shards if shard),
        default=total,
    )
    return total / max(max_load, 1)


def forest_predict_agg_segmented_sharded(
    xb,  # (N, d) int32, replicated
    obs_seg,  # (N,) int32, replicated
    code,  # (S, T_pad, H) float32 fused tiles: one tree shard per device
    fit,  # (S, T_pad, H) float32
    tree_seg,  # (S, T_pad) int32, -1 marks padding trees
    chunk_lo,  # (S, ceil(N / block_obs)) int32 per-shard chunk ranges
    chunk_hi,  # (S, ceil(N / block_obs)) int32
    max_depth: int,
    tb2: int,
    n_classes: int = 0,
    block_trees: int = 8,
    block_obs: int = 128,
    devices=None,
) -> torch.Tensor:
    """Multi-device ragged serving (K5): the tree axis is SHARDED across
    devices (shard ``s`` on ``devices[s]``, load-balanced by
    ``partition_segments_by_load``), observations are replicated, each
    device accumulates partial votes/sums over its own trees, and the
    (N, C) partials are summed on ``devices[0]`` in shard order — the
    reference's ``psum``, in a fixed order.

    ``code`` / ``fit`` are a stacked (S, T_pad, H) array, a sequence of S
    (T_pad, H) tensors (a device's shards may differ in ``T_pad``, and
    are padded to one), or {device: (k, T_pad, H)}: each device's shards
    stacked on it in shard order (the sharded engine's pack).
    ``devices`` defaults to every visible CUDA device when ``code`` lies
    on a card, else to ``code``'s one device (for a mapping: each key
    once for each of its shards); it may name one device more than once.
    Each device's shards reach it as one stack (one copy each of
    ``tree_seg`` and the chunk ranges).  On CPU devices each shard runs
    K1's plain version; on CUDA devices K5 launches once a device
    (``tree_predict._launch_seg_sharded``) or the call raises.

    Vote counts stay integer-exact under the reduction (float32 holds
    integers exactly below 2**24), so classification results are
    bit-exact against the single-device engines."""
    by_device = isinstance(code, Mapping)
    if by_device:
        s = sum(c.shape[0] for c in code.values())
        t_pads = [c.shape[1] for c in code.values()]
        if devices is None:
            devices = [dev for dev, c in code.items()
                       for _ in range(c.shape[0])]
    else:
        s = len(code)
        t_pads = [c.shape[0] for c in code]
    if devices is None:
        devices = resolve_devices(tp._device_of(*code))
    else:
        devices = tuple(resolve_device(d) for d in devices)
    if s > len(devices):
        raise ValueError(f"{s} tree shards but only {len(devices)} devices")
    n, d = xb.shape
    # same guards as the single-device packed entry: out-of-range values
    # must raise, as they do in the reference
    if n_classes > 0 and n_classes >= tp._F32_EXACT_INT:
        raise ValueError("n_classes >= 2**24 overflows float32 vote counts")
    arrays = {"xb": xb} if isinstance(xb, np.ndarray) else {}
    tp._validate_f32_exact(max_depth, d, **arrays)
    for t_pad in t_pads:
        if t_pad % block_trees != 0 or t_pad == 0:
            raise ValueError(
                f"T_pad={t_pad} must be a positive multiple of "
                f"block_trees={block_trees}"
            )
    devices = devices[:s]
    if len({dev.type for dev in devices}) > 1:
        raise ValueError("shard devices must all be CPU or all be CUDA")
    if n == 0:
        shape = (0, n_classes) if n_classes > 0 else (0,)
        return torch.zeros(shape, dtype=torch.float32, device=devices[0])
    groups: dict[torch.device, list[int]] = {}
    for i, dev in enumerate(devices):
        groups.setdefault(dev, []).append(i)

    def stacks(a, dtype, fill):
        """Each device's shards of ``a`` stacked on it: (k, ...)."""
        if isinstance(a, Mapping):
            a = {resolve_device(dev): c for dev, c in a.items()}
            if {dev: len(idx) for dev, idx in groups.items()} != {
                    dev: c.shape[0] for dev, c in a.items()}:
                raise ValueError("each device's stack must hold the shards "
                                 "``devices`` gives it")
            return [tp._on(a[dev], dtype, dev) for dev in groups]
        if isinstance(a, (np.ndarray, torch.Tensor)):
            return [tp._on(a[idx[0]:idx[-1] + 1]
                           if idx[-1] - idx[0] == len(idx) - 1 else a[idx],
                           dtype, dev)
                    for dev, idx in groups.items()]
        return [tp._stacked([tp._on(a[i], dtype, dev) for i in idx], fill)
                for dev, idx in groups.items()]

    args = (
        [tp._on(xb, torch.int32, dev) for dev in groups],
        [tp._on(obs_seg, torch.int32, dev).reshape(-1) for dev in groups],
        stacks(code, torch.float32, 0.0), stacks(fit, torch.float32, 0.0),
        stacks(tree_seg, torch.int32, -1), stacks(chunk_lo, torch.int32, 0),
        stacks(chunk_hi, torch.int32, 0),
    )
    scalars = (max_depth, int(tb2), n_classes, block_trees,
               min(block_obs, n))
    if devices[0].type == "cuda":
        return tp._launch_seg_sharded(*args, *scalars,
                                      shards=list(groups.values()))
    # the plain version takes one tensor a shard: rows replicated, each
    # shard a row of its device's stacks
    per_shard = [None] * s
    for j, idx in enumerate(groups.values()):
        for r, i in enumerate(idx):
            per_shard[i] = [a[j] if k < 2 else a[j][r]
                            for k, a in enumerate(args)]
    return tp._seg_sharded_plain(*map(list, zip(*per_shard)), *scalars)
