"""Plain-torch oracle for batched forest traversal over heap-layout trees —
twins of ``repro.kernels.tree_predict.ref``.  Every function takes tensors
on one device and returns a tensor there."""
from __future__ import annotations

import torch


def _one_hot_votes(per_tree: torch.Tensor, n_classes: int) -> torch.Tensor:
    """(T, N) leaf fits -> (T, N, C) float32 class indicators.  The class
    is the fit truncated toward zero (``astype(int32)``); a class outside
    ``[0, C)`` gives an all-zero row, as ``jax.nn.one_hot`` does."""
    cls = per_tree.to(torch.int32).unsqueeze(-1)
    classes = torch.arange(n_classes, dtype=torch.int32, device=cls.device)
    return (cls == classes).to(torch.float32)


def forest_predict_reference(
    xb: torch.Tensor,  # (N, d) int32 binned observations
    feature: torch.Tensor,  # (T, H) int32
    threshold: torch.Tensor,  # (T, H) int32
    fit: torch.Tensor,  # (T, H) float32 per-node scalar fit
    is_internal: torch.Tensor,  # (T, H) bool
    max_depth: int,
) -> torch.Tensor:
    """Returns (T, N) leaf fit per (tree, observation).  Heap reads clamp
    to the last slot, as JAX's gathers do; ``idx`` advances in place."""
    n, d = xb.shape
    t, h = feature.shape
    xb_t = xb.T.contiguous()  # (d, N)
    inter = is_internal.to(torch.bool)
    idx = torch.zeros((t, n), dtype=torch.int64, device=xb.device)
    for _ in range(max_depth):
        at = idx.clamp(max=h - 1)
        fe = torch.gather(feature, 1, at).to(torch.int64).clamp(0, d - 1)
        go_left = torch.gather(xb_t, 0, fe) <= torch.gather(threshold, 1, at)
        child = torch.where(go_left, 2 * idx + 1, 2 * idx + 2)
        idx.copy_(torch.where(torch.gather(inter, 1, at), child, idx))
    return torch.gather(fit, 1, idx.clamp(max=h - 1))


def forest_predict_agg_reference(
    xb: torch.Tensor,
    feature: torch.Tensor,
    threshold: torch.Tensor,
    fit: torch.Tensor,
    is_internal: torch.Tensor,
    max_depth: int,
    n_classes: int = 0,
) -> torch.Tensor:
    """Ensemble-aggregated oracle: (N,) leaf-fit sums (n_classes == 0) or
    (N, C) vote counts — the reduction the fused kernel performs in-kernel."""
    per_tree = forest_predict_reference(
        xb, feature, threshold, fit, is_internal, max_depth
    )  # (T, N)
    if n_classes > 0:
        return _one_hot_votes(per_tree, n_classes).sum(0)
    return per_tree.sum(0)


def forest_predict_agg_segmented_reference(
    xb: torch.Tensor,
    obs_seg: torch.Tensor,  # (N,) int32 segment id per observation
    tree_seg: torch.Tensor,  # (T,) int32 segment id per tree
    feature: torch.Tensor,
    threshold: torch.Tensor,
    fit: torch.Tensor,
    is_internal: torch.Tensor,
    max_depth: int,
    n_classes: int = 0,
) -> torch.Tensor:
    """Ragged multi-tenant oracle: aggregate each observation over the trees
    whose segment (user) id matches its own."""
    per_tree = forest_predict_reference(
        xb, feature, threshold, fit, is_internal, max_depth
    )  # (T, N)
    mask = (
        tree_seg.reshape(-1, 1) == obs_seg.reshape(1, -1)
    ).to(per_tree.dtype)
    if n_classes > 0:
        votes = _one_hot_votes(per_tree, n_classes)
        return (votes * mask[..., None]).sum(0)
    return (per_tree * mask).sum(0)


def forest_predict_agg_segmented_packed_reference(
    xb: torch.Tensor,
    obs_seg: torch.Tensor,
    code: torch.Tensor,  # (T_pad, H) fused node attrs (see fuse_node_attrs)
    fit: torch.Tensor,  # (T_pad, H)
    tree_seg: torch.Tensor,  # (T_pad,), -1 marks padding trees
    max_depth: int,
    tb2: int,  # 2 * threshold field width (a power of two)
    n_classes: int = 0,
) -> torch.Tensor:
    """Oracle for the PACKED pipelined layout: un-fuse the float32 code
    table back into (feature, threshold, is_internal) with exact integer
    arithmetic and defer to the plain segmented reference — validates the
    fused encode/decode independently of the kernel."""
    code_i = code.to(torch.int32)  # exact: fused codes are < 2**24
    feature = torch.div(code_i, tb2, rounding_mode="floor")
    rem = code_i - feature * tb2
    threshold = torch.div(rem, 2, rounding_mode="floor")
    is_internal = (rem % 2) == 1
    return forest_predict_agg_segmented_reference(
        xb, obs_seg, tree_seg, feature, threshold, fit, is_internal,
        max_depth, n_classes=n_classes,
    )
