"""ForestModel-level prediction through the whole-forest kernels — the
port of the single-device half of ``repro.kernels.tree_predict.ops``.

Both entries take ``device`` (default ``"cuda"``; raises without a card,
``"cpu"`` runs the kernels' plain versions) where the reference takes
``interpret``.  The reference's sharded segmented entry is not ported
yet."""
from __future__ import annotations

import numpy as np
import torch

from ...device import resolve_device
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
