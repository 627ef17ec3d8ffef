"""Random forest on top of the histogram CART grower — the port of
``repro.forest.forest``.

``train_forest`` grows the trees in chunks of ``chunk`` at once with
:func:`repro_torch.forest.cart.grow_tree` on an explicit device.  The
random draws — bootstrap counts and the per-node feature-subsampling
uniforms — come from one ``torch.Generator`` on the CPU seeded by
``seed``, tree after tree, and move to the device chunk by chunk: one seed
gives the same draws on every device and for every chunk size.  (They are
not the reference's draws: JAX and torch generators differ.)

``predict_forest`` and ``per_tree_predictions`` traverse the heap arrays
with torch gathers on the device.  ``to_compact_forest`` converts heap
arrays to the codec's preorder compact trees on the host.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core.tree import Forest, ForestMeta, Tree
from ..device import resolve_device
from .binning import Binner
from .cart import CartConfig, grow_tree


@dataclass
class ForestModel:
    """Stacked heap arrays (host numpy, as the reference keeps them)."""

    feature: np.ndarray  # (T, H) int32
    threshold: np.ndarray  # (T, H) int32
    node_fit: np.ndarray  # (T, H, C) float32
    is_internal: np.ndarray  # (T, H) bool
    node_count: np.ndarray  # (T, H) float32
    cfg: CartConfig
    binner: Binner
    n_train_obs: int

    @property
    def n_trees(self) -> int:
        return self.feature.shape[0]


def _tree_draws(gen: torch.Generator, n: int, h: int, d: int):
    """One tree's draws: (n,) bootstrap counts of n draws with
    replacement, then (H, d) node uniforms."""
    idx = torch.randint(0, n, (n,), generator=gen)
    w = torch.bincount(idx, minlength=n).to(torch.float32)
    return w, torch.rand((h, d), generator=gen)


def encode_targets(y, task: str, n_classes: int, device) -> torch.Tensor:
    """(n, C) float32 targets: one-hot classes (an id outside ``[0, C)``
    gives a zero row, as ``jax.nn.one_hot``), or ``[y, y^2]``."""
    if task == "classification":
        yi = torch.as_tensor(np.asarray(y), dtype=torch.int64, device=device)
        classes = torch.arange(n_classes, device=device)
        return (yi[:, None] == classes).to(torch.float32)
    yf = torch.as_tensor(np.asarray(y), dtype=torch.float32, device=device)
    return torch.stack([yf, yf**2], dim=-1)


def train_forest(
    x_raw: np.ndarray,
    y: np.ndarray,
    binner: Binner,
    n_trees: int = 100,
    max_depth: int = 8,
    mtry: int = 0,
    min_samples_leaf: int = 1,
    task: str = "classification",
    n_classes: int = 2,
    seed: int = 0,
    chunk: int = 16,
    device: str | torch.device = "cuda",
) -> ForestModel:
    """Train ``n_trees`` bootstrap CART trees on ``device`` (default
    ``"cuda"``; raises without a card — pass ``"cpu"`` for the CPU)."""
    dev = resolve_device(device)
    n, d = x_raw.shape
    xb = torch.as_tensor(binner.transform(x_raw), device=dev)
    n_bins = int(binner.n_bins_per_feature.max())
    if mtry <= 0:
        mtry = max(1, int(np.sqrt(d)) if task == "classification" else d // 3)
    cfg = CartConfig(
        n_features=d,
        n_bins=n_bins,
        max_depth=max_depth,
        mtry=mtry,
        min_samples_leaf=min_samples_leaf,
        task=task,
        n_classes=n_classes,
    )
    y_enc = encode_targets(y, task, n_classes, dev)
    gen = torch.Generator().manual_seed(seed)
    outs = []
    for s in range(0, n_trees, chunk):
        draws = [
            _tree_draws(gen, n, cfg.n_heap, d)
            for _ in range(min(chunk, n_trees - s))
        ]
        w = torch.stack([a for a, _ in draws]).to(dev)
        scores = torch.stack([b for _, b in draws]).to(dev)
        outs.append(
            [a.cpu().numpy() for a in grow_tree(xb, y_enc, w, scores, cfg)]
        )
    feature, threshold, node_fit, is_internal, node_count = (
        np.concatenate([o[i] for o in outs], axis=0) for i in range(5)
    )
    return ForestModel(
        feature, threshold, node_fit, is_internal, node_count, cfg, binner, n
    )


def _leaf_fits(model: ForestModel, x_raw: np.ndarray, dev) -> torch.Tensor:
    """(T, n, C) fit of the leaf each row reaches in each tree."""
    xb_t = torch.as_tensor(model.binner.transform(x_raw), device=dev)
    xb_t = xb_t.T.long()  # (d, n)
    d, n = xb_t.shape

    def up(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev)

    feat, thr, inter = up(model.feature), up(model.threshold), up(model.is_internal)
    idx = torch.zeros((model.n_trees, n), dtype=torch.int64, device=dev)
    for _ in range(model.cfg.max_depth):
        fe = feat.gather(1, idx).long().clamp(0, d - 1)
        go_left = xb_t.gather(0, fe) <= thr.gather(1, idx)
        child = torch.where(go_left, 2 * idx + 1, 2 * idx + 2)
        idx = torch.where(inter.gather(1, idx), child, idx)
    fit = up(model.node_fit)
    return fit.gather(1, idx[..., None].expand(-1, -1, fit.shape[-1]))


def predict_forest(
    model: ForestModel, x_raw: np.ndarray,
    device: str | torch.device = "cuda",
) -> np.ndarray:
    """Batched heap traversal with torch gathers on ``device`` (the
    K3 kernel entry ``kernels.tree_predict.ops.predict_forest_kernel`` is
    its twin).  Returns (n,) majority classes or ensemble means."""
    preds = _leaf_fits(model, x_raw, resolve_device(device))  # (T, n, C)
    if model.cfg.task == "classification":
        votes = preds.argmax(-1)  # (T, n) per-tree class
        counts = torch.zeros(
            (votes.shape[1], model.cfg.n_classes), dtype=torch.int64,
            device=votes.device,
        )
        counts.scatter_add_(1, votes.T, torch.ones_like(votes.T))
        return counts.argmax(-1).cpu().numpy()
    return preds[..., 0].mean(0).cpu().numpy()


def per_tree_predictions(
    model: ForestModel, x_raw: np.ndarray,
    device: str | torch.device = "cuda",
) -> np.ndarray:
    """(T, n) per-tree predictions — used by §7's sigma^2 estimator."""
    preds = _leaf_fits(model, x_raw, resolve_device(device))
    if model.cfg.task == "classification":
        return preds.argmax(-1).cpu().numpy()
    return preds[..., 0].cpu().numpy()


def to_compact_forest(model: ForestModel) -> Forest:
    """Heap arrays -> preorder compact trees + forest-level fit dictionary
    (regression fits become indices into a distinct-64-bit-value table,
    mirroring the paper's fit dictionaries)."""
    cfg = model.cfg
    trees_raw = []
    all_fits = []
    for t in range(model.n_trees):
        feature, threshold, fit, internal = (
            model.feature[t],
            model.threshold[t],
            model.node_fit[t],
            model.is_internal[t],
        )
        # iterative preorder over the live heap nodes
        compact_of = {}
        seq = []
        st = [0]
        while st:
            i = st.pop()
            me = len(seq)
            seq.append(i)
            compact_of[i] = me
            if internal[i]:
                st.append(2 * i + 2)  # right pushed first -> left popped first
                st.append(2 * i + 1)
        n_nodes = len(seq)
        cf = np.full(n_nodes, -1, np.int32)
        ct = np.full(n_nodes, -1, np.int32)
        cl = np.full(n_nodes, -1, np.int32)
        cr = np.full(n_nodes, -1, np.int32)
        cfit_raw = np.zeros(n_nodes, np.float64)
        for me, i in enumerate(seq):
            if internal[i]:
                cf[me] = feature[i]
                ct[me] = threshold[i]
                cl[me] = compact_of[2 * i + 1]
                cr[me] = compact_of[2 * i + 2]
            if cfg.task == "classification":
                cfit_raw[me] = float(np.argmax(fit[i]))
            else:
                cfit_raw[me] = float(fit[i][0])
        trees_raw.append((cf, ct, cl, cr, cfit_raw))
        all_fits.append(cfit_raw)

    meta = ForestMeta(
        n_features=cfg.n_features,
        task=cfg.task,
        n_classes=cfg.n_classes,
        n_bins_per_feature=model.binner.n_bins_per_feature,
        bin_edges=model.binner.bin_edges,
        n_train_obs=model.n_train_obs,
        categorical=model.binner.categorical,
    )
    if cfg.task == "classification":
        trees = [
            Tree(cf, ct, cl, cr, cfit.astype(np.int64))
            for cf, ct, cl, cr, cfit in trees_raw
        ]
        return Forest(trees=trees, meta=meta)
    # regression: global distinct fit-value dictionary
    concat = np.concatenate(all_fits)
    fit_values, inv = np.unique(concat, return_inverse=True)
    trees = []
    off = 0
    for cf, ct, cl, cr, cfit in trees_raw:
        k = len(cfit)
        trees.append(Tree(cf, ct, cl, cr, inv[off : off + k].astype(np.int64)))
        off += k
    return Forest(trees=trees, meta=meta, fit_values=fit_values)
