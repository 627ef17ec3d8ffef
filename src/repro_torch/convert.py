"""Carry state across from the JAX reference to the port, and back.

The RFS1 frame bytes (``docs/format.md``) are the interchange format:
bytes one package writes, the other reads.  ``forest_from_arrays`` turns
an uncompressed reference ``Forest`` into the port's from its numpy
fields alone (duck-typed: anything with ``feature``, ``threshold``,
``children_left``, ``children_right`` and ``node_fit`` per tree, and a
meta with the ``ForestMeta`` fields).  ``model_from_arrays`` carries a
trained reference ``ForestModel`` (heap arrays, ``CartConfig``, ``Binner``)
across the same way, and ``lm_params_from_arrays`` a reference LM's
parameter pytree (as numpy arrays) into the port's ``TransformerLM``.
Nothing here imports the reference.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.forest_codec import CompressedForest
from .core.tree import Forest, ForestMeta, Tree
from .forest.binning import Binner
from .forest.cart import CartConfig
from .forest.forest import ForestModel
from .models.model import TransformerLM

__all__ = [
    "compressed_from_bytes",
    "forest_from_arrays",
    "lm_params_from_arrays",
    "model_from_arrays",
]


def forest_from_arrays(trees, meta, fit_values) -> Forest:
    """The port's ``Forest`` holding copies of the given trees' arrays."""
    port_meta = ForestMeta(
        n_features=int(meta.n_features),
        task=str(meta.task),
        n_classes=int(meta.n_classes),
        n_bins_per_feature=(
            None if meta.n_bins_per_feature is None
            else np.array(meta.n_bins_per_feature)
        ),
        bin_edges=(
            None if meta.bin_edges is None else np.array(meta.bin_edges)
        ),
        n_train_obs=int(meta.n_train_obs),
        categorical=(
            None if meta.categorical is None else np.array(meta.categorical)
        ),
    )
    port_trees = [
        Tree(
            np.array(t.feature), np.array(t.threshold),
            np.array(t.children_left), np.array(t.children_right),
            np.array(t.node_fit),
        )
        for t in trees
    ]
    return Forest(port_trees, port_meta, np.array(fit_values))


def compressed_from_bytes(blob: bytes) -> CompressedForest:
    """Parse an RFS1 frame (written by either package) into the port's
    ``CompressedForest``; corruption raises the typed ``FramingError``s."""
    return CompressedForest.from_bytes(blob)


def model_from_arrays(model) -> ForestModel:
    """The port's ``ForestModel`` holding copies of a trained model's heap
    arrays (``feature``, ``threshold``, ``node_fit``, ``is_internal``,
    ``node_count``), its config's ``CartConfig`` fields, its binner's
    ``bin_edges`` / ``n_bins_per_feature`` / ``categorical`` and
    ``n_train_obs`` (duck-typed, like ``forest_from_arrays``)."""
    cfg = model.cfg
    binner = model.binner
    return ForestModel(
        feature=np.array(model.feature, np.int32),
        threshold=np.array(model.threshold, np.int32),
        node_fit=np.array(model.node_fit, np.float32),
        is_internal=np.array(model.is_internal, bool),
        node_count=np.array(model.node_count, np.float32),
        cfg=CartConfig(
            n_features=int(cfg.n_features),
            n_bins=int(cfg.n_bins),
            max_depth=int(cfg.max_depth),
            mtry=int(cfg.mtry),
            min_samples_leaf=int(cfg.min_samples_leaf),
            task=str(cfg.task),
            n_classes=int(cfg.n_classes),
        ),
        binner=Binner(
            np.array(binner.bin_edges),
            np.array(binner.n_bins_per_feature),
            np.array(binner.categorical),
        ),
        n_train_obs=int(model.n_train_obs),
    )


def _tensor(arr) -> torch.Tensor:
    """A CPU tensor copy of a numpy array (bfloat16 through its bits)."""
    a = np.ascontiguousarray(arr)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


@torch.no_grad()
def lm_params_from_arrays(cfg, params, device="cuda") -> TransformerLM:
    """The port's ``TransformerLM`` for ``cfg`` on ``device`` holding the
    numbers of a reference parameter pytree given as numpy arrays
    (``jax.tree.map(np.asarray, init_params(cfg, key))``; duck-typed dict
    access).  The reference stacks its layers on a leading L axis: layer i
    takes slice i of every ``params["layers"]`` leaf.  Both packages keep
    projection weights as (d_in, d_out), so nothing is transposed.  Raises
    ``ValueError`` on a missing, extra or misshapen leaf."""
    lm = TransformerLM(cfg, device)

    def put(dst: torch.Tensor, src, name: str) -> None:
        t = _tensor(src)
        if tuple(t.shape) != tuple(dst.shape):
            raise ValueError(
                f"{name}: shape {tuple(t.shape)}, expected {tuple(dst.shape)}"
            )
        dst.copy_(t)

    def put_all(module: torch.nn.Module, tree, i: int, prefix: str) -> None:
        names = {n for n, _ in module.named_parameters()}
        if set(tree) != names:
            raise ValueError(
                f"{prefix}: leaves {sorted(tree)}, expected {sorted(names)}"
            )
        for n, p in module.named_parameters():
            put(p, np.asarray(tree[n])[i], f"{prefix}.{n}[{i}]")

    put(lm.embed, params["embed"], "embed")
    put(lm.final_norm, params["final_norm"], "final_norm")
    if lm.lm_head is not None:
        put(lm.lm_head, params["lm_head"], "lm_head")
    layers = params["layers"]
    for i, blk in enumerate(lm.layers):
        put(blk.norm1, np.asarray(layers["norm1"])[i], f"norm1[{i}]")
        put(blk.norm2, np.asarray(layers["norm2"])[i], f"norm2[{i}]")
        put_all(blk.attn, layers["attn"], i, "attn")
        put_all(blk.mlp, layers["mlp"], i, "mlp")
    return lm
