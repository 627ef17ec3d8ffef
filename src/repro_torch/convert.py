"""Carry state across from the JAX reference to the port, and back.

The RFS1 frame bytes (``docs/format.md``) are the interchange format:
bytes one package writes, the other reads.  ``forest_from_arrays`` turns
an uncompressed reference ``Forest`` into the port's from its numpy
fields alone (duck-typed: anything with ``feature``, ``threshold``,
``children_left``, ``children_right`` and ``node_fit`` per tree, and a
meta with the ``ForestMeta`` fields).  ``model_from_arrays`` carries a
trained reference ``ForestModel`` (heap arrays, ``CartConfig``, ``Binner``)
across the same way, and ``lm_params_from_arrays`` a reference LM's
parameter pytree (numpy arrays or torch tensors) into the port's
``TransformerLM``; ``lm_params_to_arrays`` is its inverse, and
``lm_shards_from_arrays`` carries the same pytree onto a rank of a mesh
as its shards only (``launch.shardings.shard_params``), and
``train_state_shards_from_arrays`` a whole train state (the AdamW
moments and step too; ``launch.shardings.shard_train_state``), from the
reference's arrays or from a checkpoint restored onto the mesh as
DTensors (``load_checkpoint(shardings=...)``).
``train_state_to_arrays`` / ``train_state_from_arrays`` carry a whole
train state — parameters, the AdamW moments and step, and the gradient
compression's error feedback ``"ef"`` — between the port's form (a
``TransformerLM`` and ``{name: tensor}`` dicts) and the reference's
pytree, layers stacked on a leading L axis: the layout of a checkpoint
either package writes.  Nothing here imports the reference.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.forest_codec import CompressedForest
from .core.tensor_codec import _host, flatten_pytree, unflatten_pytree
from .core.tree import Forest, ForestMeta, Tree
from .device import resolve_device
from .forest.binning import Binner
from .forest.cart import CartConfig
from .forest.forest import ForestModel
from .models.model import TransformerLM, reference_path

__all__ = [
    "compressed_from_bytes",
    "forest_from_arrays",
    "lm_params_from_arrays",
    "lm_params_to_arrays",
    "lm_shards_from_arrays",
    "model_from_arrays",
    "train_state_shards_from_arrays",
    "train_state_from_arrays",
    "train_state_to_arrays",
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
    """A tensor of a torch tensor (itself) or a CPU tensor copy of a numpy
    array (bfloat16 through its bits)."""
    if isinstance(arr, torch.Tensor):
        return arr.detach()
    return _host(arr)


def _leaves(tree, prefix: str = "") -> dict:
    """A nested dict of arrays as {dotted name: array}, the names
    ``named_parameters`` gives the matching module."""
    out = {}
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if hasattr(val, "items"):
            out.update(_leaves(val, f"{name}."))
        else:
            out[name] = val
    return out


@torch.no_grad()
def lm_params_from_arrays(cfg, params, device="cuda") -> TransformerLM:
    """The port's ``TransformerLM`` for ``cfg`` on ``device`` holding the
    numbers of a reference parameter pytree given as numpy arrays
    (``jax.tree.map(np.asarray, init_params(cfg, key))``; duck-typed dict
    access) or torch tensors.  The reference stacks its layers on a leading L axis: block
    i of ``layers`` (and of ``layers_dense``, an MoE config's leading
    dense blocks) takes slice i of every leaf of that tree; ``mtp``'s
    block is not stacked.  Every leaf carries across by its dotted name
    (``attn.wq``, ``mlp.shared.w1``, ``ssm.a_log``, ``branch_beta``, ...),
    the MoE router in float32.  Both packages keep projection weights as
    (d_in, d_out), so nothing is transposed.  Raises ``ValueError`` on a
    missing, extra or misshapen leaf, and on a missing or unexpected
    top-level key."""
    lm = TransformerLM(cfg, device)

    def put(dst: torch.Tensor, src, name: str) -> None:
        t = _tensor(src)
        if tuple(t.shape) != tuple(dst.shape):
            raise ValueError(
                f"{name}: shape {tuple(t.shape)}, expected {tuple(dst.shape)}"
            )
        dst.copy_(t)

    def put_module(module: torch.nn.Module, tree, prefix: str,
                   index: int | None = None, count: int = 0) -> None:
        """Fill ``module`` from ``tree``; with ``index``, every leaf is a
        stack of ``count`` and slice ``index`` is taken."""
        leaves = _leaves(tree)
        names = dict(module.named_parameters())
        if set(leaves) != set(names):
            raise ValueError(
                f"{prefix}: leaves {sorted(leaves)}, expected {sorted(names)}"
            )
        for n, p in names.items():
            arr = leaves[n]
            if index is None:
                put(p, arr, f"{prefix}.{n}")
                continue
            if tuple(arr.shape) != (count, *p.shape):
                raise ValueError(
                    f"{prefix}.{n}: shape {tuple(arr.shape)}, expected "
                    f"{(count, *p.shape)}"
                )
            put(p, arr[index], f"{prefix}.{n}[{index}]")

    want = {"embed", "final_norm", "layers"}
    if lm.lm_head is not None:
        want.add("lm_head")
    if len(lm.layers_dense):
        want.add("layers_dense")
    if lm.mtp is not None:
        want.add("mtp")
    if set(params) != want:
        raise ValueError(
            f"top-level keys {sorted(params)}, expected {sorted(want)}"
        )
    put(lm.embed, params["embed"], "embed")
    put(lm.final_norm, params["final_norm"], "final_norm")
    if lm.lm_head is not None:
        put(lm.lm_head, params["lm_head"], "lm_head")
    for key in ("layers_dense", "layers"):
        blocks = getattr(lm, key)
        for i, blk in enumerate(blocks):
            put_module(blk, params[key], key, i, len(blocks))
    if lm.mtp is not None:
        put_module(lm.mtp, params["mtp"], "mtp")
    return lm


def _block_leaves(cfg, tree, mesh=None):
    """(parameter name, its whole leaf) of a reference-layout ``tree``, one
    at a time: a block's slice of its stacked leaf.  A DTensor's slice is
    a DTensor of its local slice, placed as the block's spec places it
    (the L axis is never cut)."""
    specs = None
    for name, _ in TransformerLM(cfg, "meta").named_parameters():
        path, index = reference_path(name)
        leaf = tree
        for part in path.split("/"):
            if part not in leaf:
                raise ValueError(f"missing leaf {path!r}")
            leaf = leaf[part]
        if index is not None:
            if hasattr(leaf, "to_local"):
                from torch.distributed.tensor import DTensor

                from .launch.shardings import param_pspecs, placements

                specs = specs or param_pspecs(cfg, mesh)
                leaf = DTensor.from_local(
                    leaf.to_local()[index], mesh,
                    placements(tuple(mesh.mesh_dim_names), specs[name]),
                    run_check=False)
            else:
                leaf = leaf[index]
        yield name, leaf


def lm_shards_from_arrays(cfg, params, mesh, device="cuda") -> TransformerLM:
    """This rank's ``TransformerLM`` of shards (``shard_params``) holding
    the numbers of a reference parameter pytree (numpy arrays or torch
    tensors, layers stacked on a leading L axis): each leaf's slice for
    a block (or the leaf itself) is read, cut to this rank's shard and
    dropped, one leaf at a time.  Raises ``ValueError`` on a missing or
    misshapen leaf."""
    from .launch.shardings import shard_params

    return shard_params(cfg, _block_leaves(cfg, params, mesh), mesh, device)


def train_state_shards_from_arrays(cfg, state, mesh, device="cuda") -> dict:
    """This rank's train state of shards (``shard_train_state``) from the
    reference's pytree ``{"params", "opt": {"m", "v", "step"[, "ef"]}}``
    (numpy arrays, torch tensors, or the DTensors ``load_checkpoint(
    shardings=...)`` places on ``mesh``, whose local shards are taken as
    they are)."""
    from .launch.shardings import shard_train_state

    opt = dict(state["opt"])
    cut = {k: _block_leaves(cfg, opt.pop(k), mesh)
           for k in ("m", "v", "ef") if k in opt}
    return shard_train_state(
        cfg, _block_leaves(cfg, state["params"], mesh), mesh, device,
        opt=dict(cut, step=opt["step"]))


def lm_params_to_arrays(cfg, lm: TransformerLM) -> dict:
    """The reference's parameter pytree of ``lm``: nested dicts of CPU
    tensors, every block of ``layers`` (and ``layers_dense``) stacked on a
    leading L axis, each leaf in its own type (bfloat16 stays bfloat16;
    its bits are the numbers).  The inverse of ``lm_params_from_arrays``.
    Raises ``ValueError`` when ``lm`` was built for another config."""
    if lm.cfg != cfg:
        raise ValueError(f"lm holds {lm.cfg.name!r}, not {cfg.name!r}")
    return unflatten_pytree(flatten_pytree(lm))


def train_state_to_arrays(state) -> dict:
    """A train state (``{"params": TransformerLM, "opt": {"m": {name:
    tensor}, "v": ..., "step"[, "ef"]}}``) as the reference's pytree of
    CPU tensors: ``{"params": ..., "opt": {"m": ..., "v": ..., "step":
    int32, ["ef": ...]}}``, blocks stacked as in
    ``lm_params_to_arrays``."""
    return unflatten_pytree(flatten_pytree(state))


def _unstack(lm: TransformerLM, tree, what: str, device) -> dict:
    """{parameter name: its slice of the reference-layout ``tree``}."""
    out = {}
    for name, p in lm.named_parameters():
        path, index = reference_path(name)
        leaf = tree
        for part in path.split("/"):
            leaf = leaf[part]
        t = _tensor(leaf if index is None else leaf[index])
        if tuple(t.shape) != tuple(p.shape):
            raise ValueError(
                f"{what} {name}: shape {tuple(t.shape)}, expected "
                f"{tuple(p.shape)}"
            )
        out[name] = t.to(device).clone()
    return out


def train_state_from_arrays(cfg, state, device="cuda") -> dict:
    """The port's train state on ``device`` from the reference's pytree
    (numpy arrays or torch tensors, as ``load_checkpoint`` returns it):
    the parameters through ``lm_params_from_arrays``, the moments and the
    error feedback unstacked by parameter name in their own types, the
    step an int32 0-d tensor.  A state whose ``"params"`` is already a
    ``TransformerLM`` is returned as it is."""
    if isinstance(state["params"], TransformerLM):
        return state
    dev = resolve_device(device)
    lm = lm_params_from_arrays(cfg, state["params"], dev)
    opt = state["opt"]
    new_opt = {
        key: _unstack(lm, opt[key], key, dev)
        for key in ("m", "v", "ef") if key in opt
    }
    new_opt["step"] = _tensor(opt["step"]).to(dev, torch.int32).reshape(())
    return {"params": lm, "opt": new_opt}
