"""Parameter / optimizer / batch / cache PartitionSpecs for the production
mesh, for every assigned architecture — the port of
``repro.launch.shardings``.

Strategy (the reference's):
  * TP over ``model``: attention head dims, FF hidden, vocab, expert dim.
  * ZeRO-3 FSDP over ``data``: the d_model dim of every weight matrix.
  * ``pod`` joins ``data`` for batch parallelism (multi-pod default).
  * KV caches: batch over data; kv-head dim over model when divisible,
    else the TIME dim over model (ragged head sharding would pad memory).

Every rule checks divisibility and falls back to replication — e.g.
hymba's vocab 32001 and granite's 49155 don't split 16 ways, so their
embeddings stay replicated rather than unevenly padded.

The port keeps one tensor a block where the reference stacks the blocks
of ``layers`` / ``layers_dense`` on a leading L axis.  So the specs are
keyed by the port's names (``named_parameters``: ``"layers.3.attn.wq"``;
a cache's ``["layers"][3]["k"]``), and a block's spec is the reference's
stacked spec without its leading ``None``.  ``reference_pspecs`` stacks
them back into the reference's tree, the layout of a checkpoint.

A sharding (``to_named``) is a ``NamedSharding``: the mesh and the spec,
read as DTensor placements (``Shard(dim)`` / ``Replicate()`` per mesh
dimension).  A mesh is a ``DeviceMesh`` or a ``launch.mesh.AbstractMesh``.

``shard_params`` gives this rank of a ``DeviceMesh`` its ``TransformerLM``
of shards, each leaf cut to ``NamedSharding.shard_shape`` at the rank's
(data, model) coordinate, taking the whole leaves one at a time (from
``models.init_leaves`` or ``convert.lm_shards_from_arrays``), so no rank
holds the whole model; a leaf that is already a DTensor under the
leaf's spec (``load_checkpoint(shardings=...)``) gives its local shard.
``init_cache_shards`` is ``init_cache`` in ``cache_pspecs``'s local
shapes.  ``shard_train_state`` is a train state of shards: the
parameters by ``shard_params``, the AdamW moments by ``opt_pspecs`` (like
the parameters: ``init_opt_state`` of the shards, or cut from given
moments), the step replicated, and with gradient compression its float32
error feedback cut like the parameters.  ``gather_whole`` is ``local_shard``'s
inverse.  Tensor-parallel serving and training run on them
(``models.tensor_parallel``, ``launch.steps``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch
from torch import nn

from ..configs.base import ModelConfig
from ..core.tensor_codec import _host
from ..device import resolve_device
from ..models.model import TransformerLM, init_cache, reference_path
from ..models.sharding import PartitionSpec as P
from ..models.sharding import (
    _axis_size,
    all_gather,
    axis_index,
    mesh_axis_names,
    mesh_shape,
)
from ..models.tensor_parallel import TPCache
from ..optim.adamw import init_opt_state
from ..optim.compression import init_error_feedback

__all__ = [
    "NamedSharding",
    "abstract_train_state",
    "batch_axes",
    "batch_spec",
    "cache_pspecs",
    "gather_whole",
    "init_cache_shards",
    "local_shard",
    "opt_pspecs",
    "param_pspecs",
    "placements",
    "reference_pspecs",
    "shard_params",
    "shard_train_state",
    "to_named",
]


def _div(mesh, dim: int, axis):
    """axis if dim divides evenly over it, else None (replicate)."""
    return axis if axis is not None and dim % _axis_size(mesh, axis) == 0 else None


def batch_axes(mesh):
    return ("pod", "data") if "pod" in mesh_axis_names(mesh) else "data"


def batch_spec(mesh, global_batch: int, rank: int) -> P:
    ba = _div(mesh, global_batch, batch_axes(mesh))
    if ba is None and global_batch % mesh_shape(mesh)["data"] == 0:
        ba = "data"
    return P(ba, *([None] * (rank - 1)))


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------
# name -> logical spec for the UNSTACKED leaf; "D" = d_model dim (FSDP over
# data), "M" = tensor-parallel dim (over model), "E" = expert dim.
_PARAM_RULES: dict[str, tuple[str | None, ...]] = {
    "embed": ("M", "D"),
    "lm_head": ("D", "M"),
    # attention (gqa)
    "wq": ("D", "M"), "wk": ("D", "M"), "wv": ("D", "M"), "wo": ("M", "D"),
    # dense mlp / shared expert
    "w1": ("D", "M"), "w3": ("D", "M"), "w2": ("M", "D"),
    # mla
    "w_dq": ("D", None), "w_uq": (None, "M"), "w_dkv": ("D", None),
    "w_kr": ("D", None), "w_uk": (None, "M"), "w_uv": (None, "M"),
    # rwkv6
    "w_r": ("D", "M"), "w_k": ("D", "M"), "w_v": ("D", "M"),
    "w_g": ("D", "M"), "w_o": ("M", "D"),
    "w_lora_a": ("D", None), "w_lora_b": (None, None),
    "u": (None, None), "mu": (None, None),
    # ssm (hymba)
    "w_in": ("D", "M"), "conv_w": (None, "M"), "w_dt": ("M", None),
    "w_b": ("M", None), "w_c": ("M", None), "a_log": ("M", None),
    "w_out": ("M", "D"),
    # mtp
    "proj": ("D", None),
}

# MoE expert tensors are matched by (name, rank) to avoid clashing with the
# dense-mlp names above.
_MOE_RULES: dict[str, tuple[str | None, ...]] = {
    "w1": ("E", "D", None),
    "w3": ("E", "D", None),
    "w2": ("E", None, "D"),
    "router": (None, None),
}


def _logical_to_mesh(mesh, logical: tuple[str | None, ...],
                     shape: tuple[int, ...]) -> P:
    out = []
    for name, dim in zip(logical, shape):
        if name == "D":
            out.append(_div(mesh, dim, "data"))
        elif name in ("M", "E"):
            out.append(_div(mesh, dim, "model"))
        else:
            out.append(None)
    return P(*out)


def _param_leaf_spec(mesh, name: str, shape: tuple[int, ...]) -> P:
    """The spec of one parameter of the port (a block's own tensor)."""
    keys = reference_path(name)[0].split("/")
    leaf = keys[-1]
    rule: tuple[str | None, ...] | None = None
    if "mlp" in keys and "shared" not in keys and leaf in _MOE_RULES:
        if len(shape) == len(_MOE_RULES[leaf]):
            rule = _MOE_RULES[leaf]
    if rule is None:
        rule = _PARAM_RULES.get(leaf)
    if rule is None or len(rule) != len(shape):
        rule = (None,) * len(shape)
    return _logical_to_mesh(mesh, rule, shape)


def param_pspecs(cfg: ModelConfig, mesh) -> dict[str, P]:
    """{parameter name: PartitionSpec} for ``init_params(cfg)``."""
    params = TransformerLM(cfg, "meta")
    return {n: _param_leaf_spec(mesh, n, tuple(p.shape))
            for n, p in params.named_parameters()}


def opt_pspecs(cfg: ModelConfig, mesh, pspecs=None):
    """Optimizer state mirrors the parameter sharding; step is replicated."""
    pspecs = pspecs if pspecs is not None else param_pspecs(cfg, mesh)
    return {"m": pspecs, "v": pspecs, "step": P()}


def reference_pspecs(pspecs: dict[str, P]) -> dict:
    """The reference's nested spec tree for ``{name: spec}``: a block's
    spec under its stacked leaf with a leading ``None`` (the L axis), as
    ``core.tensor_codec.flatten_pytree`` stacks a state for a
    checkpoint."""
    out: dict = {}
    for name, spec in pspecs.items():
        path, index = reference_path(name)
        node = out
        *parents, leaf = path.split("/")
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = spec if index is None else P(None, *spec)
    return out


# ---------------------------------------------------------------------------
# decode caches
# ---------------------------------------------------------------------------
def _cache_leaf_spec(mesh, name: str, shape: tuple[int, ...],
                     batch: int) -> P:
    """One layer's cache leaf (B, ...): the reference's stacked spec
    without its L entry."""
    ba = _div(mesh, batch, batch_axes(mesh)) or _div(mesh, batch, "data")
    body = shape[1:]
    if name in ("k", "v"):  # (B,T,KV,hd): prefer KV over model, else T
        t, kv = body[0], body[1]
        if kv % mesh_shape(mesh)["model"] == 0:
            return P(ba, None, "model", None)
        return P(ba, _div(mesh, t, "model"), None, None)
    if name in ("c_kv", "k_rope"):  # (B,T,r): shard T
        return P(ba, _div(mesh, body[0], "model"), None)
    if name == "state":  # rwkv6 (B,H,hd,hd)
        return P(ba, _div(mesh, body[0], "model"), None, None)
    if name in ("x_prev_tm", "x_prev_cm"):  # (B,d)
        return P(ba, _div(mesh, body[0], "model"))
    if name == "h":  # ssm (B,di,st)
        return P(ba, _div(mesh, body[0], "model"), None)
    if name == "conv":  # (B,3,di)
        return P(ba, None, _div(mesh, body[1], "model"))
    return P(ba, *([None] * len(body)))


def _cache_tree_specs(mesh, tree, batch: int, name: str = ""):
    if isinstance(tree, dict):
        return {k: _cache_tree_specs(mesh, v, batch, k)
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cache_tree_specs(mesh, v, batch, name) for v in tree]
    return _cache_leaf_spec(mesh, name, tuple(tree.shape), batch)


def cache_pspecs(cfg: ModelConfig, mesh, batch: int, max_len: int):
    """Specs shaped like ``init_cache(cfg, batch, max_len)``: a list of
    per-layer dicts under ``"layers"`` (and ``"layers_dense"``), ``"pos"``
    over the batch axes."""
    cache = init_cache(cfg, batch, max_len, device="meta")
    ba = _div(mesh, batch, batch_axes(mesh)) or _div(mesh, batch, "data")
    out = {k: _cache_tree_specs(mesh, v, batch)
           for k, v in cache.items() if k != "pos"}
    out["pos"] = P(ba)
    return out


# ---------------------------------------------------------------------------
# shardings: the mesh plus DTensor placements
# ---------------------------------------------------------------------------
def placements(axis_names: tuple[str, ...], spec: P) -> tuple:
    """DTensor placements of ``spec`` over a mesh with ``axis_names``:
    ``Shard(dim)`` on each mesh dimension that shards tensor dim ``dim``,
    ``Replicate()`` on the others."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for a in axis_names:
        dims = [i for i, e in enumerate(spec)
                if e == a or (isinstance(e, tuple) and a in e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (``jax.sharding.NamedSharding``'s counterpart)."""

    mesh: Any
    spec: P

    @property
    def placements(self) -> tuple:
        return placements(mesh_axis_names(self.mesh), self.spec)

    def shard_shape(self, shape) -> tuple[int, ...]:
        """The local shape of a ``shape`` tensor under this sharding."""
        out = list(shape)
        for i, e in enumerate(self.spec):
            out[i] //= _axis_size(self.mesh, e)
        return tuple(out)


def to_named(mesh, pspecs):
    """The same tree with each PartitionSpec made a ``NamedSharding``."""
    if isinstance(pspecs, P):
        return NamedSharding(mesh, pspecs)
    if isinstance(pspecs, dict):
        return {k: to_named(mesh, v) for k, v in pspecs.items()}
    if isinstance(pspecs, (list, tuple)):
        return type(pspecs)(to_named(mesh, v) for v in pspecs)
    return pspecs


def abstract_train_state(cfg: ModelConfig):
    """(params, opt_state) on the ``meta`` device — no allocation."""
    params = TransformerLM(cfg, "meta")
    return params, init_opt_state(params)


# ---------------------------------------------------------------------------
# this rank's shards
# ---------------------------------------------------------------------------
def local_shard(t: torch.Tensor, spec: P, mesh) -> torch.Tensor:
    """The view of the whole ``t`` that this rank of the ``DeviceMesh``
    holds under ``spec``: each sharded dim cut into the axis' size and the
    rank's block kept (``NamedSharding(mesh, spec).shard_shape``)."""
    for dim, axis in enumerate(spec):
        if axis is not None:
            n = t.shape[dim] // _axis_size(mesh, axis)
            t = t.narrow(dim, axis_index(axis, mesh) * n, n)
    return t


def gather_whole(t: torch.Tensor, spec: P, mesh) -> torch.Tensor:
    """The whole tensor from this rank's ``local_shard`` under ``spec``:
    each sharded dim all-gathered over its axes (every rank gets it)."""
    for dim, axis in enumerate(spec):
        if axis is not None:
            t = all_gather(t, axis, dim, mesh=mesh)
    return t


def _local(whole, spec: P, mesh) -> torch.Tensor:
    """This rank's shard of a leaf: cut from a whole tensor or numpy
    array, or a DTensor's local shard (its placements must be
    ``spec``'s)."""
    from torch.distributed.tensor import DTensor

    if isinstance(whole, DTensor):
        want = placements(mesh_axis_names(mesh), spec)
        if tuple(whole.placements) != want:
            raise ValueError(f"DTensor placed {whole.placements}, the spec "
                             f"{spec} places {want}")
        return whole.to_local()
    t = whole.detach() if isinstance(whole, torch.Tensor) else _host(whole)
    return local_shard(t, spec, mesh)


def _data_dim(spec: P) -> int | None:
    return next((i for i, a in enumerate(spec)
                 if a == "data" or (isinstance(a, tuple) and "data" in a)),
                None)


@torch.no_grad()
def shard_params(cfg: ModelConfig, leaves, mesh,
                 device="cuda") -> TransformerLM:
    """This rank's ``TransformerLM`` on ``device``: every parameter its
    local shard under ``param_pspecs(cfg, mesh)`` (``mesh`` a
    ``DeviceMesh``).  ``leaves`` yields (parameter name, whole tensor or
    numpy array) and is read one leaf at a time: each is cut, its shard
    copied to ``device`` and the whole dropped (``models.init_leaves``,
    ``convert.lm_shards_from_arrays``, or a ``TransformerLM``'s
    ``named_parameters()``); a DTensor leaf gives its local shard.
    Raises ``ValueError`` on an unknown, misshapen, repeated or missing
    leaf.  The model carries ``mesh``, each parameter's spec
    (``pspecs``) and its dim cut over ``data`` (``fsdp_dims``)."""
    dev = resolve_device(device)
    specs = param_pspecs(cfg, mesh)
    lm = TransformerLM(cfg, "meta")
    modules = dict(lm.named_modules())
    metas = dict(lm.named_parameters())
    seen: set[str] = set()
    for name, whole in leaves:
        if name not in specs or name in seen:
            raise ValueError(f"unknown or repeated leaf {name!r}")
        meta = metas[name]
        if tuple(whole.shape) != tuple(meta.shape):
            raise ValueError(f"{name}: shape {tuple(whole.shape)}, "
                             f"expected {tuple(meta.shape)}")
        local = _local(whole, specs[name], mesh).to(dev, meta.dtype)
        owner, _, leaf = name.rpartition(".")
        setattr(modules[owner], leaf, nn.Parameter(
            local.clone(memory_format=torch.contiguous_format),
            requires_grad=False))
        seen.add(name)
        del local, whole
    if seen != set(specs):
        raise ValueError(f"missing leaves {sorted(set(specs) - seen)}")
    lm.mesh = mesh
    lm.pspecs = specs
    lm.fsdp_dims = {n: _data_dim(sp) for n, sp in specs.items()}
    return lm


def shard_train_state(cfg: ModelConfig, leaves, mesh, device="cuda",
                      opt=None, grad_comp=None) -> dict:
    """This rank's train state ``{"params": TransformerLM, "opt": {"m",
    "v", "step"[, "ef"]}}``: the parameters by ``shard_params`` from
    ``leaves``; without ``opt`` the moments zero in the shards' shapes and
    types (``init_opt_state`` of the shards: ``opt_pspecs``' shard
    shapes), else cut from ``opt`` = {"m": (name, whole) pairs, "v":
    likewise, "step": a scalar[, "ef": (name, whole) pairs]}, a leaf at a
    time, in each leaf's own type (DTensor leaves give their local
    shards); the step an int32 0-d tensor.  The error feedback of
    gradient compression (``grad_comp`` enabled, as
    ``launch.train.build_state`` takes it, or an ``"ef"`` in ``opt``) is
    cut like the gradients: each leaf float32 in its parameter's shard
    shape, zero unless ``opt`` carries it."""
    dev = resolve_device(device)
    params = shard_params(cfg, leaves, mesh, dev)
    if opt is None:
        state = {"params": params, "opt": init_opt_state(params)}
    else:
        state = {"params": params,
                 "opt": _cut_opt(cfg, params, mesh, dev, opt)}
    if "ef" not in state["opt"] and grad_comp is not None \
            and grad_comp.enabled:
        state["opt"]["ef"] = init_error_feedback(params)
    return state


def _cut_opt(cfg: ModelConfig, params, mesh, dev, opt) -> dict:
    """``shard_train_state``'s optimizer state cut from ``opt``."""
    specs = dict(opt_pspecs(cfg, mesh, params.pspecs), ef=params.pspecs)
    new = {}
    for key in ("m", "v", "ef") if "ef" in opt else ("m", "v"):
        new[key] = {}
        for name, whole in opt[key]:
            if name not in specs[key] or name in new[key]:
                raise ValueError(f"unknown or repeated {key} leaf {name!r}")
            new[key][name] = _local(whole, specs[key][name], mesh).to(
                dev).clone(memory_format=torch.contiguous_format)
        if set(new[key]) != set(specs[key]):
            raise ValueError(f"missing {key} leaves "
                             f"{sorted(set(specs[key]) - set(new[key]))}")
    if "ef" in new:
        new["ef"] = {n: t.float() for n, t in new["ef"].items()}
    new["step"] = _local(opt["step"], specs["step"], mesh).to(
        dev, torch.int32).reshape(())
    return new


def init_cache_shards(cfg: ModelConfig, batch: int, max_len: int, mesh,
                      device="cuda") -> TPCache:
    """``init_cache(cfg, batch, max_len)`` in this rank's local shapes under
    ``cache_pspecs`` (zeros), as a ``TPCache`` that knows ``max_len``."""
    dev = resolve_device(device)
    specs = cache_pspecs(cfg, mesh, batch, max_len)
    meta = init_cache(cfg, batch, max_len, device="meta")

    def build(tree, spec):
        if isinstance(tree, dict):
            return {k: build(v, spec[k]) for k, v in tree.items()}
        if isinstance(tree, list):
            return [build(v, sp) for v, sp in zip(tree, spec)]
        shape = NamedSharding(mesh, spec).shard_shape(tree.shape)
        return torch.zeros(shape, dtype=tree.dtype, device=dev)

    return TPCache(build(meta, specs), max_len=max_len)
