"""Logical-axis sharding annotations and the mesh's collectives — the port
of ``repro.models.sharding``.

Model code annotates activations with LOGICAL axis names; the launcher
installs a rules table mapping logical names -> mesh axes
(``logical_sharding``).  Without rules every annotation is a no-op, so the
same model code runs everywhere.

The port does not execute the annotations as a tensor-parallel layout:
under a mesh every rank holds whole activations (ROADMAP lists
tensor-parallel execution as an item of its own).  What the mesh changes
in the port is what the reference computes by hand under ``shard_map``:
the head padding (``models.attention._shard_qkv``), the expert-parallel
MoE dispatch (``models.moe._moe_apply_ep``), the wire-level gradient sum
(``optim.compression.wire_quantized_psum``) and the FSDP train step
(``launch.steps.make_wire_train_step``).  They use this module's
named-axis collectives (``psum``, ``pmax``, ``pmean``, ``all_gather``,
``axis_index``, ``axis_size``), the counterparts of ``jax.lax``'s, over
the process groups of a ``torch.distributed`` ``DeviceMesh``.

A mesh is a ``DeviceMesh`` (``launch.mesh.make_host_mesh``) or a
device-free ``launch.mesh.AbstractMesh``; ``mesh_shape`` reads either as
{axis name: size}.

Transports.  Each collective runs on the tensor where it lies, CUDA
tensors included (gloo, the backend of ranks that share one card, takes
them; on the H100 it took every collective of ``chip_smoke.py``'s phase
15 directly).  Gloo has no sum of int16 tensors: an int16 sum or max is
carried as int32 (exact, the same integers).  ``TRANSPORTS`` records how
each (collective, dtype, device) was carried.  The collectives carry no
autograd.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager

import torch

__all__ = [
    "PartitionSpec",
    "TRANSPORTS",
    "all_gather",
    "ax",
    "axis_index",
    "axis_size",
    "batch_axes_in",
    "current_mesh",
    "current_rules",
    "logical_sharding",
    "mesh_axis_names",
    "mesh_shape",
    "multi_pod_rules",
    "pmax",
    "pmean",
    "psum",
    "single_pod_rules",
    "spec_for",
]

_state = threading.local()


class PartitionSpec(tuple):
    """A tuple of mesh axes, one entry per tensor dimension: ``None``
    (replicated), an axis name, or a tuple of axis names.  Entries compare
    with the reference's ``jax.sharding.PartitionSpec`` one by one."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def current_rules() -> dict[str, tuple[str, ...] | str | None] | None:
    return getattr(_state, "rules", None)


def current_mesh():
    return getattr(_state, "mesh", None)


@contextmanager
def logical_sharding(mesh, rules: dict[str, tuple[str, ...] | str | None]):
    """rules: logical axis name -> mesh axis (or tuple of axes, or None).
    Thread-local, as in the reference."""
    old_rules = getattr(_state, "rules", None)
    old_mesh = getattr(_state, "mesh", None)
    _state.rules, _state.mesh = rules, mesh
    try:
        yield
    finally:
        _state.rules, _state.mesh = old_rules, old_mesh


def batch_axes_in():
    """Mesh axis (or tuple) the logical 'batch' axis maps to, or None."""
    rules = current_rules() or {}
    return rules.get("batch")


def spec_for(*logical_names: str | None) -> PartitionSpec:
    rules = current_rules() or {}
    return P(*(rules.get(n) if n is not None else None for n in logical_names))


def mesh_shape(mesh) -> dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or an ``AbstractMesh``."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


def mesh_axis_names(mesh) -> tuple[str, ...]:
    return tuple(mesh_shape(mesh))


def _axis_size(mesh, axis) -> int:
    if axis is None:
        return 1
    shape = mesh_shape(mesh)
    if isinstance(axis, tuple):
        n = 1
        for a in axis:
            n *= shape[a]
        return n
    return shape[axis]


def ax(x: torch.Tensor, *logical_names: str | None) -> torch.Tensor:
    """Annotate activation ``x`` (rank must match names; None = replicated).

    A layout statement only: ``x`` is returned unchanged, since the port
    runs whole activations on every rank (the reference's GSPMD shards
    them by the rules, with axes whose dim doesn't divide the mesh axis
    replicated).  The names are checked against the rank.
    """
    if current_mesh() is not None and len(logical_names) != x.dim():
        raise ValueError(f"{len(logical_names)} names for a {x.dim()}-d "
                         "tensor")
    return x


# ---------------------------------------------------------------------------
# named-axis collectives over a DeviceMesh's process groups
# ---------------------------------------------------------------------------
#: (collective, dtype, device type) -> how it was carried: "<backend>
#: direct", or "<backend> as int32" (an int16 sum gloo has no kernel for)
TRANSPORTS: dict[str, str] = {}

_GLOO_WIDEN = {torch.int16: torch.int32}


def _mesh(mesh):
    mesh = mesh if mesh is not None else current_mesh()
    if mesh is None or not hasattr(mesh, "get_group"):
        raise RuntimeError("a collective needs a DeviceMesh: install one "
                           "with logical_sharding(mesh, rules) or pass it")
    return mesh


def _axes(axis) -> tuple[str, ...]:
    return axis if isinstance(axis, tuple) else (axis,)


def _carry(kind: str, x: torch.Tensor, group, run) -> torch.Tensor:
    """``run(t, group)`` (an in-place collective on ``t``, or one returning
    its result) on a copy of ``x`` in a dtype this backend sums; the
    result in ``x``'s dtype."""
    import torch.distributed as dist

    backend = dist.get_backend(group)
    wide = _GLOO_WIDEN.get(x.dtype) if backend == "gloo" else None
    how = f"as {str(wide).removeprefix('torch.')}" if wide else "direct"
    key = f"{kind} {str(x.dtype).removeprefix('torch.')} {x.device.type}"
    TRANSPORTS[key] = f"{backend} {how}"
    t = x.to(wide) if wide is not None else x.clone()
    out = run(t, group)
    return (out if out is not None else t).to(x.dtype)


def _reduce(kind: str, op, x: torch.Tensor, axis, mesh) -> torch.Tensor:
    import torch.distributed as dist

    mesh = _mesh(mesh)

    def run(t, group):
        dist.all_reduce(t, op=op, group=group)

    for a in _axes(axis):
        if mesh_shape(mesh)[a] > 1:
            x = _carry(kind, x, mesh.get_group(a), run)
    return x


def psum(x: torch.Tensor, axis, mesh=None) -> torch.Tensor:
    """Sum of ``x`` over the mesh axis (or tuple of axes), on every rank."""
    import torch.distributed as dist

    return _reduce("all_reduce sum", dist.ReduceOp.SUM, x, axis, mesh)


def pmax(x: torch.Tensor, axis, mesh=None) -> torch.Tensor:
    """Elementwise max of ``x`` over the mesh axis, on every rank."""
    import torch.distributed as dist

    return _reduce("all_reduce max", dist.ReduceOp.MAX, x, axis, mesh)


def pmean(x: torch.Tensor, axis, mesh=None) -> torch.Tensor:
    """``psum(x) / axis_size``, as ``jax.lax.pmean``."""
    return psum(x, axis, mesh) / axis_size(axis, mesh)


def all_gather(x: torch.Tensor, axis, dim: int = 0, tiled: bool = True,
               mesh=None) -> torch.Tensor:
    """The ranks' ``x`` along ``dim`` in axis-index order: concatenated
    (``tiled``) or stacked on a new ``dim``, as ``jax.lax.all_gather``.
    A tuple of axes gathers its minor axis first, so the order is the
    tuple's combined index."""
    import torch.distributed as dist

    mesh = _mesh(mesh)
    if not tiled:
        x = x.unsqueeze(dim)

    def run(t, group):
        parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, t.contiguous(), group=group)
        return torch.cat(parts, dim)

    for a in reversed(_axes(axis)):
        if mesh_shape(mesh)[a] > 1:
            x = _carry("all_gather", x, mesh.get_group(a), run)
    return x


def axis_index(axis, mesh=None) -> int:
    """This rank's index along the mesh axis (a tuple: the combined
    row-major index)."""
    mesh = _mesh(mesh)
    idx = 0
    for a in _axes(axis):
        idx = idx * mesh_shape(mesh)[a] + mesh.get_local_rank(a)
    return idx


def axis_size(axis, mesh=None) -> int:
    mesh = mesh if mesh is not None else current_mesh()
    return _axis_size(mesh, axis)


# standard rules tables -------------------------------------------------------
def single_pod_rules() -> dict[str, tuple[str, ...] | str | None]:
    return {
        "batch": "data",
        "seq": None,
        "seq_sp": "model",  # sequence parallelism for long prefill
        "d_model": None,
        "d_model_fsdp": "data",  # param d_model dim: ZeRO-3 over data
        "heads": "model",
        "kv_heads": "model",
        "head_dim": None,
        "ff": "model",
        "vocab": "model",
        "experts": "model",
        "layers": None,
        "state": None,
    }


def multi_pod_rules(pipeline: bool = False) -> dict[str, tuple[str, ...] | str | None]:
    rules = single_pod_rules()
    if pipeline:
        rules["layers"] = "pod"  # pipeline stages over the pod axis
    else:
        rules["batch"] = ("pod", "data")  # pod axis joins data parallelism
    return rules
