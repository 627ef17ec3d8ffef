"""Logical-axis sharding annotations and the mesh's collectives — the port
of ``repro.models.sharding``.

Model code annotates activations with LOGICAL axis names; the launcher
installs a rules table mapping logical names -> mesh axes
(``logical_sharding``).  Without rules every annotation is a no-op, so the
same model code runs everywhere.

Under a mesh the port executes the layout SPMD: each rank of a
``torch.distributed`` ``DeviceMesh`` holds its shard of every parameter
(``launch.shardings.shard_params``) and computes its shard of every
activation (``models.tensor_parallel``), where the reference's GSPMD
partitions one global program.  ``ax`` is then the layout's check: while
a tensor-parallel call runs it installs the global size of each logical
axis (``logical_sizes``), and an annotated tensor whose local shape is
not its shard shape raises ``LayoutError`` at the annotation (where the
reference would reshard).  A model run under a mesh with whole
parameters (the families the port does not yet split: Hymba's padded
heads, RWKV6, MLA) keeps whole activations on every rank, and there
``ax`` checks the names against the rank only.  The collectives
(``psum``, ``psum_scatter``, ``pmax``, ``pmean``, ``all_gather``,
``axis_index``, ``axis_size``) are the counterparts of ``jax.lax``'s over
the process groups of the ``DeviceMesh``.  The expert-parallel MoE
dispatch (``models.moe._moe_apply_ep``), the wire-level gradient sum
(``optim.compression.wire_quantized_psum``) and the FSDP train step
(``launch.steps.make_wire_train_step``) use them too.

A mesh is a ``DeviceMesh`` (``launch.mesh.make_host_mesh``) or a
device-free ``launch.mesh.AbstractMesh``; ``mesh_shape`` reads either as
{axis name: size}.

Transports.  Each collective runs on the tensor where it lies, CUDA
tensors included (gloo, the backend of ranks that share one card, takes
them; on the H100 it took every collective of ``chip_smoke.py``'s phase
15 directly).  Gloo has no sum of int16 tensors: an int16 sum or max is
carried as int32 (exact, the same integers); gloo takes
``reduce_scatter_tensor`` (``psum_scatter``) on CPU and CUDA tensors
alike.  ``TRANSPORTS`` records how each (collective, dtype, device) was
carried.  The collectives carry no autograd.

Timing.  Inside ``collective_timing()`` each collective on this thread is
timed on the host, the card synchronised before and after it, behind a
barrier of its group: the barrier's time (``wait_s``: the ranks arriving
at different times) and the collective's own (``s``) are added to its
kind, with its calls and bytes (its input's).  Off, it costs one
attribute read a collective.
"""
from __future__ import annotations

import threading
import time
from contextlib import contextmanager

import torch

__all__ = [
    "LayoutError",
    "PartitionSpec",
    "TRANSPORTS",
    "all_gather",
    "ax",
    "axis_index",
    "axis_size",
    "batch_axes_in",
    "collective_timing",
    "current_mesh",
    "current_rules",
    "logical_sharding",
    "logical_sizes",
    "mesh_axis_names",
    "mesh_shape",
    "multi_pod_rules",
    "pmax",
    "pmean",
    "psum",
    "psum_scatter",
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


class LayoutError(ValueError):
    """A tensor-parallel activation whose local shape is not its shard
    shape under the installed rules."""


def current_sizes() -> dict[str, int] | None:
    return getattr(_state, "sizes", None)


@contextmanager
def logical_sizes(sizes: dict[str, int]):
    """The global size of each logical axis in the tensor-parallel call
    running on this thread ({"batch": B, "seq_sp": S, "heads": H, ...}):
    what ``ax`` checks local shapes against.  Thread-local."""
    old = getattr(_state, "sizes", None)
    _state.sizes = dict(sizes)
    try:
        yield
    finally:
        _state.sizes = old


def _shard_size(mesh, size: int, axis) -> int:
    """The local size of a global ``size`` dimension sharded over ``axis``:
    ``size / axis size`` where that divides, else ``size`` (replicated, the
    reference's guard against ragged shards)."""
    n = _axis_size(mesh, axis)
    return size // n if size % n == 0 else size


def ax(x: torch.Tensor, *logical_names: str | None) -> torch.Tensor:
    """Annotate activation ``x`` (rank must match names; None = replicated).

    Under a mesh, while a tensor-parallel call has installed its global
    sizes (``logical_sizes``), each named dimension of ``x`` must be its
    shard of the global size under the rules (``_shard_size``: whole where
    the axis does not divide it): otherwise ``LayoutError``.  A dimension
    named ``None`` is not checked.  Without sizes (whole activations on
    every rank) only the rank is checked.  Returns ``x``.
    """
    mesh = current_mesh()
    if mesh is None:
        return x
    if len(logical_names) != x.dim():
        raise ValueError(f"{len(logical_names)} names for a {x.dim()}-d "
                         "tensor")
    sizes = current_sizes()
    if sizes is None:
        return x
    rules = current_rules() or {}
    for dim, (name, got) in enumerate(zip(logical_names, x.shape)):
        if name is None:
            continue
        if name not in sizes:
            raise LayoutError(f"no global size for logical axis {name!r}")
        want = _shard_size(mesh, sizes[name], rules.get(name))
        if got != want:
            raise LayoutError(
                f"dim {dim} ({name!r}, global {sizes[name]} over "
                f"{rules.get(name)!r}) is {got} on this rank, its shard "
                f"is {want}: local shape {tuple(x.shape)}")
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


@contextmanager
def collective_timing():
    """Time this thread's collectives while inside: yields {kind: {"calls",
    "bytes", "wait_s", "s"}}, filled as they run (``_carry``).  Before
    each, the card's queue is drained (``torch.cuda.synchronize()`` on a
    CUDA tensor) and the group meets at a barrier (``wait_s``); ``s`` is
    the collective itself, to the next synchronize."""
    old = getattr(_state, "times", None)
    _state.times = times = {}
    try:
        yield times
    finally:
        _state.times = old


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
    times = getattr(_state, "times", None)
    if times is not None:
        if x.is_cuda:
            torch.cuda.synchronize(x.device)
        t0 = time.perf_counter()
        dist.barrier(group=group)
        t1 = time.perf_counter()
    t = x.to(wide) if wide is not None else x.clone()
    out = run(t, group)
    out = (out if out is not None else t).to(x.dtype)
    if times is not None:
        if x.is_cuda:
            torch.cuda.synchronize(x.device)
        row = times.setdefault(kind, {"calls": 0, "bytes": 0, "wait_s": 0.0,
                                      "s": 0.0})
        row["calls"] += 1
        row["bytes"] += x.numel() * x.element_size()
        row["wait_s"] += t1 - t0
        row["s"] += time.perf_counter() - t1
    return out


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


def psum_scatter(x: torch.Tensor, axis: str, dim: int = 0,
                 mesh=None) -> torch.Tensor:
    """The sum of ``x`` over the mesh axis, cut along ``dim`` into axis-size
    blocks, this rank keeping the block of its axis index:
    ``jax.lax.psum_scatter(..., scatter_dimension=dim, tiled=True)``.
    ``x.shape[dim]`` must divide by the axis size."""
    import torch.distributed as dist

    mesh = _mesh(mesh)
    n = mesh_shape(mesh)[axis]
    if n == 1:
        return x
    if x.shape[dim] % n:
        raise ValueError(f"psum_scatter: dim {dim} of {tuple(x.shape)} "
                         f"does not divide over {axis!r} ({n})")

    def run(t, group):
        t = t.movedim(dim, 0).contiguous()
        out = t.new_empty((t.shape[0] // n, *t.shape[1:]))
        dist.reduce_scatter_tensor(out, t, group=group)
        return out.movedim(0, dim)

    return _carry("reduce_scatter sum", x, mesh.get_group(axis), run)


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
