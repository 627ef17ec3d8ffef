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
carried.

Autograd.  ``psum``, ``psum_scatter`` and ``all_gather`` are
differentiable when their input requires grad (``torch.autograd.Function``s
whose backward is the JAX transpose): ``all_gather`` along ``dim``
transposes to ``psum_scatter`` along ``dim`` (``grad="sum"``: the ranks'
cotangents are partial), or to the rank's own block of a cotangent every
rank holds whole (``grad="slice"``); ``psum_scatter`` transposes to
``all_gather``; ``psum`` of partials that every rank then consumes alike
transposes to the identity.  ``psum_grad`` is the identity whose
backward is ``psum``: a replicated tensor entering rank-partitioned work
(Megatron's f; ``psum`` is its g).  ``pmax`` has no gradient (the
vocab-parallel max is a detached shift).  A ``Function`` keeps its mesh
and this thread's ``collective_timing`` table in ``ctx``: on a card the
autograd engine runs the backward on a worker thread of its own, which
sees none of this module's thread-local state; the backward's
collectives are timed under their kind with `` bwd`` appended.
``layout_state`` / ``layout_installed`` carry the whole thread-local
state (rules, mesh, sizes, timing) into such a thread, as the
tensor-parallel blocks' recompute under remat needs.

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
    "in_manual_region",
    "layout_installed",
    "layout_state",
    "logical_sharding",
    "logical_sizes",
    "manual_region",
    "mesh_axis_names",
    "mesh_shape",
    "multi_pod_rules",
    "pmax",
    "pmean",
    "psum",
    "psum_grad",
    "psum_scatter",
    "single_pod_rules",
    "spec_axes",
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


def spec_axes(spec) -> tuple[str, ...]:
    """The mesh axes a partition spec cuts its tensor over, in order."""
    out: list[str] = []
    for e in spec:
        for a in (e if isinstance(e, tuple) else (e,)):
            if a is not None and a not in out:
                out.append(a)
    return tuple(out)


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
def manual_region():
    """Inside, this thread runs the body of one of the reference's
    ``shard_map`` regions (the wire train step's).  XLA folds a program's
    constant expressions when it compiles it, but computes them at run
    time inside such a region; ``layers.rope_freqs`` asks, since the two
    round differently.  Thread-local, carried by ``layout_state``."""
    old = getattr(_state, "manual", None)
    _state.manual = True
    try:
        yield
    finally:
        _state.manual = old


def in_manual_region() -> bool:
    """Whether this thread is inside ``manual_region``."""
    return bool(getattr(_state, "manual", None))


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


def layout_state() -> dict:
    """This thread's layout state: the rules, the mesh, the global sizes,
    the timing table and the manual region (``layout_installed`` puts them
    on another thread)."""
    return {k: getattr(_state, k, None)
            for k in ("rules", "mesh", "sizes", "times", "manual")}


@contextmanager
def layout_installed(state: dict):
    """``layout_state()``'s values on this thread inside the block, the
    previous ones after it: the autograd engine's worker thread on a card
    runs a checkpointed block's recompute without them."""
    old = layout_state()
    for k, v in state.items():
        setattr(_state, k, v)
    try:
        yield
    finally:
        for k, v in old.items():
            setattr(_state, k, v)


def _timing_table():
    """This thread's ``collective_timing`` table, or None."""
    return getattr(_state, "times", None)


def _carry(kind: str, x: torch.Tensor, group, run, times) -> torch.Tensor:
    """``run(t, group)`` (an in-place collective on ``t``, or one returning
    its result) on a copy of ``x`` in a dtype this backend sums; the
    result in ``x``'s dtype.  ``times``: the ``collective_timing`` table
    to add to, or None (a backward passes its forward's)."""
    import torch.distributed as dist

    backend = dist.get_backend(group)
    wide = _GLOO_WIDEN.get(x.dtype) if backend == "gloo" else None
    how = f"as {str(wide).removeprefix('torch.')}" if wide else "direct"
    key = f"{kind} {str(x.dtype).removeprefix('torch.')} {x.device.type}"
    TRANSPORTS[key] = f"{backend} {how}"
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


def _reduce(kind: str, op, x: torch.Tensor, axis, mesh,
            times) -> torch.Tensor:
    import torch.distributed as dist

    def run(t, group):
        dist.all_reduce(t, op=op, group=group)

    for a in _axes(axis):
        if mesh_shape(mesh)[a] > 1:
            x = _carry(kind, x, mesh.get_group(a), run, times)
    return x


def _scatter_sum(x: torch.Tensor, axis: str, dim: int, mesh, times,
                 kind="reduce_scatter sum") -> torch.Tensor:
    import torch.distributed as dist

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

    return _carry(kind, x, mesh.get_group(axis), run, times)


def _gather(x: torch.Tensor, axis: str, dim: int, mesh, times,
            kind="all_gather") -> torch.Tensor:
    import torch.distributed as dist

    if mesh_shape(mesh)[axis] == 1:
        return x

    def run(t, group):
        parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, t.contiguous(), group=group)
        return torch.cat(parts, dim)

    return _carry(kind, x, mesh.get_group(axis), run, times)


class _Psum(torch.autograd.Function):
    """psum forward; identity backward (the partials' sum is consumed
    alike on every rank, so each rank's cotangent is the whole one)."""

    @staticmethod
    def forward(ctx, x, axis, mesh, times):
        import torch.distributed as dist

        return _reduce("all_reduce sum", dist.ReduceOp.SUM, x, axis, mesh, times)

    @staticmethod
    def backward(ctx, g):
        return g, None, None, None


class _PsumGrad(torch.autograd.Function):
    """Identity forward; psum backward (Megatron's f)."""

    @staticmethod
    def forward(ctx, x, axis, mesh, times):
        ctx.args = (axis, mesh, times)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist

        axis, mesh, times = ctx.args
        return (_reduce("all_reduce sum bwd", dist.ReduceOp.SUM, g, axis,
                        mesh, times), None, None, None)


class _PsumScatter(torch.autograd.Function):
    """psum_scatter forward; all_gather of the cotangent backward."""

    @staticmethod
    def forward(ctx, x, axis, dim, mesh, times):
        ctx.args = (axis, dim, mesh, times)
        return _scatter_sum(x, axis, dim, mesh, times)

    @staticmethod
    def backward(ctx, g):
        axis, dim, mesh, times = ctx.args
        return (_gather(g, axis, dim, mesh, times, "all_gather bwd"),
                None, None, None, None)


class _AllGather(torch.autograd.Function):
    """all_gather along ``dim`` forward; backward the psum_scatter of the
    cotangent (``grad="sum"``) or this rank's block of it
    (``"slice"``)."""

    @staticmethod
    def forward(ctx, x, axis, dim, mesh, grad, times):
        ctx.args = (axis, dim, mesh, grad, times, x.shape[dim])
        return _gather(x, axis, dim, mesh, times)

    @staticmethod
    def backward(ctx, g):
        axis, dim, mesh, grad, times, n = ctx.args
        if grad == "sum":
            gx = _scatter_sum(g, axis, dim, mesh, times,
                              "reduce_scatter sum bwd")
        else:
            gx = g.narrow(dim, mesh.get_local_rank(axis) * n, n)
        return gx, None, None, None, None, None


def _differentiable(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def psum(x: torch.Tensor, axis, mesh=None) -> torch.Tensor:
    """Sum of ``x`` over the mesh axis (or tuple of axes), on every rank.
    Differentiable: the backward is the identity (every rank consumes the
    sum alike)."""
    import torch.distributed as dist

    mesh, times = _mesh(mesh), _timing_table()
    if _differentiable(x):
        return _Psum.apply(x, axis, mesh, times)
    return _reduce("all_reduce sum", dist.ReduceOp.SUM, x, axis, mesh, times)


def psum_grad(x: torch.Tensor, axis, mesh=None) -> torch.Tensor:
    """``x`` itself, whose gradient is summed over the mesh axis (or tuple
    of axes): where a tensor every rank holds alike enters work each rank
    does for its own part (its heads, its FF columns), each rank's
    cotangent is partial.  Without grad, ``x``."""
    if not _differentiable(x):
        return x
    return _PsumGrad.apply(x, axis, _mesh(mesh), _timing_table())


def psum_scatter(x: torch.Tensor, axis: str, dim: int = 0,
                 mesh=None) -> torch.Tensor:
    """The sum of ``x`` over the mesh axis, cut along ``dim`` into axis-size
    blocks, this rank keeping the block of its axis index:
    ``jax.lax.psum_scatter(..., scatter_dimension=dim, tiled=True)``.
    ``x.shape[dim]`` must divide by the axis size.  Differentiable: the
    backward all-gathers the cotangent."""
    mesh, times = _mesh(mesh), _timing_table()
    if _differentiable(x):
        return _PsumScatter.apply(x, axis, dim, mesh, times)
    return _scatter_sum(x, axis, dim, mesh, times)


def pmax(x: torch.Tensor, axis, mesh=None) -> torch.Tensor:
    """Elementwise max of ``x`` over the mesh axis, on every rank.  No
    gradient: the result is detached."""
    import torch.distributed as dist

    with torch.no_grad():
        return _reduce("all_reduce max", dist.ReduceOp.MAX, x.detach(), axis,
                       _mesh(mesh), _timing_table())


def pmean(x: torch.Tensor, axis, mesh=None) -> torch.Tensor:
    """``psum(x) / axis_size``, as ``jax.lax.pmean``."""
    return psum(x, axis, mesh) / axis_size(axis, mesh)


def all_gather(x: torch.Tensor, axis, dim: int = 0, tiled: bool = True,
               mesh=None, grad: str = "sum") -> torch.Tensor:
    """The ranks' ``x`` along ``dim`` in axis-index order: concatenated
    (``tiled``) or stacked on a new ``dim``, as ``jax.lax.all_gather``.
    A tuple of axes gathers its minor axis first, so the order is the
    tuple's combined index.  Differentiable: the backward is the
    ``psum_scatter`` of the cotangent along ``dim`` (``grad="sum"``, the
    ranks' cotangents partial) or this rank's block of it (``"slice"``,
    every rank's cotangent the whole one)."""
    mesh, times = _mesh(mesh), _timing_table()
    if grad not in ("sum", "slice"):
        raise ValueError(f"grad must be 'sum' or 'slice', not {grad!r}")
    if not tiled:
        x = x.unsqueeze(dim)
    for a in reversed(_axes(axis)):
        if mesh_shape(mesh)[a] > 1:
            if _differentiable(x):
                x = _AllGather.apply(x, a, dim, mesh, grad, times)
            else:
                x = _gather(x, a, dim, mesh, times)
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
