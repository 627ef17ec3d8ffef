"""Tensor parallelism: one rank's cut of a prefill, decode or train call
under a ``(data, model)`` mesh, the layout the reference's
``launch/shardings.py`` states and its GSPMD executes.

The parameters are this rank's shards (``launch.shardings.shard_params``:
heads, FF columns, vocab rows and experts over ``model``, the d_model dim
of every weight matrix over ``data``).  A call computes:

* its batch rows over ``data`` (``launch.shardings.batch_spec``; a batch
  that does not divide is computed whole on every data rank);
* between blocks, the residual stream's sequence slice over ``model``
  (Megatron sequence parallelism, the reference's ``_res_ax`` for GQA);
  ``rms_norm`` runs on the slice.  A sequence that does not divide stays
  whole.  Decode's one-token residual is whole on every model rank;
* in a block: an ``all_gather`` over ``model`` along the sequence before
  each column-parallel product (``wq`` / ``wk`` / ``wv``, ``w1`` /
  ``w3``), the rank's heads and FF columns, then the row-parallel
  product (``wo``, ``w2``; its float32 accumulator, ``matmul_f32``) and
  one ``psum_scatter`` over ``model`` along the sequence (decode: a
  ``psum``) in float32, rounded once to the model's type after, as the
  one-process product rounds once.  A bias after a row-parallel product
  is added once, after the reduce;
* at ``data > 1`` (ZeRO-3), each block's d_model-sharded leaves gathered
  over ``data`` just before the block and freed after it
  (``fsdp_gathered``; under remat the recompute gathers them again);
* a vocab-parallel embedding (a masked lookup of this rank's rows, then
  the reduce) and LM head: the logits come out as this rank's batch rows
  and vocab slice, as ``ax(logits, "batch", "vocab")`` states.

``TPLayout`` holds the cut of one call; ``tp_layout`` derives it from the
config, the mesh and the global (batch, sequence) by the reference's
divisibility rules (a train call is a (B, S) call without a cache).
Families cut: GQA attention (no sliding window) with a dense or MoE MLP;
the others raise ``NotImplementedError`` (``check_cut``).

Training differentiates through the same cut: the collectives are
``torch.autograd.Function``s (``models.sharding``).  Where the residual is
whole, a tensor every model rank holds alike that enters work each rank
does for its own heads, experts or FF columns has its gradient summed
over ``model`` where it enters: an activation in ``column_input``, a
leaf no spec cuts over ``model`` (``bq``, ``k_norm``, a whole ``wk``, the
router, ``b1``) in ``partitioned_leaf``, at its use.  The ZeRO-3
gather's backward is the reduce-scatter over ``data`` where the batch is
cut over ``data`` (the data-parallel sum of those leaves' gradients) and
the rank's block of the gradient where it is not.  ``sum_partial_grads``
then adds the structural sums, once a leaf: over ``data`` where the
batch rows are cut over it, over ``model`` where the residual's sequence
is cut over it, for each leaf no spec cuts over that axis.  The leaves
every rank computes alike (a replicated embedding, head or MLP over a
whole residual) get no sum, so the replicated leaves stay bit-equal
across ranks.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Any

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from .sharding import (
    all_gather,
    axis_index,
    mesh_shape,
    psum,
    psum_grad,
    psum_scatter,
    spec_axes,
)

__all__ = ["TPCache", "TPLayout", "check_cut", "fsdp_gathered",
           "partitioned_leaf", "sum_partial_grads", "tp_layout"]


@dataclass(frozen=True)
class TPLayout:
    """This rank's cut of one tensor-parallel call.

    ``rows``: its batch rows; ``seq_split``: the residual's sequence cut
    over ``model`` (``s_lo``, ``s_loc``); ``h_lo`` / ``h_loc``: its query
    heads; ``kv_split``: KV heads cut over ``model`` (``kv_lo`` /
    ``kv_loc``), else every rank holds them whole (``kv_cols``: whether
    ``wk`` / ``wv``'s columns are cut all the same, mid-head);
    ``ff_cols``: FF columns cut; ``vocab_split``: vocab rows cut
    (``v_lo``, ``v_loc``); ``fsdp``: d_model cut over ``data``."""

    mesh: Any
    model: int
    mi: int
    batch: int
    rows: slice
    seq: int
    seq_split: bool
    s_lo: int
    s_loc: int
    h_lo: int
    h_loc: int
    kv_split: bool
    kv_lo: int
    kv_loc: int
    kv_cols: bool
    ff_cols: bool
    vocab_split: bool
    v_lo: int
    v_loc: int
    fsdp: bool

    @property
    def rows_cut(self) -> bool:
        """Whether the batch rows are cut over ``data`` (each data rank
        its own rows), so gradients are partial over ``data``."""
        return self.rows.stop - self.rows.start != self.batch

    def sizes(self, cfg: ModelConfig) -> dict[str, int]:
        """The global size of each logical axis ``ax`` checks here."""
        return {"batch": self.batch, "seq_sp": self.seq, "seq": self.seq,
                "heads": cfg.n_heads, "kv_heads": cfg.n_kv_heads,
                "ff": cfg.d_ff, "vocab": cfg.vocab_size}


class TPCache(dict):
    """A decode cache of local shards (``cache_pspecs``'s local shapes), the
    dict ``init_cache`` lays out, carrying the cache's global length
    ``max_len``: a rank cannot tell from its slice alone whether time was
    cut over ``model``."""

    def __init__(self, *args, max_len: int, **kwargs):
        super().__init__(*args, **kwargs)
        self.max_len = int(max_len)


def check_cut(cfg: ModelConfig, mesh) -> None:
    """Raise ``NotImplementedError``, with the reason, for a config or mesh
    tensor parallelism does not cut yet (serving and training alike)."""
    why = {"hymba": "Hymba's SSM branch and its padded-head weights are "
                    "not cut yet",
           "rwkv6": "RWKV6's time-mix and channel-mix are not cut yet",
           "mla": "MLA's latent projections are not cut yet"}
    if cfg.attn_type in why:
        raise NotImplementedError(
            f"{cfg.name}: {why[cfg.attn_type]}; tensor parallelism covers "
            f"GQA attention without a window; run it with whole parameters "
            f"under a mesh")
    if cfg.attn_type != "gqa" or cfg.sliding_window:
        raise NotImplementedError(
            f"{cfg.name}: a sliding window is not cut yet; tensor "
            f"parallelism covers GQA attention without a window")
    if set(mesh_shape(mesh)) != {"data", "model"}:
        raise NotImplementedError(
            f"tensor parallelism takes a (data, model) mesh, not "
            f"{mesh_shape(mesh)}")
    m = mesh_shape(mesh)["model"]
    if cfg.n_heads % m:
        raise NotImplementedError(
            f"{cfg.n_heads} heads over a {m}-way model axis need the "
            f"padded-head weights, which the port does not cut yet")
    h_loc, n_rep = cfg.n_heads // m, cfg.n_heads // cfg.n_kv_heads
    if cfg.n_kv_heads % m and n_rep % h_loc:
        raise NotImplementedError(
            f"a rank's {h_loc} heads straddle groups of {n_rep}")
    if cfg.n_shared_experts:
        raise NotImplementedError(
            f"{cfg.name}: a shared expert is not cut yet")


def tp_layout(cfg: ModelConfig, mesh, batch: int, seq: int) -> TPLayout:
    """The cut of a call over ``batch`` rows of ``seq`` tokens (decode:
    ``seq`` 1) on this rank of ``mesh``, by the reference's rules."""
    check_cut(cfg, mesh)
    shape = mesh_shape(mesh)
    d, m = shape["data"], shape["model"]
    mi = axis_index("model", mesh)
    rows = slice(0, batch)
    if batch % d == 0:
        b_loc = batch // d
        rows = slice(axis_index("data", mesh) * b_loc,
                     (axis_index("data", mesh) + 1) * b_loc)
    seq_split = m > 1 and seq % m == 0
    s_loc = seq // m if seq_split else seq
    h_loc = cfg.n_heads // m
    kv, hd = cfg.n_kv_heads, cfg.head_dim_
    kv_split = kv % m == 0
    kv_loc = kv // m if kv_split else kv
    v = cfg.vocab_size
    vocab_split = v % m == 0
    v_loc = v // m if vocab_split else v
    return TPLayout(
        mesh=mesh, model=m, mi=mi, batch=batch, rows=rows,
        seq=seq, seq_split=seq_split, s_lo=mi * s_loc if seq_split else 0,
        s_loc=s_loc, h_lo=mi * h_loc, h_loc=h_loc, kv_split=kv_split,
        kv_lo=mi * kv_loc if kv_split else 0, kv_loc=kv_loc,
        kv_cols=not kv_split and (kv * hd) % m == 0,
        ff_cols=cfg.d_ff % m == 0, vocab_split=vocab_split,
        v_lo=mi * v_loc if vocab_split else 0, v_loc=v_loc,
        fsdp=d > 1 and cfg.d_model % d == 0,
    )


# ---------------------------------------------------------------------------
# the sequence-parallel residual
# ---------------------------------------------------------------------------
def column_input(L: TPLayout, h: torch.Tensor,
                 partitioned: bool = True) -> torch.Tensor:
    """A column-parallel block's input: the whole sequence, gathered over
    ``model`` from the residual's slices (its backward sums the ranks'
    partial gradients and keeps this rank's slice).  A residual that is
    not cut is whole already; when ``partitioned`` (the rank computes its
    own heads, experts or FF columns from it) its gradient is summed
    over ``model`` (``psum_grad``), else (every rank computes the same
    whole product) it is the whole one already."""
    if not L.seq_split:
        return psum_grad(h, "model", L.mesh) if partitioned else h
    return all_gather(h, "model", dim=1, mesh=L.mesh)


def row_reduce(L: TPLayout, part: torch.Tensor, dtype) -> torch.Tensor:
    """The sum over ``model`` of a row-parallel product's partial
    (B, S, d), cut to this rank's sequence slice when the residual is
    cut (``psum_scatter``), else whole (``psum``), then cast to ``dtype``
    (a float32 partial is rounded once, after the sum)."""
    if L.seq_split:
        return psum_scatter(part, "model", dim=1, mesh=L.mesh).to(dtype)
    return psum(part, "model", mesh=L.mesh).to(dtype)


def own_seq(L: TPLayout, x: torch.Tensor) -> torch.Tensor:
    """This rank's sequence slice of a whole (B, S, d) result that every
    model rank computed alike (a product whose dim was not cut)."""
    if not L.seq_split:
        return x
    return x[:, L.s_lo:L.s_lo + L.s_loc]


def last_position(L: TPLayout, x: torch.Tensor) -> torch.Tensor:
    """(B, 1, d) at the sequence's last position, on every model rank:
    the last rank's slice holds it when the residual is cut."""
    if not L.seq_split:
        return x[:, -1:]
    return all_gather(x[:, -1:], "model", dim=1, mesh=L.mesh)[:, -1:]


# ---------------------------------------------------------------------------
# ZeRO-3: a block's d_model-sharded leaves, gathered over data
# ---------------------------------------------------------------------------
@contextlib.contextmanager
def fsdp_gathered(L: TPLayout, module: torch.nn.Module,
                  dims: dict[str, int | None], prefix: str = ""):
    """Inside the block, each parameter of ``module`` that ``dims``
    ({full parameter name: its data-sharded dim or None}) cuts over
    ``data`` reads as its all-gathered whole (``gathered``:
    differentiable, the shard a leaf of the graph); after it, the shard
    again, and the gathered copies are dropped.  A no-op without
    FSDP."""
    swapped = []
    try:
        if L.fsdp:
            for name, shard in list(module.named_parameters()):
                dim = dims.get(f"{prefix}{name}")
                if dim is None:
                    continue
                owner, _, leaf = name.rpartition(".")
                mod = module.get_submodule(owner)
                swapped.append((mod, leaf, shard))
                # a plain tensor in the module's table: ``mod.<leaf>``
                # reads it, autograd sees the gather
                mod._parameters[leaf] = gathered(L, shard, dim)
        yield module
    finally:
        for mod, leaf, shard in reversed(swapped):
            mod._parameters[leaf] = shard


def gathered(L: TPLayout, t: torch.Tensor, dim: int | None) -> torch.Tensor:
    """One leaf gathered over ``data`` along its sharded ``dim``.  Its
    backward reduce-scatters the gradient over ``data`` where the batch
    rows are cut over it (the data-parallel sum), else keeps this rank's
    block of the whole gradient every data rank holds."""
    if not L.fsdp or dim is None:
        return t
    return all_gather(t, "data", dim, mesh=L.mesh,
                      grad="sum" if L.rows_cut else "slice")


def partitioned_leaf(L: TPLayout, t: torch.Tensor | None):
    """A leaf whole on every model rank (no spec cuts it over ``model``)
    as it enters work this rank does for its own heads, experts or FF
    columns: its gradient there is partial over ``model``, so it is
    summed (``psum_grad``), as ``column_input`` sums an activation's.
    Where the residual's sequence is cut, ``sum_partial_grads`` sums every
    such leaf over ``model`` already, and ``t`` comes back as it is, as
    does ``None``."""
    if t is None or L.model == 1 or L.seq_split:
        return t
    return psum_grad(t, "model", L.mesh)


def _partial_axes(L: TPLayout, spec) -> tuple[str, ...]:
    """The mesh axes over which a leaf's gradient is partial by the cut of
    the batch and the sequence: ``data`` where the rows are cut, ``model``
    where the residual's sequence is, each unless ``spec`` cuts the leaf
    over it."""
    cut = spec_axes(spec)
    axes = []
    if L.rows_cut and "data" not in cut:
        axes.append("data")
    if L.seq_split and "model" not in cut:
        axes.append("model")
    return tuple(axes)


@torch.no_grad()
def sum_partial_grads(L: TPLayout, grads: dict[str, torch.Tensor],
                      pspecs: dict) -> dict[str, torch.Tensor]:
    """Each gradient summed over the axes on which the batch's and the
    sequence's cut leave it partial (``_partial_axes``), once: the leaves
    of one (axes, dtype) go through one ``psum`` of their
    concatenation."""
    groups: dict[tuple, list[str]] = {}
    for name, g in grads.items():
        axes = _partial_axes(L, pspecs[name])
        if axes:
            groups.setdefault((axes, g.dtype), []).append(name)
    out = dict(grads)
    for (axes, _), names in groups.items():
        flat = psum(torch.cat([grads[n].reshape(-1) for n in names]), axes,
                    mesh=L.mesh)
        for n, part in zip(names, flat.split([grads[n].numel()
                                              for n in names])):
            out[n] = part.view_as(grads[n])
    return out


# ---------------------------------------------------------------------------
# the vocab-parallel embedding
# ---------------------------------------------------------------------------
def embed_tokens(L: TPLayout, embed: torch.Tensor,
                 ids: torch.Tensor) -> torch.Tensor:
    """This rank's rows of ``ids`` (B, S) looked up in its vocab rows of
    ``embed`` (the others give zeros) and summed over ``model``: the
    residual's sequence slice in prefill (``row_reduce``), decode's whole
    one-token residual.  A replicated embedding needs no sum."""
    if not L.vocab_split:
        return own_seq(L, F.embedding(ids, embed))
    mine = (ids >= L.v_lo) & (ids < L.v_lo + L.v_loc)
    x = F.embedding(torch.where(mine, ids - L.v_lo, 0), embed)
    return row_reduce(L, torch.where(mine[..., None], x, 0), embed.dtype)
