"""Mixture-of-Experts MLP — the port of ``repro.models.moe`` (its no-mesh
dispatch).

Top-k routing over a float32 router: softmax, ``top_k``, the top-k
probabilities renormalised by max(sum, 1e-9); each (token, slot)'s
position within its expert counted in token-major order (the reference
takes a cumsum over a one-hot; the port a stable sort by expert, which
ranks the same assignments the same), so the
assignments past ``capacity = max(int(n k / E * capacity_factor), 1)``
drop exactly as the reference's do; the kept tokens scattered into a
dense (E, capacity, d) buffer, the three expert products as batched
matmuls, the results gathered back and weighted by their gates; the
shared expert (DeepSeek-V3) added after the routed ones; the Switch-style
aux load-balance loss E * sum(me * ce).

The reference computes all of this with XLA outside any Pallas kernel,
so the port is plain PyTorch.

Two dispatch paths, as in the reference: ``_moe_apply_dense`` without a
mesh (or with a model axis of 1), and the expert-parallel
``_moe_apply_ep`` whenever a mesh is installed
(``models.sharding.logical_sharding``) and its ``model`` axis is larger
than 1.  There every rank routes its own batch rows (the reference's
data shard) to its own slice of the experts (padded to a multiple of the
model axis: -inf router logits, zero weights), counts positions over
those local tokens for its local experts into a local capacity, moves
only token ids in the dispatch and the combine, and one ``psum`` over
``model`` adds the partial outputs (``_moe_ep_partial`` is the partial;
tensor-parallel serving sums it with a ``psum_scatter`` instead).  The
expert weights are the rank's slice where ``launch.shardings.shard_params``
cut them, else whole and sliced here.  The reference runs that body under
``shard_map``; the port runs it on every rank of a ``DeviceMesh``, each
rank keeping its rows.  ``moe_apply`` takes the whole (B, S, d)
activation, as the reference's takes its global array: under a mesh it
hands each rank its rows and gathers the outputs back over the batch
axes.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import ModelConfig
from .attention import _param
from .layers import swiglu
from .sharding import (
    _axis_size,
    all_gather,
    axis_index,
    batch_axes_in,
    current_mesh,
    mesh_axis_names,
    mesh_shape,
    pmean,
    psum,
)

__all__ = ["MoE", "SharedExpert", "init_moe", "moe_apply"]


class SharedExpert(nn.Module):
    """The always-on expert: w1 / w3 (d, f_s), w2 (f_s, d), f_s =
    moe_d_ff * n_shared_experts."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        d, fs = cfg.d_model, cfg.moe_d_ff * cfg.n_shared_experts
        self.w1 = _param((d, fs), dtype, device)
        self.w3 = _param((d, fs), dtype, device)
        self.w2 = _param((fs, d), dtype, device)


class MoE(nn.Module):
    """router (d, E) float32 whatever the model's dtype; the expert stacks
    w1 / w3 (E, d, f) and w2 (E, f, d); ``shared`` with
    ``n_shared_experts`` (``None`` otherwise)."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
        self.router = _param((d, e), torch.float32, device)
        self.w1 = _param((e, d, f), dtype, device)
        self.w3 = _param((e, d, f), dtype, device)
        self.w2 = _param((e, f, d), dtype, device)
        self.shared = (SharedExpert(cfg, dtype, device)
                       if cfg.n_shared_experts else None)


@torch.no_grad()
def init_moe(p: MoE, cfg: ModelConfig, gen: torch.Generator) -> MoE:
    """Fill ``p`` at the reference's scales: router and w1 / w3 normal *
    d**-0.5, w2 normal * f**-0.5, the shared expert likewise (same
    scales, not the same bits)."""
    d, f = cfg.d_model, cfg.moe_d_ff
    for w in (p.router, p.w1, p.w3):
        w.normal_(0.0, d**-0.5, generator=gen)
    p.w2.normal_(0.0, f**-0.5, generator=gen)
    if p.shared is not None:
        fs = f * cfg.n_shared_experts
        p.shared.w1.normal_(0.0, d**-0.5, generator=gen)
        p.shared.w3.normal_(0.0, d**-0.5, generator=gen)
        p.shared.w2.normal_(0.0, fs**-0.5, generator=gen)
    return p


def moe_apply(p: MoE, cfg: ModelConfig, x):
    """x: (B,S,d) -> (out (B,S,d), aux load-balance loss).  Under a mesh
    with a model axis, every rank holds ``x`` alike: where the batch axes
    divide the batch each rank dispatches its rows (``_moe_apply_ep``)
    and the outputs are gathered back, so every rank returns the whole
    output."""
    mesh = current_mesh()
    if mesh is None or mesh_shape(mesh).get("model", 1) <= 1:
        return _moe_apply_dense(p, cfg, x)
    b = x.shape[0]
    batch_ax = batch_axes_in()
    if batch_ax is None or b % _axis_size(mesh, batch_ax) != 0:
        return _moe_apply_ep(p, cfg, x, mesh)
    bl = b // _axis_size(mesh, batch_ax)
    i = axis_index(batch_ax, mesh)
    out, aux = _moe_apply_ep(p, cfg, x[i * bl:(i + 1) * bl], mesh)
    return all_gather(out, batch_ax, dim=0, mesh=mesh), aux


def _ep_layout(cfg: ModelConfig, bl: int, s: int, mesh):
    """(e_pad, e_loc, cap_loc) of the expert-parallel dispatch of one
    rank's (bl, s) rows, as the reference sizes them from its data
    shard."""
    e, k = cfg.n_experts, cfg.top_k
    tp = mesh_shape(mesh)["model"]
    e_pad = -(-e // tp) * tp
    cap_loc = max(int(bl * s * k / e * cfg.capacity_factor), 1)
    return e_pad, e_pad // tp, cap_loc


def _ep_route(cfg: ModelConfig, xf, router, e_pad: int, lo: int,
              e_loc: int, cap_loc: int):
    """One rank's routing of its (n, d) tokens over the padded router
    (d, e_pad) to its experts [lo, lo + e_loc).  Returns (tok_of, gate_of,
    mine, keep, aux): the (e_loc, cap_loc) token id of each slot (``n``
    where empty) and its gate; per (token, slot) token-major, whether
    its expert is local and whether it keeps a slot; the shard's aux
    loss before the means over ranks."""
    n = xf.shape[0]
    e, k = cfg.n_experts, cfg.top_k
    logits = xf.float() @ router
    live = torch.arange(e_pad, device=xf.device) < e
    logits = torch.where(live, logits, -torch.inf)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_ids = torch.topk(probs, k, dim=-1)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)

    me = probs.mean(0)
    ce = _counts(top_ids[:, 0], e_pad, probs.dtype) / n
    aux = e * torch.sum(me * ce)

    flat_ids = top_ids.reshape(n * k)
    gate = top_p.reshape(n * k).to(xf.dtype)
    mine = (flat_ids >= lo) & (flat_ids < lo + e_loc)
    # LOCAL position-in-expert over this shard's tokens only: a stable
    # sort by local expert (the others in a spare bucket e_loc) ranks each
    # expert's assignments in token-major order, the reference's masked
    # one-hot cumsum
    le = torch.where(mine, flat_ids - lo, e_loc)
    order = torch.argsort(le, stable=True)
    counts = _counts(le, e_loc + 1, le.dtype)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(n * k, device=xf.device) - starts[le[order]]
    pos = torch.empty_like(rank).scatter_(0, order, rank)
    keep = mine & (pos < cap_loc)

    # index-only dispatch: each kept (token, slot) writes its token id and
    # gate into its expert's slot; the others go to a spare slot past the
    # end, which is cut off
    slot = torch.where(keep, le * cap_loc + pos, e_loc * cap_loc)
    token = torch.arange(n * k, device=xf.device) // k
    tok_of = torch.full((e_loc * cap_loc + 1,), n, dtype=torch.long,
                        device=xf.device).scatter_(0, slot, token)
    gate_of = xf.new_zeros(e_loc * cap_loc + 1).scatter_(0, slot, gate)
    return (tok_of[:-1].view(e_loc, cap_loc),
            gate_of[:-1].view(e_loc, cap_loc), mine, keep, aux)


def _local_experts(w, cfg: ModelConfig, lo: int, e_loc: int):
    """This rank's experts of the stack ``w``: ``w`` itself where the
    experts were cut over ``model`` (``shard_params``), else experts
    [lo, lo + e_loc) of the whole stack, zero experts appended past the
    real ones."""
    if w.shape[0] != cfg.n_experts:
        return w
    return _pad_experts(w[lo:min(lo + e_loc, cfg.n_experts)], e_loc)


def _moe_ep_partial(p: MoE, cfg: ModelConfig, x, mesh, with_aux=True,
                    token_axes=None, whole_leaf=None):
    """One rank's share of the expert-parallel output for its rows ``x``
    (bl, s, d): its experts' kept slots, gated, added back to their
    tokens in float32.  The caller sums it over ``model`` and rounds
    once.
    Returns (partial, aux): the aux loss is the mean over the other axes
    (``token_axes``, the axes the tokens are cut over, when given), then
    over ``model``, of each shard's (``None`` without ``with_aux``), as
    the reference's ``pmean``s give it.

    Differentiable: the gates and the aux loss carry the router's
    gradient, the gather and the combine the activation's and the
    experts'.  The mean over ``model`` of the aux loss every model rank
    computes alike gives each rank 1 / model of its gradient, so its
    router gradient is partial over ``model`` like the gates'.  The
    router, and an expert stack no spec cut over ``model``, pass through
    ``whole_leaf`` as they enter (the tensor-parallel step's
    ``partitioned_leaf``, which sums their gradients); a mean over an
    axis the tokens are not cut over would leave its gradient partial
    there too, so ``token_axes`` leaves it out.  The dispatch's backward
    (``index_select``'s, an ``index_add`` over repeated rows) adds in a
    fixed order under ``launch.steps.deterministic_algorithms``."""
    bl, s, d = x.shape
    e = cfg.n_experts
    e_pad, e_loc, cap_loc = _ep_layout(cfg, bl, s, mesh)
    lo = axis_index("model", mesh) * e_loc
    leaf = whole_leaf or (lambda t: t)
    router = F.pad(leaf(p.router), (0, e_pad - e))
    w1, w3, w2 = (_local_experts(leaf(w) if w.shape[0] == e else w, cfg,
                                 lo, e_loc)
                  for w in (p.w1, p.w3, p.w2))
    n = bl * s
    xf = x.reshape(n, d)
    tok_of, gate_of, _, _, aux = _ep_route(cfg, xf, router, e_pad, lo,
                                           e_loc, cap_loc)
    if with_aux:
        other = (tuple(a for a in mesh_axis_names(mesh) if a != "model")
                 if token_axes is None else tuple(token_axes))
        if other:
            aux = pmean(aux, other, mesh)
        aux = pmean(aux, "model", mesh)  # identical on every model rank
    else:
        aux = None

    buf = xf.index_select(0, tok_of.clamp(max=n - 1).reshape(-1))
    y = _experts(buf.view(e_loc, cap_loc, d), w1, w3, w2)
    # combine: add slots back to their tokens (empty slots have gate 0 and
    # the spare token id n, whose row is cut off)
    part = xf.new_zeros((n + 1, d), dtype=torch.float32).index_add_(
        0, tok_of.reshape(-1),
        (y * gate_of[..., None]).reshape(-1, d).float())[:n]
    return part.reshape(bl, s, d), aux


def _moe_apply_ep(p: MoE, cfg: ModelConfig, x, mesh):
    """Expert-parallel dispatch of this rank's rows ``x`` (bl, s, d) on the
    ranks of ``mesh`` (see the module docstring); returns its rows of the
    output and the aux loss.

    Experts are padded up to a multiple of the model axis when needed
    (granite's 40 -> 48 on a 16-way axis); padded experts get -inf router
    logits and all-zero weights, so they are never selected.
    """
    part, aux = _moe_ep_partial(p, cfg, x, mesh)
    out = psum(part, "model", mesh).to(x.dtype)
    if p.shared is not None:
        sp = p.shared
        out = out + swiglu(x, sp.w1, sp.w3, sp.w2)
    return out, aux


def _pad_experts(w, e_loc: int):
    """``w`` (e', ...) with zero experts appended up to ``e_loc``."""
    if w.shape[0] == e_loc:
        return w
    return torch.cat([w, w.new_zeros((e_loc - w.shape[0], *w.shape[1:]))])


def _route(p: MoE, cfg: ModelConfig, xf):
    """Routing of the (N, d) tokens: (flat_ids, flat_pos, keep, gates,
    aux, capacity), each (token, slot) flattened token-major (N * k,).
    ``keep`` is False for the assignments that overflow their expert's
    capacity; their ``flat_pos`` is 0, as the reference sets it."""
    n = xf.shape[0]
    e, k = cfg.n_experts, cfg.top_k
    logits = xf.float() @ p.router
    probs = torch.softmax(logits, dim=-1)  # (N, E)
    top_p, top_ids = torch.topk(probs, k, dim=-1)  # (N, k)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)

    # aux load-balance loss (Switch-style): E * sum_e f_e * p_e
    me = probs.mean(0)  # mean router prob per expert
    ce = _counts(top_ids[:, 0], e, probs.dtype) / n  # top-1 fraction
    aux = e * torch.sum(me * ce)

    capacity = max(int(n * k / e * cfg.capacity_factor), 1)
    flat_ids = top_ids.reshape(n * k)
    # position within expert in token-major order: a stable sort by expert
    # keeps each expert's assignments in that order, so an assignment's
    # rank in its expert's run is the reference's one-hot cumsum
    order = torch.argsort(flat_ids, stable=True)
    counts = _counts(flat_ids, e, flat_ids.dtype)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(n * k, device=xf.device) - starts[flat_ids[order]]
    flat_pos = torch.empty_like(rank).scatter_(0, order, rank)
    keep = flat_pos < capacity
    flat_pos = torch.where(keep, flat_pos, 0)
    gates = top_p.reshape(n * k).to(xf.dtype)
    return flat_ids, flat_pos, keep, gates, aux, capacity


def _counts(ids, e: int, dtype):
    """How many of ``ids`` name each of the ``e`` experts (no host sync,
    unlike ``one_hot``'s range check)."""
    ones = torch.ones(ids.shape, dtype=dtype, device=ids.device)
    return torch.zeros(e, dtype=dtype, device=ids.device).index_add_(
        0, ids, ones)


def _experts(buf, w1, w3, w2):
    """The three expert products over the (E, C, d) buffer."""
    h = torch.bmm(buf, w1)
    g = torch.bmm(buf, w3)
    return torch.bmm(F.silu(h) * g, w2)


def _moe_apply_dense(p: MoE, cfg: ModelConfig, x):
    """Dispatch without a mesh: the token-major position count, a dense
    (E, capacity, d) buffer, the gather back."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    n = b * s
    xf = x.reshape(n, d)
    flat_ids, flat_pos, keep, gates, aux, capacity = _route(p, cfg, xf)

    # each kept (token, slot) owns one buffer row; dropped ones all go to
    # a spare row past the end, which is cut off
    slot = torch.where(keep, flat_ids * capacity + flat_pos, e * capacity)
    token = torch.arange(n * k, device=x.device) // k
    buf = x.new_zeros((e * capacity + 1, d))
    buf.index_copy_(0, slot, xf.index_select(0, token))
    y = _experts(buf[:-1].view(e, capacity, d), p.w1, p.w3, p.w2)

    gathered = y.reshape(e * capacity, d).index_select(
        0, flat_ids * capacity + flat_pos)
    gathered = torch.where(keep[:, None], gathered, 0) * gates[:, None]
    out = gathered.reshape(n, k, d).sum(1).reshape(b, s, d)

    if p.shared is not None:
        sp = p.shared
        out = out + swiglu(x, sp.w1, sp.w3, sp.w2)
    return out, aux
