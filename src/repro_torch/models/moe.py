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
so the port is plain PyTorch.  Its expert-parallel ``_moe_apply_ep``
(a ``shard_map`` over a mesh's model axis) waits for the port's mesh
(``models/sharding.py``, ROADMAP Queue 1 item 12.3); ``moe_apply`` takes
the dense dispatch.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import ModelConfig
from .attention import _param
from .layers import swiglu

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
    """x: (B,S,d) -> (out (B,S,d), aux load-balance loss)."""
    return _moe_apply_dense(p, cfg, x)


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
