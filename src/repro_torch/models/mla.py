"""Multi-head Latent Attention (DeepSeek-V3, arXiv:2412.19437) — the port
of ``repro.models.mla``.

Queries and KV are projected through low-rank latents; the decode cache
stores only the compressed ``c_kv`` (kv_lora_rank) plus the shared RoPE
key (qk_rope_dim) per token.  Decode uses the W_uk / W_uv absorption, so
scores and outputs are computed in latent space.

Parameters live in an ``MLA`` module whose names are the reference's
leaves.  The reference's MLA never reaches a Pallas kernel (its model
ignores ``use_flash`` for MLA), so neither does the port's: the full
sequence takes the dense formula below 4,096 tokens and the chunked
online softmax (``blockwise.chunked_attention``) from 4,096 on, as the
reference does.  The decode step writes the new latent and rope key into
the cache in place, as ``attention_decode`` does, dropping a slot past
the cache.

Tensor parallelism (``_mla_attend_tp``, which the train block calls,
``mla_prefill_tp`` / ``mla_decode_tp``, the reference's ``param_pspecs``
/ ``cache_pspecs`` layout): a rank holds its
heads' column blocks of ``w_uq`` / ``w_uk`` / ``w_uv`` and their rows of
``wo``, and every latent projection (``w_dq``, ``w_dkv``, ``w_kr`` and
the norms) whole over ``model``.  A prefill computes the latents on the
rank's sequence slice of the residual and gathers them along the
sequence (c_q, c_kv and k_rope together: (1,536 + 512 + 64) / 7,168 of
the residual's bytes for DeepSeek-V3), attends its heads over the whole
sequence (dense or chunked by the global length) and keeps its time
slice of the latent cache.  Decode computes the new latent on every
rank; the rank whose time slice holds the position writes it.  Against a
time-cut cache the absorbed one-token queries of every head are gathered
over ``model``, each rank scores them against its slice, and the
softmax is combined by log-sum-exp (``_latent_attend_time_split``);
against a whole cache a rank scores its own heads.  Either way the
output is the rank's float32 partial through its rows of ``wo``, which
the block sums over ``model``.
"""
from __future__ import annotations

import torch
from torch import nn

from ..configs.base import ModelConfig
from .attention import _param, _write_slot
from .blockwise import chunked_attention
from .layers import apply_rope, matmul_f32, rms_norm
from .sharding import all_gather, ax, pmax, psum, psum_grad
from .tensor_parallel import TPLayout, own_seq

__all__ = [
    "MLA",
    "init_mla",
    "init_mla_cache",
    "mla_decode",
    "mla_decode_tp",
    "mla_prefill",
    "mla_prefill_tp",
    "mla_train",
]

_NEG_INF = -1e30

# the full sequence goes chunked from this length (the reference's switch)
MLA_CHUNKED_THRESHOLD = 4096


class MLA(nn.Module):
    """w_dq (d, q_lora) and q_norm; w_uq (q_lora, H (qk_nope + qk_rope));
    w_dkv (d, kv_lora) and kv_norm; w_kr (d, qk_rope), the shared rope
    key; w_uk (kv_lora, H qk_nope); w_uv (kv_lora, H v_head); wo (H
    v_head, d)."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        d, h = cfg.d_model, cfg.n_heads
        qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
        qk_n, qk_r, vh = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
        self.w_dq = _param((d, qr), dtype, device)
        self.q_norm = _param((qr,), dtype, device)
        self.w_uq = _param((qr, h * (qk_n + qk_r)), dtype, device)
        self.w_dkv = _param((d, kvr), dtype, device)
        self.kv_norm = _param((kvr,), dtype, device)
        self.w_kr = _param((d, qk_r), dtype, device)
        self.w_uk = _param((kvr, h * qk_n), dtype, device)
        self.w_uv = _param((kvr, h * vh), dtype, device)
        self.wo = _param((h * vh, d), dtype, device)


@torch.no_grad()
def init_mla(p: MLA, cfg: ModelConfig, gen: torch.Generator) -> MLA:
    """Fill ``p`` at the reference's scales: every projection normal *
    d_in**-0.5, unit norms (same scales, not the same bits)."""
    for w in (p.w_dq, p.w_uq, p.w_dkv, p.w_kr, p.w_uk, p.w_uv, p.wo):
        w.normal_(0.0, w.shape[0] ** -0.5, generator=gen)
    p.q_norm.fill_(1.0)
    p.kv_norm.fill_(1.0)
    return p


def _split_queries(cfg: ModelConfig, q, positions):
    """(q_nope, q_rope) of the query columns ``q`` (B, S, heads (qk_nope +
    qk_rope)), contiguous per head; RoPE applied to q_rope."""
    b, s, _ = q.shape
    qk_n, qk_r = cfg.qk_nope_dim, cfg.qk_rope_dim
    q = q.reshape(b, s, -1, qk_n + qk_r)
    q_nope, q_rope = q[..., :qk_n], q[..., qk_n:]
    return q_nope, apply_rope(q_rope, positions, cfg.rope_theta)


def _queries(p: MLA, cfg: ModelConfig, x, positions):
    """The queries of the heads whose ``w_uq`` columns ``p`` holds."""
    c_q = rms_norm(x @ p.w_dq, p.q_norm, cfg.rms_eps)
    return _split_queries(cfg, c_q @ p.w_uq, positions)


def _latents(p: MLA, cfg: ModelConfig, x, positions):
    c_kv = rms_norm(x @ p.w_dkv, p.kv_norm, cfg.rms_eps)
    k_rope = x @ p.w_kr  # shared across heads
    k_rope = apply_rope(k_rope[:, :, None, :], positions,
                        cfg.rope_theta)[:, :, 0]
    return c_kv, k_rope


def _attend_dense(q_nope, q_rope, k_nope, k_rope, v, scale, dtype):
    """Causal MLA over the full sequence in one (B, H, S, S) score tensor;
    returns (B, S, H * v_head)."""
    b, s = q_nope.shape[:2]
    scores = (torch.einsum("bshq,bthq->bhst", q_nope, k_nope)
              + torch.einsum("bshq,btq->bhst", q_rope, k_rope)) * scale
    idx = torch.arange(s, device=q_nope.device)
    mask = (idx[:, None] >= idx[None, :])[None, None]
    w = torch.softmax(torch.where(mask, scores.float(), _NEG_INF),
                      dim=-1).to(dtype)
    return torch.einsum("bhst,bthv->bshv", w, v).reshape(b, s, -1)


def _attend_chunked(q_nope, q_rope, k_nope, k_rope, v, scale):
    """The same through ``chunked_attention``, the shared rope key folded
    into per-head keys so the online softmax sees one (q, k, v) triple."""
    b, s, h = q_nope.shape[:3]
    q_full = torch.cat([q_nope, q_rope], dim=-1)
    k_full = torch.cat(
        [k_nope, k_rope[:, :, None, :].expand(b, s, h, k_rope.shape[-1])],
        dim=-1,
    )
    out = chunked_attention(q_full, k_full, v, causal=True, scale=scale)
    return out.reshape(b, s, -1)


def _attend(cfg: ModelConfig, q_nope, q_rope, c_kv, k_rope, w_uk, w_uv,
            dtype):
    """Causal attention of the heads of ``q_nope`` / ``q_rope`` (B, S, h,
    *) over the whole sequence, their keys and values expanded from the
    latents through those heads' columns ``w_uk`` / ``w_uv``: dense below
    MLA_CHUNKED_THRESHOLD tokens, chunked from it.  Returns (B, S, h
    v_head)."""
    b, s, h = q_nope.shape[:3]
    qk_n, qk_r, vh = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    k_nope = (c_kv @ w_uk).reshape(b, s, h, qk_n)
    v = (c_kv @ w_uv).reshape(b, s, h, vh)
    scale = (qk_n + qk_r) ** -0.5
    if s >= MLA_CHUNKED_THRESHOLD:
        return _attend_chunked(q_nope, q_rope, k_nope, k_rope, v, scale)
    return _attend_dense(q_nope, q_rope, k_nope, k_rope, v, scale, dtype)


def _mla_attend(p: MLA, cfg: ModelConfig, x, positions):
    """Shared train / prefill body; returns (out, c_kv, k_rope)."""
    q_nope, q_rope = _queries(p, cfg, x, positions)
    c_kv, k_rope = _latents(p, cfg, x, positions)
    out = _attend(cfg, q_nope, q_rope, c_kv, k_rope, p.w_uk, p.w_uv,
                  x.dtype)
    return out @ p.wo, c_kv, k_rope


def mla_train(p: MLA, cfg: ModelConfig, x, positions):
    """Full-sequence causal MLA (train / prefill): explicit k/v expansion."""
    out, _, _ = _mla_attend(p, cfg, x, positions)
    return out


def _pad_time(lat, max_len: int):
    """A (B, S, r) latent zero-padded along time to ``max_len``."""
    b, s, r = lat.shape
    if max_len <= s:
        return lat
    return torch.cat([lat, lat.new_zeros((b, max_len - s, r))], 1)


def mla_prefill(p: MLA, cfg: ModelConfig, x, positions, max_len: int):
    """Full-sequence MLA returning the latent decode cache (c_kv, k_rope),
    zero-padded to ``max_len``."""
    out, c_kv, k_rope = _mla_attend(p, cfg, x, positions)
    return out, {"c_kv": _pad_time(c_kv, max_len),
                 "k_rope": _pad_time(k_rope, max_len)}


def init_mla_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                   device):
    return {
        "c_kv": torch.zeros((batch, max_len, cfg.kv_lora_rank), dtype=dtype,
                            device=device),
        "k_rope": torch.zeros((batch, max_len, cfg.qk_rope_dim), dtype=dtype,
                              device=device),
    }


def _absorbed(cfg: ModelConfig, q_nope, w_uk):
    """q_lat (B, 1, h, kv_lora): the heads' nope queries taken into latent
    space through their columns ``w_uk`` (the W_uk absorption)."""
    w_uk = w_uk.reshape(cfg.kv_lora_rank, -1, cfg.qk_nope_dim)
    return torch.einsum("bshq,rhq->bshr", q_nope, w_uk)


def _latent_scores(cfg: ModelConfig, q_lat, q_rope, c_kv, k_rope, mask):
    """float32 (B, h, 1, T) scores of the absorbed queries against the
    latent cache, -inf-like where ``mask`` (B, 1, 1, T) is False."""
    scale = (cfg.qk_nope_dim + cfg.qk_rope_dim) ** -0.5
    scores = (torch.einsum("bshr,btr->bhst", q_lat, c_kv)
              + torch.einsum("bshq,btq->bhst", q_rope, k_rope)) * scale
    return torch.where(mask, scores.float(), _NEG_INF)


def _latent_attend(cfg: ModelConfig, q_lat, q_rope, c_kv, k_rope, mask):
    """o_lat (B, 1, h, kv_lora): the softmax over the whole cache, cast to
    the cache's type, applied to ``c_kv``."""
    w = torch.softmax(_latent_scores(cfg, q_lat, q_rope, c_kv, k_rope,
                                     mask), dim=-1).to(c_kv.dtype)
    return torch.einsum("bhst,btr->bshr", w, c_kv)


def _expand(cfg: ModelConfig, o_lat, w_uv, wo, f32: bool = False):
    """The heads' latent outputs (B, 1, h, kv_lora) expanded through their
    columns ``w_uv`` and multiplied by their rows of ``wo`` (float32 when
    ``f32``: a partial summed over ``model`` before rounding)."""
    b = o_lat.shape[0]
    w_uv = w_uv.reshape(cfg.kv_lora_rank, -1, cfg.v_head_dim)
    out = torch.einsum("bshr,rhv->bshv", o_lat, w_uv).reshape(b, 1, -1)
    return matmul_f32(out, wo) if f32 else out @ wo


def mla_decode(p: MLA, cfg: ModelConfig, x, cache, position):
    """One-token decode with the latent cache and W_uk / W_uv absorption.
    Writes the new latent and rope key into ``cache`` in place and returns
    (out (B,1,d), the same cache)."""
    q_nope, q_rope = _queries(p, cfg, x, position[:, None])  # (B,1,H,*)
    c_new, kr_new = _latents(p, cfg, x, position[:, None])

    c_kv, k_rope = cache["c_kv"], cache["k_rope"]
    t = c_kv.shape[1]
    position = position.long()
    _write_slot(c_kv, c_new, position, position < t)
    _write_slot(k_rope, kr_new, position, position < t)

    # absorption: score_nope = (q_nope W_uk^T) . c_kv in latent space, the
    # output in latent space, then expanded with W_uv
    idx = torch.arange(t, device=x.device)
    mask = (idx[None, :] <= position[:, None])[:, None, None, :]
    o_lat = _latent_attend(cfg, _absorbed(cfg, q_nope, p.w_uk), q_rope,
                           c_kv, k_rope, mask)
    return _expand(cfg, o_lat, p.w_uv, p.wo), {"c_kv": c_kv,
                                                "k_rope": k_rope}


# ---------------------------------------------------------------------------
# tensor parallelism: this rank's heads
# ---------------------------------------------------------------------------
def _latents_tp(p: MLA, cfg: ModelConfig, L: TPLayout, x, positions):
    """(c_q, c_kv, k_rope) of the whole sequence from this rank's residual
    slice ``x`` (B, S / model, d) at its ``positions``: each a per-token
    projection and norm of the slice, gathered along the sequence over
    ``model`` in one ``all_gather`` of their concatenation (a residual
    that is not cut gives them whole already, their gradients summed
    over ``model`` where they leave: each rank's heads read them)."""
    c_q = rms_norm(x @ p.w_dq, p.q_norm, cfg.rms_eps)
    c_kv, k_rope = _latents(p, cfg, x, positions)
    both = torch.cat([c_q, c_kv, k_rope], -1)
    if L.seq_split:
        both = all_gather(both, "model", dim=1, mesh=L.mesh)
    else:
        both = psum_grad(both, "model", L.mesh)
    return both.split([c_q.shape[-1], c_kv.shape[-1], k_rope.shape[-1]], -1)


def _mla_attend_tp(p: MLA, cfg: ModelConfig, L: TPLayout, x, positions):
    """The train / prefill body on this rank: ``x`` its normed residual
    slice, ``positions`` the whole sequence's (B, S); dense below 4,096
    global tokens, chunked from 4,096, as ``mla_train`` is.  Returns (its float32
    partial of the output (B, S / model, d) before the sum over ``model``
    — the whole sequence where the residual is not cut — and the whole
    sequence's c_kv, k_rope)."""
    c_q, c_kv, k_rope = _latents_tp(p, cfg, L, x, own_seq(L, positions))
    q_nope, q_rope = _split_queries(cfg, c_q @ p.w_uq, positions)
    q_nope = ax(q_nope, "batch", None, "heads", None)
    out = _attend(cfg, q_nope, q_rope, c_kv, k_rope, p.w_uk, p.w_uv,
                  x.dtype)
    return matmul_f32(out, p.wo), c_kv, k_rope


def _time_cut(L: TPLayout, max_len: int) -> tuple[int, int]:
    """(first slot, slots) of this rank's time slice of a ``max_len``
    latent cache: cut over ``model`` where it divides (``cache_pspecs``),
    else the whole cache."""
    if L.model > 1 and max_len % L.model == 0:
        t = max_len // L.model
        return L.mi * t, t
    return 0, max_len


def mla_prefill_tp(p: MLA, cfg: ModelConfig, L: TPLayout, x, positions,
                   max_len: int):
    """``_mla_attend_tp``'s partial and this rank's latent cache: its time
    slice of the zero-padded ``max_len`` c_kv / k_rope (``_time_cut``)."""
    if max_len < L.seq:
        raise ValueError(f"max_len {max_len} < prompt {L.seq}")
    part, c_kv, k_rope = _mla_attend_tp(p, cfg, L, x, positions)
    lo, t = _time_cut(L, max_len)
    return part, {"c_kv": _pad_time(c_kv, max_len)[:, lo:lo + t].clone(),
                  "k_rope": _pad_time(k_rope, max_len)[:, lo:lo + t].clone()}


def _latent_attend_time_split(L: TPLayout, cfg: ModelConfig, q_lat, q_rope,
                              c_kv, k_rope, mask):
    """``_latent_attend`` over a time axis cut across ``model``: each rank
    scores every head's absorbed query against its slice c_kv / k_rope
    (B, T / model, *) under ``mask`` (B, 1, 1, T / model); the softmax is
    combined by log-sum-exp (the ``pmax`` of the ranks' maxima, then one
    ``psum`` of the latent outputs and the normalisers beside them), in
    float32, cast to the cache's type.  Every rank gets every head's
    o_lat (B, 1, H, kv_lora)."""
    scores = _latent_scores(cfg, q_lat, q_rope, c_kv, k_rope, mask)
    m = pmax(scores.amax(-1, keepdim=True), "model", mesh=L.mesh)
    w = torch.exp(scores - m)
    o = torch.einsum("bhst,btr->bhsr", w, c_kv.float())
    tot = psum(torch.cat([o, w.sum(-1, keepdim=True)], -1), "model",
               mesh=L.mesh)
    o_lat = tot[..., :-1] / tot[..., -1:]
    return o_lat.permute(0, 2, 1, 3).to(c_kv.dtype)


def mla_decode_tp(p: MLA, cfg: ModelConfig, L: TPLayout, x, cache,
                  position, max_len: int):
    """One-token step of this rank's heads: x (B, 1, d) whole on every
    model rank, ``cache`` this rank's slice of a ``max_len`` latent cache
    (``_time_cut``), written in place where it holds ``position``.
    Returns (its float32 partial of the output (B, 1, d), the same
    cache)."""
    q_nope, q_rope = _queries(p, cfg, x, position[:, None])  # its heads
    c_new, kr_new = _latents(p, cfg, x, position[:, None])
    c_kv, k_rope = cache["c_kv"], cache["k_rope"]
    lo, t = _time_cut(L, max_len)
    if c_kv.shape[1] != t:
        raise ValueError(f"a latent cache of {c_kv.shape[1]} slots on this "
                         f"rank; a {max_len} cache cuts to {t}")
    position = position.long()
    local = position - lo
    inside = (local >= 0) & (local < t)
    _write_slot(c_kv, c_new, local, inside)
    _write_slot(k_rope, kr_new, local, inside)
    idx = lo + torch.arange(t, device=x.device)
    mask = (idx[None, :] <= position[:, None])[:, None, None, :]
    q_lat = ax(_absorbed(cfg, q_nope, p.w_uk), "batch", None, "heads", None)
    if t != max_len:
        # every head's absorbed query against this rank's time slice,
        # combined across the ranks; then its own heads kept
        q = all_gather(torch.cat([q_lat, q_rope], -1), "model", dim=2,
                       mesh=L.mesh)
        r = cfg.kv_lora_rank
        o_lat = _latent_attend_time_split(L, cfg, q[..., :r], q[..., r:],
                                          c_kv, k_rope, mask)
        o_lat = o_lat[:, :, L.h_lo:L.h_lo + L.h_loc]
    else:
        o_lat = _latent_attend(cfg, q_lat, q_rope, c_kv, k_rope, mask)
    return (_expand(cfg, o_lat, p.w_uv, p.wo, f32=True),
            {"c_kv": c_kv, "k_rope": k_rope})
