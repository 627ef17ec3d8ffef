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
"""
from __future__ import annotations

import torch
from torch import nn

from ..configs.base import ModelConfig
from .attention import _param
from .blockwise import chunked_attention
from .layers import apply_rope, rms_norm

__all__ = [
    "MLA",
    "init_mla",
    "init_mla_cache",
    "mla_decode",
    "mla_prefill",
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


def _queries(p: MLA, cfg: ModelConfig, x, positions):
    b, s, _ = x.shape
    h = cfg.n_heads
    qk_n, qk_r = cfg.qk_nope_dim, cfg.qk_rope_dim
    c_q = rms_norm(x @ p.w_dq, p.q_norm, cfg.rms_eps)
    q = (c_q @ p.w_uq).reshape(b, s, h, qk_n + qk_r)
    q_nope, q_rope = q[..., :qk_n], q[..., qk_n:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    return q_nope, q_rope


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


def _mla_attend(p: MLA, cfg: ModelConfig, x, positions):
    """Shared train / prefill body; returns (out, c_kv, k_rope)."""
    b, s, _ = x.shape
    h = cfg.n_heads
    qk_n, qk_r, vh = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    q_nope, q_rope = _queries(p, cfg, x, positions)
    c_kv, k_rope = _latents(p, cfg, x, positions)
    k_nope = (c_kv @ p.w_uk).reshape(b, s, h, qk_n)
    v = (c_kv @ p.w_uv).reshape(b, s, h, vh)
    scale = (qk_n + qk_r) ** -0.5
    if s >= MLA_CHUNKED_THRESHOLD:
        out = _attend_chunked(q_nope, q_rope, k_nope, k_rope, v, scale)
    else:
        out = _attend_dense(q_nope, q_rope, k_nope, k_rope, v, scale,
                            x.dtype)
    return out @ p.wo, c_kv, k_rope


def mla_train(p: MLA, cfg: ModelConfig, x, positions):
    """Full-sequence causal MLA (train / prefill): explicit k/v expansion."""
    out, _, _ = _mla_attend(p, cfg, x, positions)
    return out


def mla_prefill(p: MLA, cfg: ModelConfig, x, positions, max_len: int):
    """Full-sequence MLA returning the latent decode cache (c_kv, k_rope),
    zero-padded to ``max_len``."""
    b, s, _ = x.shape
    out, c_kv, k_rope = _mla_attend(p, cfg, x, positions)
    if max_len > s:
        c_kv = torch.cat([c_kv, c_kv.new_zeros((b, max_len - s,
                                                 c_kv.shape[-1]))], 1)
        k_rope = torch.cat([k_rope, k_rope.new_zeros((b, max_len - s,
                                                       k_rope.shape[-1]))], 1)
    return out, {"c_kv": c_kv, "k_rope": k_rope}


def init_mla_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                   device):
    return {
        "c_kv": torch.zeros((batch, max_len, cfg.kv_lora_rank), dtype=dtype,
                            device=device),
        "k_rope": torch.zeros((batch, max_len, cfg.qk_rope_dim), dtype=dtype,
                              device=device),
    }


def mla_decode(p: MLA, cfg: ModelConfig, x, cache, position):
    """One-token decode with the latent cache and W_uk / W_uv absorption.
    Writes the new latent and rope key into ``cache`` in place and returns
    (out (B,1,d), the same cache)."""
    b = x.shape[0]
    h = cfg.n_heads
    qk_n, qk_r, vh = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    kvr = cfg.kv_lora_rank
    q_nope, q_rope = _queries(p, cfg, x, position[:, None])  # (B,1,H,*)
    c_new, kr_new = _latents(p, cfg, x, position[:, None])

    c_kv, k_rope = cache["c_kv"], cache["k_rope"]
    t = c_kv.shape[1]
    position = position.long()
    rows = torch.arange(b, device=x.device)
    inside = (position < t)[:, None]
    slot = torch.where(position < t, position, 0)
    c_kv.index_put_((rows, slot),
                    torch.where(inside, c_new[:, 0], c_kv[rows, slot]))
    k_rope.index_put_((rows, slot),
                      torch.where(inside, kr_new[:, 0], k_rope[rows, slot]))

    # absorption: score_nope = (q_nope W_uk^T) . c_kv in latent space
    w_uk = p.w_uk.reshape(kvr, h, qk_n)
    q_lat = torch.einsum("bshq,rhq->bshr", q_nope, w_uk)  # (B,1,H,kvr)
    scale = (qk_n + qk_r) ** -0.5
    scores = (torch.einsum("bshr,btr->bhst", q_lat, c_kv)
              + torch.einsum("bshq,btq->bhst", q_rope, k_rope)) * scale
    idx = torch.arange(t, device=x.device)
    mask = (idx[None, :] <= position[:, None])[:, None, None, :]
    w = torch.softmax(torch.where(mask, scores.float(), _NEG_INF),
                      dim=-1).to(x.dtype)
    # output in latent space, then expand with W_uv
    o_lat = torch.einsum("bhst,btr->bshr", w, c_kv)  # (B,1,H,kvr)
    w_uv = p.w_uv.reshape(kvr, h, vh)
    out = torch.einsum("bshr,rhv->bshv", o_lat, w_uv).reshape(b, 1, -1)
    return out @ p.wo, {"c_kv": c_kv, "k_rope": k_rope}
