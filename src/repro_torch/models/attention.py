"""GQA/MQA/MHA attention with RoPE, qk-norm, optional bias, sliding window,
KV-cache decode, and the hand-written flash kernel (K7) — the port of
``repro.models.attention``.

Parameters live in an ``Attention`` module holding the reference's
(d_in, d_out) weights; the functions keep the reference's names and take
the module where the reference takes its parameter dict.  Activations keep
the reference's layouts: (B, S, H, hd) attention, per-layer caches
``{"k", "v"}`` of (B, T, KV, hd) holding the real KV heads only.

The decode step writes the new key and value into the cache IN PLACE
(``index_put_`` at each row's slot) and returns the same buffers, where
JAX's ``.at[].set`` returns a fresh array: that saves a whole cache copy
per layer per step.  A slot past the cache is dropped, as JAX's scatter
drops it.

Under a mesh (``models.sharding.logical_sharding``) the heads are padded
as the reference pads them (``_head_padding``): to the smallest
(kv_pad, rep_pad) whose product divides the ``heads`` axis, zero query
heads in each group and zero KV groups.  The padded q / k / v go to K7 or
to the plain routes at their padded shapes, and the output keeps its real
heads only (``_unpad_heads``); the decode cache holds the real KV heads.
Without a mesh the padding is the identity.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import ModelConfig
from .blockwise import chunked_attention
from .layers import apply_rope, rms_norm
from .sharding import _axis_size, ax, current_mesh, current_rules

__all__ = [
    "Attention",
    "attention_decode",
    "attention_prefill",
    "attention_train",
    "init_attention",
    "init_kv_cache",
]

_NEG_INF = -1e30

# Full-sequence attention without the flash kernel switches to the chunked
# online-softmax path (models/blockwise.py) at this length, as the
# reference does.
BLOCKWISE_THRESHOLD = 8192


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


class Attention(nn.Module):
    """Projection weights of one attention layer: wq (d, H*hd), wk / wv
    (d, KV*hd), wo (H*hd, d); bq / bk / bv with ``qkv_bias``; q_norm /
    k_norm (hd,) with ``qk_norm`` (``None`` where the config has none)."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
        self.wq = _param((d, h * hd), dtype, device)
        self.wk = _param((d, kv * hd), dtype, device)
        self.wv = _param((d, kv * hd), dtype, device)
        self.wo = _param((h * hd, d), dtype, device)
        for name, n in (("bq", h * hd), ("bk", kv * hd), ("bv", kv * hd)):
            self.register_parameter(
                name, _param((n,), dtype, device) if cfg.qkv_bias else None
            )
        for name in ("q_norm", "k_norm"):
            self.register_parameter(
                name, _param((hd,), dtype, device) if cfg.qk_norm else None
            )


@torch.no_grad()
def init_attention(p: Attention, cfg: ModelConfig,
                   gen: torch.Generator) -> Attention:
    """Fill ``p`` as the reference initialises it: normal * d_in**-0.5,
    zero biases, unit norms (same scales, not the same bits)."""
    d, hd = cfg.d_model, cfg.head_dim_
    for w in (p.wq, p.wk, p.wv):
        w.normal_(0.0, d**-0.5, generator=gen)
    p.wo.normal_(0.0, (cfg.n_heads * hd) ** -0.5, generator=gen)
    for b in (p.bq, p.bk, p.bv):
        if b is not None:
            b.zero_()
    for n in (p.q_norm, p.k_norm):
        if n is not None:
            n.fill_(1.0)
    return p


def _project_qkv(p: Attention, cfg: ModelConfig, x, positions):
    b, s, d = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    q = x @ p.wq
    k = x @ p.wk
    v = x @ p.wv
    if cfg.qkv_bias:
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    q = q.reshape(b, s, h, hd)
    k = k.reshape(b, s, kv, hd)
    v = v.reshape(b, s, kv, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p.q_norm, cfg.rms_eps)
        k = rms_norm(k, p.k_norm, cfg.rms_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _sdpa(q, k, v, mask, n_rep: int):
    """Dense attention in plain torch, as the reference computes it in jnp
    outside any kernel.  q (B,S,H,hd), k/v (B,T,KV,hd); mask (B,1,S,T) or
    (1,1,S,T) bool."""
    b, s, h, hd = q.shape
    kvh = k.shape[2]
    q = q.reshape(b, s, kvh, n_rep, hd)
    scores = torch.einsum("bsgrh,btgh->bgrst", q, k) / (hd**0.5)
    scores = torch.where(mask[:, :, None], scores.float(), _NEG_INF)
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bgrst,btgh->bsgrh", w, v)
    return out.reshape(b, s, h, hd)


def _head_padding(cfg: ModelConfig) -> tuple[int, int]:
    """(kv_pad, rep_pad) so kv_pad*rep_pad divides the model axis evenly.

    Archs whose head count doesn't divide the 16-way model axis
    (starcoder2/granite: 24H, hymba: 25H/5KV) would otherwise be
    replicated by the ax() divisibility guard.  Padding heads to the next
    layout that divides costs only the pad ratio; the reference's search,
    smallest product first.
    """
    mesh = current_mesh()
    kv, rep = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads
    if mesh is None:
        return kv, rep
    axis = _axis_size(mesh, (current_rules() or {}).get("heads"))
    if (kv * rep) % axis == 0:
        return kv, rep
    best = None
    for kv_pad in range(kv, kv + axis + 1):
        for rep_pad in range(rep, rep + axis + 1):
            if (kv_pad * rep_pad) % axis == 0:
                if best is None or kv_pad * rep_pad < best[0] * best[1]:
                    best = (kv_pad, rep_pad)
    return best if best else (kv, rep)


def _shard_qkv(cfg: ModelConfig, q, k, v):
    """Pad the heads for the model axis (see ``_head_padding``).

    Returns (q, k, v, (kv_pad, rep_pad)); padded q/k/v have
    kv_pad*rep_pad total / kv_pad kv heads, zeros in the padding.
    Callers slice the output back with _unpad_heads.
    """
    b, s, _, hd = q.shape
    kv, rep = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads
    kv_pad, rep_pad = _head_padding(cfg)
    if (kv_pad, rep_pad) != (kv, rep):
        q = q.reshape(b, s, kv, rep, hd)
        q = F.pad(q, (0, 0, 0, rep_pad - rep, 0, kv_pad - kv))
        q = q.reshape(b, s, kv_pad * rep_pad, hd)
        k = F.pad(k, (0, 0, 0, kv_pad - kv))
        v = F.pad(v, (0, 0, 0, kv_pad - kv))
    q = ax(q, "batch", None, "heads", None)
    k = ax(k, "batch", None, "kv_heads", None)
    v = ax(v, "batch", None, "kv_heads", None)
    return q, k, v, (kv_pad, rep_pad)


def _unpad_heads(cfg: ModelConfig, out, pads):
    """out (B,S,kv_pad*rep_pad,hd) -> (B,S,H,hd) real heads only."""
    kv, rep = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads
    kv_pad, rep_pad = pads
    if (kv_pad, rep_pad) == (kv, rep):
        return out
    b, s, _, hd = out.shape
    out = out.reshape(b, s, kv_pad, rep_pad, hd)[:, :, :kv, :rep]
    return out.reshape(b, s, kv * rep, hd)


def _attend_full(q, k, v, cfg: ModelConfig, use_flash: bool):
    """Causal self-attention over the full sequence: the flash kernel (K7,
    on any length) when ``use_flash``, else the chunked online softmax
    from BLOCKWISE_THRESHOLD on, else dense attention.  Shapes may carry
    padded heads (see _head_padding)."""
    s = q.shape[1]
    n_rep = q.shape[2] // k.shape[2]
    if use_flash:
        from ..kernels.flash_attention.ops import flash_attention

        return flash_attention(q, k, v, causal=True,
                               window=cfg.sliding_window or None)
    if s >= BLOCKWISE_THRESHOLD:
        chunk = min(1024, cfg.sliding_window or 1024)
        return chunked_attention(q, k, v, causal=True,
                                 window=cfg.sliding_window, q_chunk=chunk,
                                 kv_chunk=chunk)
    idx = torch.arange(s, device=q.device)
    mask = idx[:, None] >= idx[None, :]
    if cfg.sliding_window:
        mask &= idx[:, None] - idx[None, :] < cfg.sliding_window
    return _sdpa(q, k, v, mask[None, None], n_rep)


def attention_train(p: Attention, cfg: ModelConfig, x, positions,
                    use_flash: bool = False):
    """Full-sequence causal attention (train / prefill)."""
    b, s, _ = x.shape
    q, k, v = _project_qkv(p, cfg, x, positions)
    q, k, v, pads = _shard_qkv(cfg, q, k, v)
    out = _attend_full(q, k, v, cfg, use_flash)
    out = _unpad_heads(cfg, ax(out, "batch", None, "heads", None), pads)
    return out.reshape(b, s, -1) @ p.wo


def attention_prefill(p: Attention, cfg: ModelConfig, x, positions,
                      max_len: int, use_flash: bool = False):
    """Full-sequence attention that also returns the decode-ready KV cache.

    The cache buffer matches init_kv_cache(max_len): with a sliding window
    it is the ring buffer holding the last ``window`` tokens (assumes
    window | S so ring slots line up with a plain tail slice).
    """
    b, s, _ = x.shape
    q, k, v = _project_qkv(p, cfg, x, positions)
    q, k, v, pads = _shard_qkv(cfg, q, k, v)
    out = _attend_full(q, k, v, cfg, use_flash)
    out = _unpad_heads(cfg, ax(out, "batch", None, "heads", None), pads)
    out = out.reshape(b, s, -1) @ p.wo

    # the decode cache stores REAL kv heads only (init_kv_cache layout)
    k = k[:, :, : cfg.n_kv_heads]
    v = v[:, :, : cfg.n_kv_heads]
    length = min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len
    if length < s:
        assert s % length == 0, (s, length)
        k_buf, v_buf = k[:, -length:].contiguous(), v[:, -length:].contiguous()
    else:
        k_buf = k.new_zeros((b, length, *k.shape[2:]))
        v_buf = v.new_zeros((b, length, *v.shape[2:]))
        k_buf[:, :s] = k
        v_buf[:, :s] = v
    return out, {"k": k_buf, "v": v_buf}


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                  device) -> dict[str, torch.Tensor]:
    kv, hd = cfg.n_kv_heads, cfg.head_dim_
    length = min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len
    return {
        "k": torch.zeros((batch, length, kv, hd), dtype=dtype, device=device),
        "v": torch.zeros((batch, length, kv, hd), dtype=dtype, device=device),
    }


def attention_decode(p: Attention, cfg: ModelConfig, x, cache, position):
    """One-token decode step.

    x: (B, 1, d); cache {k,v}: (B, T, KV, hd); position: (B,) current index.
    With a sliding window the cache is a ring buffer of size window.
    Writes the new key / value into ``cache`` in place and returns
    (out (B,1,d), the same cache).
    """
    b = x.shape[0]
    q, k_new, v_new = _project_qkv(p, cfg, x, position[:, None])
    t = cache["k"].shape[1]
    position = position.long()
    slot = position % max(t, 1) if cfg.sliding_window > 0 else position
    # scatter ONE slot per row in place; a slot past the cache is dropped
    # (the old value written back), as JAX's scatter drops it
    rows = torch.arange(b, device=x.device)
    inside = (slot < t)[:, None, None]
    slot = torch.where(slot < t, slot, 0)
    k, v = cache["k"], cache["v"]
    k.index_put_((rows, slot), torch.where(inside, k_new[:, 0], k[rows, slot]))
    v.index_put_((rows, slot), torch.where(inside, v_new[:, 0], v[rows, slot]))
    k = ax(k, "batch", None, "kv_heads", None)
    v = ax(v, "batch", None, "kv_heads", None)

    idx = torch.arange(t, device=x.device)[None, :]  # (1, T)
    if cfg.sliding_window:
        # ring buffer: every slot written within the last `t` tokens is valid
        mask = (idx <= position[:, None]) | (position[:, None] >= t)
    else:
        mask = idx <= position[:, None]
    n_rep = cfg.n_heads // cfg.n_kv_heads
    out = _sdpa(q, k, v, mask[:, None, None, :], n_rep)
    out = out.reshape(b, 1, -1) @ p.wo
    return out, {"k": k, "v": v}
