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

Tensor parallelism (``models.tensor_parallel``; the parameters are this
rank's shards) runs ``attention_train_tp`` / ``attention_prefill_tp`` /
``attention_decode_tp``: the rank's query heads from its columns of
``wq`` (and of ``bq``), the KV heads those heads read, and its rows of
``wo``, returning the partial output the caller sums over ``model``.
Training takes the plain attention (K7 has no backward, and the
reference's train step does not take its Pallas kernel either); prefill
shares its body and adds the cache.  Where the KV heads divide the
model axis each rank holds its own, cache included.  Where they do not,
K and V are whole on every rank (``wk`` / ``wv``'s columns, cut mid-head,
gathered over ``model``), each rank attends with its heads against the
KV heads they map to (``_local_kv``), and the decode cache is cut along
TIME (``launch.shardings.cache_pspecs``): the rank owning a position
writes it, each rank scores its slice, and a log-sum-exp combine over
``model`` (``pmax``, then one ``psum`` of the rescaled sums and outputs)
gives the attention; for that every rank scores all query heads (the
one-token q gathered over ``model``) and keeps its own after.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import ModelConfig
from .blockwise import chunked_attention
from .layers import apply_rope, matmul_f32, rms_norm
from .sharding import (
    _axis_size,
    all_gather,
    ax,
    current_mesh,
    current_rules,
    pmax,
    psum,
)
from .tensor_parallel import TPLayout, partitioned_leaf

__all__ = [
    "Attention",
    "attention_decode",
    "attention_decode_tp",
    "attention_prefill",
    "attention_prefill_tp",
    "attention_train",
    "attention_train_tp",
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


def _project_qkv(p: Attention, cfg: ModelConfig, x, positions,
                 L: TPLayout | None = None):
    """q (B, S, H, hd), k / v (B, S, KV, hd) of ``x`` (B, S, d).  Under a
    tensor-parallel layout ``L`` the weights are this rank's columns: q
    holds its H / model heads, k / v its KV heads where they divide the
    model axis, else all of them (``wk`` / ``wv``'s columns cut mid-head
    are gathered over ``model``).  The leaves whole on every rank enter
    its heads through ``partitioned_leaf``: the biases, the q / k norms
    and a ``wk`` / ``wv`` whose columns are not cut."""
    b, s, _ = x.shape
    hd = cfg.head_dim_
    leaf = (lambda t: t) if L is None else functools.partial(
        partitioned_leaf, L)
    wk, wv = p.wk, p.wv
    if L is not None and not (L.kv_split or L.kv_cols):
        wk, wv = leaf(wk), leaf(wv)
    q, k, v = x @ p.wq, x @ wk, x @ wv
    if cfg.qkv_bias:
        if L is None:
            q, k, v = q + p.bq, k + p.bk, v + p.bv
        else:
            cols = _kv_cols(cfg, L)
            q = q + leaf(p.bq)[L.h_lo * hd:(L.h_lo + L.h_loc) * hd]
            k, v = k + leaf(p.bk)[cols], v + leaf(p.bv)[cols]
    if L is not None and L.kv_cols:
        k = all_gather(k, "model", dim=-1, mesh=L.mesh)
        v = all_gather(v, "model", dim=-1, mesh=L.mesh)
    q = q.reshape(b, s, -1, hd)
    k = k.reshape(b, s, -1, hd)
    v = v.reshape(b, s, -1, hd)
    if cfg.qk_norm:
        q = rms_norm(q, leaf(p.q_norm), cfg.rms_eps)
        k = rms_norm(k, leaf(p.k_norm), cfg.rms_eps)
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
    k, v = cache["k"], cache["v"]
    _write_slot(k, k_new, slot, slot < t)
    _write_slot(v, v_new, slot, slot < t)
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


def _write_slot(buf, new, slot, inside):
    """Write each row's one new (B, 1, KV, hd) key or value into ``buf``
    (B, T, KV, hd) IN PLACE at its ``slot``, where ``inside``; elsewhere
    the old value is written back (a slot past the cache is dropped, as
    JAX's scatter drops it)."""
    rows = torch.arange(buf.shape[0], device=buf.device)
    slot = torch.where(inside, slot, 0)
    buf.index_put_((rows, slot), torch.where(inside[:, None, None],
                                             new[:, 0], buf[rows, slot]))


# ---------------------------------------------------------------------------
# tensor-parallel serving: this rank's heads
# ---------------------------------------------------------------------------
def _kv_cols(cfg: ModelConfig, L: TPLayout) -> slice:
    """This rank's columns of ``wk`` / ``wv`` (and of ``bk`` / ``bv``,
    which are whole)."""
    hd = cfg.head_dim_
    if L.kv_split:
        return slice(L.kv_lo * hd, (L.kv_lo + L.kv_loc) * hd)
    if L.kv_cols:
        n = cfg.n_kv_heads * hd // L.model
        return slice(L.mi * n, (L.mi + 1) * n)
    return slice(None)


def _local_kv(cfg: ModelConfig, L: TPLayout, k):
    """(the KV heads of ``k`` (B, T, KV', hd) that this rank's query heads
    read, their n_rep).  Where the KV heads divide the model axis ``k``
    holds this rank's already; else the rank's heads lie in one group
    (``tp_layout`` refuses heads that straddle groups), that KV head."""
    if L.kv_split:
        return k, cfg.n_heads // cfg.n_kv_heads
    g = L.h_lo // (cfg.n_heads // cfg.n_kv_heads)
    return k[:, :, g:g + 1], L.h_loc


def _time_split(L: TPLayout, max_len: int) -> bool:
    """Whether the decode cache is cut along time over ``model``: the KV
    heads do not divide it and the length does (``cache_pspecs``)."""
    return not L.kv_split and max_len % L.model == 0


def _attend_tp(p: Attention, cfg: ModelConfig, L: TPLayout, x, positions,
               use_flash: bool):
    """This rank's heads over the whole sequence ``x`` (B, S, d): (its
    float32 partial of the output (B, S, d), its k, v)."""
    b, s, _ = x.shape
    q, k, v = _project_qkv(p, cfg, x, positions, L)
    q = ax(q, "batch", None, "heads", None)
    k = ax(k, "batch", None, "kv_heads", None)
    v = ax(v, "batch", None, "kv_heads", None)
    kq, rep = _local_kv(cfg, L, k)
    vq, _ = _local_kv(cfg, L, v)
    out = ax(_attend_full(q, kq, vq, cfg, use_flash),
             "batch", None, "heads", None)
    return matmul_f32(out.reshape(b, s, -1), p.wo), k, v


def attention_train_tp(p: Attention, cfg: ModelConfig, L: TPLayout, x,
                       positions, use_flash: bool = False):
    """This rank's heads over the whole sequence ``x`` (B, S, d): its
    float32 partial of the output, to be summed over ``model``.  The
    plain attention trains; ``use_flash`` takes K7, which refuses
    autograd (``KernelGradientError``), as ``attention_train`` does."""
    return _attend_tp(p, cfg, L, x, positions, use_flash)[0]


def attention_prefill_tp(p: Attention, cfg: ModelConfig, L: TPLayout, x,
                         positions, max_len: int, use_flash: bool = False):
    """``attention_train_tp``'s partial (K7 or the plain routes at the
    rank's heads over the KV heads they read), and this rank's decode
    cache in ``cache_pspecs``'s local shape."""
    b, s, _ = x.shape
    if max_len < s:
        raise ValueError(f"max_len {max_len} < prompt {s}")
    part, k, v = _attend_tp(p, cfg, L, x, positions, use_flash)
    if _time_split(L, max_len):
        t_loc = max_len // L.model
        lo = L.mi * t_loc
        n = max(min(s, lo + t_loc) - lo, 0)
        k_buf = k.new_zeros((b, t_loc, *k.shape[2:]))
        v_buf = v.new_zeros((b, t_loc, *v.shape[2:]))
        k_buf[:, :n] = k[:, lo:lo + n]
        v_buf[:, :n] = v[:, lo:lo + n]
    else:
        k_buf = k.new_zeros((b, max_len, *k.shape[2:]))
        v_buf = v.new_zeros((b, max_len, *v.shape[2:]))
        k_buf[:, :s] = k
        v_buf[:, :s] = v
    return part, {"k": k_buf, "v": v_buf}


def _sdpa_time_split(L: TPLayout, q, k, v, mask, n_rep: int):
    """``_sdpa`` over a time axis cut across ``model``: each rank scores
    every query head of ``q`` against its slice ``k`` / ``v``
    (B, T / model, KV, hd) under ``mask`` (B, 1, S, T / model); the softmax
    is combined by log-sum-exp (the ``pmax`` of the ranks' maxima, then
    one ``psum`` of the outputs and the normalisers beside them), in
    float32, cast to q's type.  Every rank gets the whole output."""
    b, s, h, hd = q.shape
    kvh = k.shape[2]
    qg = q.reshape(b, s, kvh, n_rep, hd)
    scores = torch.einsum("bsgrh,btgh->bgrst", qg, k) / (hd**0.5)
    scores = torch.where(mask[:, :, None], scores.float(), _NEG_INF)
    m = pmax(scores.amax(-1, keepdim=True), "model", mesh=L.mesh)
    w = torch.exp(scores - m)
    o = torch.einsum("bgrst,btgh->bgrsh", w, v.float())
    tot = psum(torch.cat([o, w.sum(-1, keepdim=True)], -1), "model",
               mesh=L.mesh)
    out = tot[..., :hd] / tot[..., hd:]
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, h, hd).to(q.dtype)


def attention_decode_tp(p: Attention, cfg: ModelConfig, L: TPLayout, x,
                        cache, position, max_len: int):
    """One-token step of this rank's heads: x (B, 1, d) whole on every
    model rank, ``cache`` this rank's (``cache_pspecs``'s local shape of a
    ``max_len`` cache), written in place.  Returns (its partial of the
    output (B, 1, d), the same cache)."""
    b = x.shape[0]
    q, k_new, v_new = _project_qkv(p, cfg, x, position[:, None], L)
    q = ax(q, "batch", None, "heads", None)
    k, v = cache["k"], cache["v"]
    t = k.shape[1]
    position = position.long()
    if _time_split(L, max_len):
        # the rank whose slice holds the position writes it; every rank
        # scores ALL query heads over its time slice (the combine sums a
        # head's parts across the ranks), then keeps its own heads
        slot = position - L.mi * t
        inside = (slot >= 0) & (slot < t)
        _write_slot(k, k_new, slot, inside)
        _write_slot(v, v_new, slot, inside)
        idx = L.mi * t + torch.arange(t, device=x.device)[None, :]
        mask = idx <= position[:, None]
        q_all = all_gather(q, "model", dim=2, mesh=L.mesh)
        out = _sdpa_time_split(L, q_all, k, v, mask[:, None, None, :],
                               cfg.n_heads // cfg.n_kv_heads)
        out = out[:, :, L.h_lo:L.h_lo + L.h_loc]
    else:
        _write_slot(k, k_new, position, position < t)
        _write_slot(v, v_new, position, position < t)
        k = ax(k, "batch", None, "kv_heads", None)
        v = ax(v, "batch", None, "kv_heads", None)
        kq, rep = _local_kv(cfg, L, k)
        vq, _ = _local_kv(cfg, L, v)
        mask = torch.arange(t, device=x.device)[None, :] <= position[:, None]
        out = _sdpa(q, kq, vq, mask[:, None, None, :], rep)
    out = ax(out, "batch", None, "heads", None)
    return matmul_f32(out.reshape(b, 1, -1), p.wo), {"k": k, "v": v}
