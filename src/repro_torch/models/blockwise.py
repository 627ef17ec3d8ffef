"""Chunked online-softmax attention in plain PyTorch — the port of
``repro.models.blockwise``.

The reference runs this through XLA without a Pallas kernel: it is the
dense path's memory-bounded form for long sequences (GQA at S >= 8,192
without flash, MLA at S >= 4,096).  The port keeps its arithmetic: scores
and accumulators in float32, masked scores filled with -1e30 (not -inf),
and ``acc / max(l, 1e-30)`` at the end, so a row whose first block is
fully masked takes the garbage weight exp(0) = 1 there and sheds it
exactly when a block with a live key rescales it by exp(-1e30 - m) = 0,
as the reference's row does, with no NaN.

One schedule serves every caller: each q block walks its live kv blocks
(``_block_rows``: causal rows stop at the diagonal, windows cut the
blocks before the window) in the order 0 .. row.  The reference has two
schedules, a table padded to the widest row and a balanced (p, nq-1-p)
pairing, only so that ``lax.scan`` gets an inner loop of constant
length; both visit each row's blocks in this same order, so a Python
loop over the live blocks gives their sums and computes no padded,
fully masked block.  ``v``'s head dim may differ from ``q`` / ``k``'s
(MLA: 192 against 128).
"""
from __future__ import annotations

import torch

__all__ = ["chunked_attention"]

_NEG_INF = -1e30


def _block_rows(n_q: int, n_k: int, q_chunk: int, kv_chunk: int,
                causal: bool, window: int) -> list[range]:
    """For each q block, the kv blocks that hold a key it may attend to."""
    rows = []
    for i in range(n_q):
        q_lo, q_hi = i * q_chunk, i * q_chunk + q_chunk - 1
        j_hi = (q_hi // kv_chunk) if causal else n_k - 1
        j_lo = max(0, (q_lo - window + 1) // kv_chunk) if window else 0
        rows.append(range(j_lo, min(j_hi, n_k - 1) + 1))
    return rows


def _update(state, q_blk, kb, vb, keep, scale):
    """One online-softmax step of one q block over one kv block.

    state: m, l (B,KV,rep,qc), acc (B,KV,rep,qc,hd_v) float32; q_blk
    (B,qc,KV,rep,hd); kb (B,kc,KV,hd); vb (B,kc,KV,hd_v); keep (qc,kc)
    bool or None (every key live).  Returns the new state."""
    m, l, acc = state
    sc = torch.einsum("bqgrh,bkgh->bgrqk", q_blk.float(), kb.float()) * scale
    if keep is not None:
        sc = torch.where(keep, sc, _NEG_INF)
    m_new = torch.maximum(m, sc.amax(-1))
    p = torch.exp(sc - m_new[..., None])
    alpha = torch.exp(m - m_new)
    l = l * alpha + p.sum(-1)
    acc = acc * alpha[..., None] + torch.einsum("bgrqk,bkgh->bgrqh", p,
                                                vb.float())
    return m_new, l, acc


def chunked_attention(
    q: torch.Tensor,  # (B, S, H, hd)
    k: torch.Tensor,  # (B, T, KV, hd)
    v: torch.Tensor,  # (B, T, KV, hd_v)
    *,
    causal: bool = True,
    window: int = 0,
    q_chunk: int = 1024,
    kv_chunk: int = 1024,
    scale: float | None = None,
) -> torch.Tensor:
    """Online-softmax attention over each q block's live kv blocks.

    GQA layout: H = KV * rep.  Never holds more than one
    (q_chunk x kv_chunk) score tile per (batch, head) at a time.
    Returns (B, S, H, hd_v) in q.dtype.
    """
    b, s, h, hd = q.shape
    t, kv = k.shape[1], k.shape[2]
    hd_v = v.shape[-1]
    rep = h // kv
    q_chunk = min(q_chunk, s)
    kv_chunk = min(kv_chunk, t)
    assert s % q_chunk == 0 and t % kv_chunk == 0, (s, t, q_chunk, kv_chunk)
    n_q, n_k = s // q_chunk, t // kv_chunk
    scale = scale if scale is not None else hd**-0.5

    qs = q.reshape(b, n_q, q_chunk, kv, rep, hd)
    q_off = torch.arange(q_chunk, device=q.device)
    k_off = torch.arange(kv_chunk, device=q.device)
    outs = []
    for i, blocks in enumerate(_block_rows(n_q, n_k, q_chunk, kv_chunk,
                                           causal, window)):
        q_pos = i * q_chunk + q_off
        state = (
            torch.full((b, kv, rep, q_chunk), _NEG_INF, dtype=torch.float32,
                       device=q.device),
            torch.zeros((b, kv, rep, q_chunk), dtype=torch.float32,
                        device=q.device),
            torch.zeros((b, kv, rep, q_chunk, hd_v), dtype=torch.float32,
                        device=q.device),
        )
        q_lo, q_hi = i * q_chunk, (i + 1) * q_chunk - 1
        for j in blocks:
            k_lo, k_hi = j * kv_chunk, (j + 1) * kv_chunk - 1
            gap = q_pos[:, None] - (k_lo + k_off)[None, :]
            # A block wholly inside the causal triangle and the window
            # needs no mask.
            keep = None
            if causal and q_lo < k_hi:
                keep = gap >= 0
            if window and q_hi - k_lo >= window:
                keep = (gap < window) if keep is None else keep & (gap < window)
            sl = slice(j * kv_chunk, (j + 1) * kv_chunk)
            state = _update(state, qs[:, i], k[:, sl], v[:, sl], keep, scale)
        _, l, acc = state
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        outs.append(out.permute(0, 3, 1, 2, 4))  # (B,qc,KV,rep,hd_v)
    out = torch.cat(outs, 1).reshape(b, s, h, hd_v)
    return out.to(q.dtype)
