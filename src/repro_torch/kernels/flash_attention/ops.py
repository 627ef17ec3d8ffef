"""Public wrapper: the GQA layout around the flash kernel — the port of
``repro.kernels.flash_attention.ops``."""
from __future__ import annotations

import torch

from .flash_attention import _flash_attention_grouped
from .ref import mha_reference

__all__ = ["bh_layout", "flash_attention", "flash_attention_reference"]


def _heads_first(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B, T, KV, hd) -> (B, KV * n_rep, T, hd), each KV head repeated
    ``n_rep`` times in place (``jnp.repeat`` on the head axis)."""
    x = x.transpose(1, 2)
    return x.repeat_interleave(n_rep, dim=1) if n_rep > 1 else x


def flash_attention(
    q: torch.Tensor,  # (B, S, H, hd)
    k: torch.Tensor,  # (B, T, KV, hd)
    v: torch.Tensor,  # (B, T, KV, hd)
    causal: bool = True,
    window: int | None = None,
) -> torch.Tensor:
    """Returns (B, S, H, hd).  K7 reads each KV head for its H / KV query
    heads (GQA) itself, so the KV heads are not repeated as the reference
    repeats them; K7 runs on the tensors' device (the plain version on the
    CPU)."""
    b, s, h, hd = q.shape
    out = _flash_attention_grouped(*bh_layout(q, k, v), causal=causal,
                                   window=window)
    return out.reshape(b, h, s, hd).transpose(1, 2)


def bh_layout(q, k, v):
    """What ``flash_attention`` hands to K7: the contiguous (B * H, S, hd)
    q and (B * KV, T, hd) k, v (heads moved next to the batch, KV heads
    not repeated), and n_rep = H / KV."""
    b, s, h, hd = q.shape
    t, kv = k.shape[1], k.shape[2]
    # at B = 1 the reshape is a view of the transpose, not a copy
    qt = q.transpose(1, 2).reshape(b * h, s, hd).contiguous()
    kt = k.transpose(1, 2).reshape(b * kv, t, hd).contiguous()
    vt = v.transpose(1, 2).reshape(b * kv, t, hd).contiguous()
    return qt, kt, vt, h // kv


def flash_attention_reference(q, k, v, causal=True, window=None):
    """Same signature as flash_attention, evaluated with the oracle."""
    h = q.shape[2]
    n_rep = h // k.shape[2]
    qr = q.transpose(1, 2)
    kr = _heads_first(k, n_rep)
    vr = _heads_first(v, n_rep)
    return mha_reference(qr, kr, vr, causal, window).transpose(1, 2)
