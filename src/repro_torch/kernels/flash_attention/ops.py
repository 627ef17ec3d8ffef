"""Public wrapper: the GQA layout around the flash kernel — the port of
``repro.kernels.flash_attention.ops``."""
from __future__ import annotations

import torch

from .flash_attention import flash_attention_bh
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
    """Returns (B, S, H, hd).  KV heads are repeated to H (GQA) before K7,
    as the reference does; K7 runs on the tensors' device (the plain
    version on the CPU)."""
    b, s, h, hd = q.shape
    out = flash_attention_bh(*bh_layout(q, k, v), causal=causal,
                             window=window)
    return out.reshape(b, h, s, hd).transpose(1, 2)


def bh_layout(q, k, v):
    """The (BH, S, hd) / (BH, T, hd) contiguous tensors ``flash_attention``
    hands to K7: heads moved next to the batch, KV heads repeated."""
    b, s, h, hd = q.shape
    t = k.shape[1]
    n_rep = h // k.shape[2]
    qt = q.transpose(1, 2).reshape(b * h, s, hd)
    kt = _heads_first(k, n_rep).reshape(b * h, t, hd)
    vt = _heads_first(v, n_rep).reshape(b * h, t, hd)
    return qt, kt, vt


def flash_attention_reference(q, k, v, causal=True, window=None):
    """Same signature as flash_attention, evaluated with the oracle."""
    h = q.shape[2]
    n_rep = h // k.shape[2]
    qr = q.transpose(1, 2)
    kr = _heads_first(k, n_rep)
    vr = _heads_first(v, n_rep)
    return mha_reference(qr, kr, vr, causal, window).transpose(1, 2)
