"""Plain-torch oracle for the flash attention kernel — the twin of
``repro.kernels.flash_attention.ref.mha_reference``."""
from __future__ import annotations

import torch

__all__ = ["mha_reference"]

_NEG_INF = -1e30


def mha_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    window: int | None = None,
) -> torch.Tensor:
    """q: (B, H, S, hd); k, v: (B, H, T, hd) (kv heads already repeated).

    Returns (B, H, S, hd).  The causal mask is RIGHT-aligned when T != S
    (query row i sits at key position i + T - S), as the oracle's is; the
    kernel and its plain version count both axes from 0 instead, so the
    two agree only at S == T, which is all the model passes."""
    s, t = q.shape[2], k.shape[2]
    scores = torch.einsum("bhsd,bhtd->bhst", q, k).float()
    scores = scores / (q.shape[-1] ** 0.5)
    idx_s = torch.arange(s, device=q.device)[:, None]
    idx_t = torch.arange(t, device=q.device)[None, :]
    mask = torch.ones((s, t), dtype=torch.bool, device=q.device)
    if causal:
        mask &= idx_s + (t - s) >= idx_t  # right-aligned causal
    if window is not None:
        mask &= idx_s + (t - s) - idx_t < window
    scores = torch.where(mask[None, None], scores, _NEG_INF)
    w = torch.softmax(scores, dim=-1)
    return torch.einsum("bhst,bhtd->bhsd", w, v.float()).to(q.dtype)
