"""Shared model primitives: RMS norm, RoPE, the SwiGLU MLP — the port of
``repro.models.layers`` (the losses wait for the training slice, ROADMAP
Queue 1 item 12)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["apply_rope", "rms_norm", "rope_freqs", "swiglu"]


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """RMS norm over the last axis, computed in float32 and cast back."""
    dtype = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * scale.float()).to(dtype)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (
        theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                               device=device) / head_dim)
    )


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: (..., S) int.  Rotates the two halves
    of the head dimension (split halves, not interleaved pairs), in
    float32, and casts back."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)  # (hd/2,)
    angles = positions[..., :, None].float() * freqs  # (..., S, hd/2)
    cos = torch.cos(angles)[..., None, :]  # (..., S, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def swiglu(x, w1, w3, w2, b1=None, b3=None, b2=None):
    """SwiGLU MLP: w2( silu(x w1) * (x w3) ); weights (d_in, d_out)."""
    h = x @ w1
    g = x @ w3
    if b1 is not None:
        h = h + b1
        g = g + b3
    h = F.silu(h) * g
    out = h @ w2
    if b2 is not None:
        out = out + b2
    return out
