"""Plain-torch oracle for the uniform quantization kernel (§7 quantizer) —
the twins of ``repro.kernels.quantize.ref``."""
from __future__ import annotations

import torch

__all__ = ["dequantize_reference", "quantize_reference"]


def _f32(value, like: torch.Tensor) -> torch.Tensor:
    """``value`` as a 0-dim float32 tensor on ``like``'s device (a Python
    float rounds to nearest, as JAX's weak-typed scalars do).  Dividing by
    it is a true division on either device; a CPU scalar divisor may be
    turned into a product with its reciprocal on a card."""
    return torch.as_tensor(value, dtype=torch.float32, device=like.device)


def quantize_reference(x, lo, step, n_levels: int, dither=None):
    """x float -> (q int32, reconstruction float32).

    q = clip(floor((x - lo)/step + dither), 0, n_levels-1)
    recon = lo + (q + 0.5) * step   (midpoint reconstruction, the product
    and the sum each rounded to float32)
    """
    lo_t, step_t = _f32(lo, x), _f32(step, x)
    val = (x.float() - lo_t) / step_t
    if dither is not None:
        val = val + dither
    q = torch.clamp(torch.floor(val), 0, n_levels - 1).to(torch.int32)
    return q, dequantize_reference(q, lo, step)


def dequantize_reference(q, lo, step):
    """lo + (q + 0.5) * step in float32, the product and the sum each
    rounded (as the reference's jnp form is)."""
    lo_t, step_t = _f32(lo, q), _f32(step, q)
    return (q.float() + 0.5) * step_t + lo_t
