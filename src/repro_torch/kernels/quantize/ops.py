"""Public wrapper: quantize / dequantize tensors of any shape — the port of
``repro.kernels.quantize.ops``."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .quantize import quantize
from .ref import dequantize_reference

__all__ = ["dequantize_tensor", "quantize_tensor", "tiles"]


def quantize_tensor(x: torch.Tensor, bits: int, dither: bool = False,
                    seed: int = 0):
    """x: any shape -> (q int32 same shape, recon float32, (lo, step)).

    ``lo`` and ``step`` are Python floats from the tensor's min and max
    (``step = max((hi - lo) / 2**bits, 1e-30)``), as the reference computes
    them on the host.  The flat tensor is tiled in rows of 256 columns
    (fewer below 256 elements), zero-padded at the end: an element's
    dither index is its flat index.  K6 runs on the tensor's device (the
    plain version on the CPU)."""
    n_levels = 1 << bits
    flat = x.reshape(-1)
    lo = float(flat.min())
    hi = float(flat.max())
    step = max((hi - lo) / n_levels, 1e-30)
    n = flat.shape[0]
    q, recon = quantize(tiles(x), lo, step, n_levels, dither, seed)
    q = q.reshape(-1)[:n].reshape(x.shape)
    recon = recon.reshape(-1)[:n].reshape(x.shape)
    return q, recon, (lo, step)


def tiles(x: torch.Tensor) -> torch.Tensor:
    """The (R, C) array ``quantize_tensor`` hands K6: the flat tensor in
    rows of 256 columns (all of it in one row below 256 elements), the
    last row zero-padded."""
    flat = x.reshape(-1)
    n = flat.shape[0]
    cols = 256 if n >= 256 else n
    pad = (-n) % cols
    x2 = F.pad(flat, (0, pad)) if pad else flat
    return x2.reshape(-1, cols).contiguous()


def dequantize_tensor(q: torch.Tensor, lo: float, step: float) -> torch.Tensor:
    """lo + (q + 0.5) * step in float32, the product and the sum each
    rounded, as the reference's jnp form (outside its kernel) rounds."""
    return dequantize_reference(q, lo, step)
