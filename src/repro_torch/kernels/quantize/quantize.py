"""Uniform (optionally dithered) quantization — the port of
``repro.kernels.quantize.quantize``: K6.

``quantize(x, lo, step, n_levels, dither, seed, block)`` takes x (R, C)
float32 or bfloat16 and returns ``(q int32 (R, C), recon float32 (R, C))``
with, bit for bit as the reference's kernel computes them (its
interpret mode, the reference's only executable form off the TPU):

    d = x - lo
    val = d * inv                              without dither
    val = fma(d, inv, u)   (with dither)       ONE rounding; u in [-0.5, 0.5)
    q = clip(floor(val), 0, n_levels - 1)
    recon = fma(q + 0.5, step, lo)             ONE rounding

``lo`` and ``step`` are Python floats, rounded to float32, and ``inv`` is
the float32 reciprocal of the float32 ``step``: the kernel's ``/ step`` is
a division by a compile-time constant, which XLA turns into a product with
its reciprocal, and it fuses that product with the dither's add.  Values
on a bin edge can therefore get another code than a true division gives
(the reference's jnp oracle ``quantize_reference`` divides; so does the
port's twin in ``ref.py``).  The dither of
element (i, j) hashes its flat index ``i * C + j`` plus ``seed`` as uint32
(wrapping; a negative seed wraps too): ``z *= 2654435761``,
``z ^= z >> 16``, ``z *= 2246822519``, ``z ^= z >> 13``, then
``u = float32(z) / 2**32 - 0.5`` with ``float32(z)`` rounded to nearest.
``recon`` is a fused multiply-add in the reference's kernel, while its
``dequantize_tensor`` rounds the product and the sum apart: the two may
differ by one ulp, and the port keeps both (``ref.dequantize_reference``).

Dispatch is by the tensor's device.  On the CPU the entry runs the plain
PyTorch version ``_quantize_plain``.  On a CUDA device it launches the
hand-written Hopper kernel in ``csrc/quantize.cu`` (``_launch_quantize``)
or raises; it never falls back.  ``LAUNCHES["quantize"]`` counts the
kernel's launches.  ``block`` is the reference's row tile; K6 gives each
CTA ``block`` rows, which changes nothing in the result.  The reference's
``interpret=`` keyword is dropped.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .ref import _f32

__all__ = ["LAUNCHES", "quantize", "reset_launches"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_GRID = (1 << 31) - 1
_MASK32 = 0xFFFFFFFF

#: CUDA launches of K6 since the last reset.
LAUNCHES = {"quantize": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "quantize_forward": (
        [_P] * 3 + [ctypes.c_longlong] * 3 + [ctypes.c_float] * 3
        + [_I, _I, ctypes.c_uint, _I, _P],
        _I,
    ),
    "quantize_error_string": ([_I], ctypes.c_char_p),
}


def reset_launches() -> None:
    """Set the launch count to 0."""
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def _inv_step(step: float) -> float:
    """The float32 reciprocal of the float32 ``step``, as a Python float."""
    return float(np.float32(1.0) / np.float32(step))


def _seed32(seed: int) -> int:
    """The seed as the reference's int32 scalar, then its uint32 bits."""
    seed = int(seed)
    if not -(1 << 31) <= seed < (1 << 31):
        raise ValueError(f"seed must fit in int32, got {seed}")
    return seed & _MASK32


def quantize(
    x: torch.Tensor,  # (R, C)
    lo: float,
    step: float,
    n_levels: int,
    dither: bool = False,
    seed: int = 0,
    block: int = 256,
):
    """Returns (q int32 (R, C), recon float32 (R, C)).  CPU tensors run
    ``_quantize_plain``; CUDA tensors launch K6 or raise."""
    if not isinstance(x, torch.Tensor):
        raise TypeError("x must be a torch.Tensor")
    if x.dim() != 2:
        raise ValueError(f"x must be (R, C), got shape {tuple(x.shape)}")
    if n_levels < 1 or block < 1:
        raise ValueError(f"n_levels and block must be >= 1, got "
                         f"{n_levels}, {block}")
    _seed32(seed)
    if x.device.type == "cpu":
        return _quantize_plain(x, lo, step, n_levels, dither, seed, block)
    return _launch_quantize(x, lo, step, n_levels, dither, seed, block)


def _mul32(z: torch.Tensor, c: int) -> torch.Tensor:
    """(z * c) mod 2**32 for int64 z in [0, 2**32) and c < 2**32, with
    every intermediate below 2**63 (no signed overflow)."""
    lo16, hi16 = z & 0xFFFF, z >> 16
    return (lo16 * c + (((hi16 * c) & 0xFFFF) << 16)) & _MASK32


def _dither(shape, seed: int, device) -> torch.Tensor:
    """The reference's counter-hash uniforms in [-0.5, 0.5), float32."""
    n = shape[0] * shape[1]
    z = (torch.arange(n, dtype=torch.int64, device=device) + _seed32(seed))
    z = z & _MASK32
    z = _mul32(z, 2654435761)
    z = z ^ (z >> 16)
    z = _mul32(z, 2246822519)
    z = z ^ (z >> 13)
    # int64 -> float32 rounds to nearest; / 2**32 is exact
    u = z.to(torch.float32) / 4294967296.0 - 0.5
    return u.reshape(shape)


def _fma_f32(a: torch.Tensor, b: torch.Tensor,
             c: torch.Tensor) -> torch.Tensor:
    """a * b + c for float32 tensors of one shape (or 0-dim) with ONE
    rounding to float32 (fmaf).
    The product of two float32 values is exact in float64 (24 + 24
    significant bits; no underflow here, as step >= 1e-30).  The float64
    sum is rounded to odd (moved to its odd neighbour when inexact), which
    makes its rounding to float32 the correctly rounded result."""
    p = a.double() * b.double()
    cd = c.double().expand_as(p)
    s = p + cd
    bb = s - p
    err = (p - (s - bb)) + (cd - bb)  # s + err == p + cd exactly (TwoSum)
    even = (s.view(torch.int64) & 1) == 0
    away = torch.where(err > 0, torch.inf, -torch.inf).to(torch.float64)
    s = torch.where((err != 0) & even, torch.nextafter(s, away), s)
    return s.to(torch.float32)


def _quantize_plain(x, lo, step, n_levels: int, dither: bool = False,
                    seed: int = 0, block: int = 256):
    """K6's arithmetic in PyTorch, element for element (``block`` changes
    nothing here either)."""
    lo_t, step_t, inv_t = _f32(lo, x), _f32(step, x), _f32(_inv_step(step), x)
    d = x.float() - lo_t
    if dither:
        val = _fma_f32(d, inv_t.expand_as(d), _dither(x.shape, seed, x.device))
    else:
        val = d * inv_t
    q = torch.clamp(torch.floor(val), 0, n_levels - 1)
    recon = _fma_f32(q + 0.5, step_t, lo_t)
    return q.to(torch.int32), recon


def _library() -> ctypes.CDLL:
    from ..build import load

    return load("quantize", _SIGNATURES)


def _raise_on(err: int, fn: str) -> None:
    if err:
        msg = _library().quantize_error_string(err).decode()
        raise RuntimeError(f"{fn} failed: CUDA error {err} ({msg})")


def _launch_quantize(x, lo, step, n_levels: int, dither: bool = False,
                     seed: int = 0, block: int = 256):
    """Launch K6 on the card: one CTA of 256 threads per ``block`` rows,
    four elements a thread at a time (16-byte float4 loads where the
    layout allows)."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"K6 launches on a CUDA device, got {dev}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"K6 takes float32 or bfloat16, got {x.dtype}")
    if x.dim() != 2:
        raise ValueError(f"x must be (R, C), got shape {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if x.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned")
    r, c = x.shape
    block = min(block, r)
    if min(r, c) <= 0:
        raise ValueError(f"K6 needs a non-empty input, got ({r}, {c})")
    if -(-r // block) > _MAX_GRID:
        raise ValueError(f"K6's grid would exceed {_MAX_GRID} CTAs")
    if n_levels - 1 >= 1 << 24:
        raise ValueError(
            f"n_levels - 1 must be exact in float32, got {n_levels}")
    q = torch.empty((r, c), dtype=torch.int32, device=dev)
    recon = torch.empty((r, c), dtype=torch.float32, device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        err = lib.quantize_forward(
            x.data_ptr(), q.data_ptr(), recon.data_ptr(), r, c, block,
            float(lo), float(step), _inv_step(step), int(n_levels),
            int(bool(dither)),
            _seed32(seed), _DTYPES[x.dtype],
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on(err, "quantize_forward")
    LAUNCHES["quantize"] += 1
    return q, recon
