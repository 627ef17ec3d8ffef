"""Gradient compression for the data-parallel all-reduce — the paper's §7
quantizer applied to distributed training (the port of
``repro.optim.compression``).

b-bit uniform quantization with per-tensor (lo, step), and ERROR
FEEDBACK: the quantization residual is carried into the next step's
gradient, so the scheme is unbiased in the long run.  Wire format per
tensor per step: b-bit codes + 2 float32 scalars.

The arithmetic is the reference's as its jitted steps compute it, bit
for bit: the codes ``floor((g - lo) / step)`` by a true float32 division
(XLA divides here, unlike the Pallas quantizer, ROADMAP R5: it does not
multiply by the reciprocal of ``step``), the reconstruction ``lo + (q +
0.5) * step`` fused by XLA into one FMA, rounded once (``_fma32``).  The
reference's function called eagerly rounds after the product and after
the sum, at most one float32 ulp from that; the port follows the
jitted step, the one its ``make_train_step`` runs, with or without a
mesh.

Under a mesh (a ``DeviceMesh`` installed by ``logical_sharding``) the
gradients and the error feedback are the rank's shards, and
``compress_gradients`` computes what the reference's sharded ``jit`` of
the same function computes: each leaf's lo and hi are the min and max of
the WHOLE global leaf (the local ones stacked into one float32 vector,
the minima negated, and one ``pmax`` over every mesh axis: min and max
are exact, so the order of the reduction does not matter), and the
reconstruction is that of the rank's own elements.  A leaf replicated
over an axis is reduced over it too, harmlessly.

The reference quantizes each leaf of its pytree, where the blocks of
``layers`` (and ``layers_dense``) are stacked on a leading L axis: one
(lo, step) covers that weight in every layer.  The port keeps one tensor
a block, so it groups them the same way (``models.reference_path``): lo
and hi are the group's min and max, and each member is quantized with
the group's scalars — the reference's codes and wire format exactly.

``wire_quantized_psum`` is the reference's shard_map-level collective:
§7's dithered quantizer on the wire of the data-parallel gradient sum,
over a mesh axis (``models.sharding``'s collectives).  Its arithmetic is
XLA's: the codes from a true float32 division by the shared scale, the
decoded sum multiplied by the float32 reciprocals of ``qmax`` and of the
rank count (XLA rewrites those two divisions by constants).  JAX's
threefry dither cannot be drawn by a ``torch.Generator``: ``key`` is a
``torch.Generator`` or a seed, and ``dither=`` takes given draws.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..models.model import reference_path
from ..models.sharding import (
    axis_size,
    current_mesh,
    mesh_axis_names,
    pmax,
    psum,
)
from .adamw import named_tensors

__all__ = [
    "GradCompressionConfig",
    "compress_gradients",
    "init_error_feedback",
    "payload_bytes",
    "wire_quantized_psum",
]


@dataclass(frozen=True)
class GradCompressionConfig:
    bits: int = 4
    dither: bool = False
    enabled: bool = True


def init_error_feedback(params):
    """Float32 zeros shaped like each parameter, by name."""
    return {n: torch.zeros_like(p, dtype=torch.float32)
            for n, p in named_tensors(params).items()}


def _quantize_leaf(g, bits: int):
    """Uniform b-bit quantization of one tensor; returns the float32
    reconstruction: midpoints of 2**bits bins over [min, max], error <=
    step / 2."""
    gf = g.float()
    return _quantize_in(gf, gf.min(), gf.max(), bits)


def _codes(gf, lo, hi, bits: int):
    """(the float32 bin of each element of ``gf`` among the 2**bits bins of
    [lo, hi], the bins' width): ``floor((gf - lo) / step)`` clipped, by a
    true float32 division."""
    n_levels = 1 << bits
    step = torch.clamp((hi - lo) / n_levels, min=1e-30)
    return (gf - lo).div_(step).floor_().clamp_(0, n_levels - 1), step


def _quantize_in(gf, lo, hi, bits: int):
    """``_quantize_leaf`` of float32 ``gf`` over the bins of [lo, hi]: the
    midpoints ``lo + (q + 0.5) * step``, rounded once, as XLA's FMA
    rounds them (``_fma32``)."""
    q, step = _codes(gf, lo, hi, bits)
    return _fma32(q.add_(0.5), step, lo)


#: elements ``_fma32`` widens to float64 at a time
_FMA_CHUNK = 1 << 22


def _fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once, as an FMA rounds it (``b`` and
    ``c`` 0-d), written into ``a`` (a contiguous copy of it if it is
    not).  In float64 the product of two float32
    numbers is exact (48 bits); the sum is rounded to odd (TwoSum's error
    moves an even result one ulp towards the exact sum), and a float64
    rounded to odd, rounded to nearest float32, is the exact sum rounded
    once.  The card and the CPU compute it alike.  ``_FMA_CHUNK``
    elements at a time, so the float64 scratch stays small."""
    a = a.contiguous()
    flat = a.view(-1)
    bd, cd = b.double(), c.double()
    for lo in range(0, flat.numel(), _FMA_CHUNK):
        part = flat[lo:lo + _FMA_CHUNK]
        p = part.double().mul_(bd)
        s = p + cd
        bv = s - p
        err = (p - (s - bv)).add_(cd - bv)  # s + err is p + c exactly
        even = (s.view(torch.int64) & 1) == 0
        toward = torch.where(err > 0, torch.inf, -torch.inf).to(s)
        s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
        part.copy_(s)
    return a


def _groups(names) -> dict[str, list[str]]:
    """The names under each leaf of the reference's pytree, in stack
    order."""
    out: dict[str, list[str]] = {}
    for n in names:
        out.setdefault(reference_path(n)[0], []).append(n)
    return out


def _device_mesh():
    """The installed mesh when it is a ``DeviceMesh`` (its ranks hold
    shards), else None."""
    mesh = current_mesh()
    return mesh if hasattr(mesh, "get_group") else None


def _bounds(corrected: dict[str, list[torch.Tensor]], mesh=None) -> dict:
    """{group: (lo, hi)}: the min and max over each group's tensors
    (``corrected``: {group: its members}), 0-d float32; with ``mesh``, of
    the global leaves the ranks' shards cut, by one ``pmax`` over every
    mesh axis of the stacked negated minima and maxima."""
    lows = torch.stack([torch.stack([c.min() for c in cs]).min()
                        for cs in corrected.values()])
    highs = torch.stack([torch.stack([c.max() for c in cs]).max()
                         for cs in corrected.values()])
    if mesh is not None:
        both = pmax(torch.cat([-lows, highs]), mesh_axis_names(mesh), mesh)
        lows, highs = -both[:len(lows)], both[len(lows):]
    return {g: (lo, hi) for g, lo, hi in zip(corrected, lows, highs)}


def compress_gradients(cfg: GradCompressionConfig, grads, error_feedback):
    """Returns (decoded grads as the receiver would see them, in each
    gradient's type; the new error feedback, float32), both by name.
    One (lo, step) per leaf of the reference's pytree (a weight of every
    stacked block shares it).  Under a ``DeviceMesh`` (module docstring)
    ``grads`` and ``error_feedback`` are this rank's shards, lo and hi
    those of the global leaves."""
    if not cfg.enabled:
        return grads, error_feedback
    grads = dict(grads)
    mesh = _device_mesh()
    corrected = {g: {n: grads[n].float() + error_feedback[n]
                     for n in members}
                 for g, members in _groups(grads).items()}
    bounds = _bounds({g: list(cs.values()) for g, cs in corrected.items()},
                     mesh)
    out, new_ef = {}, {}
    for g, group in corrected.items():
        lo, hi = bounds[g]
        for n, c in group.items():
            recon = _quantize_in(c, lo, hi, cfg.bits)
            new_ef[n] = c.sub_(recon)  # corrected - recon
            out[n] = recon.to(grads[n].dtype)
    return out, new_ef


def wire_quantized_psum(
    grads, axis: str, bits: int = 4, key=None, n_ranks: int | None = None,
    *, dither=None, mesh=None,
):
    """§7's dithered quantizer applied to the data-parallel gradient sum
    AT THE WIRE LEVEL: the mean over the ``axis`` ranks of ``grads``
    ({name: gradient}), as each rank's receiver decodes it.

    Per leaf of the reference's pytree (the blocks of a stacked leaf share
    it): shared scale = pmax of the local max |g| (at least 1e-30); each
    rank quantizes its gradient to ``bits``-bit signed codes
    ``clip(round(g / scale * qmax + dither), -qmax, qmax)`` (round half
    to even), the integer codes are psum'd in the smallest carrier that
    cannot overflow (int8 when ranks * qmax <= 127, else int16), and the
    sum is decoded as ``total * scale / qmax / ranks``.

    ``key``: ``None`` (no dither), a ``torch.Generator`` on the gradients'
    device, or an int seed for one; the draws are uniform on [-0.5, 0.5),
    leaf by leaf of the reference's pytree (a stacked leaf's blocks in
    order).  ``dither``: {name: draws shaped like the
    gradient}, used instead of ``key``.  ``mesh``: the ``DeviceMesh``
    (default: the installed one).
    """
    n = n_ranks if n_ranks is not None else axis_size(axis, mesh)
    qmax = (1 << (bits - 1)) - 1
    carrier = torch.int8 if n * qmax <= 127 else torch.int16
    grads = dict(grads)
    gen = key
    if key is not None and not isinstance(key, torch.Generator):
        device = next(iter(grads.values())).device
        gen = torch.Generator(device=device).manual_seed(int(key))

    out = {}
    for members in _groups(grads).values():
        local = torch.stack([grads[m].float().abs().max() for m in members])
        scale = torch.clamp(pmax(local.max(), axis, mesh), min=1e-30)
        one = torch.ones((), dtype=torch.float32, device=scale.device)
        recip_q, recip_n = one / qmax, one / n
        for m in members:
            g = grads[m]
            codes = _wire_codes(g, scale, qmax, carrier,
                                None if dither is None else dither[m], gen)
            total = psum(codes, axis, mesh)  # the only cross-rank traffic
            dec = total.float().mul_(scale).mul_(recip_q).mul_(recip_n)
            out[m] = dec.to(g.dtype)
    return out


def _wire_codes(g, scale, qmax: int, carrier, dither=None, gen=None):
    """One rank's codes ``clip(round(g / scale * qmax + dither), -qmax,
    qmax)`` in ``carrier``: the dither given, drawn from ``gen`` (uniform
    on [-0.5, 0.5)), or none."""
    t = torch.div(g.float(), scale).mul_(qmax)
    if dither is not None:
        t.add_(dither.to(t.device, torch.float32))
    elif gen is not None:
        t.add_(torch.rand(t.shape, generator=gen, device=t.device).sub_(0.5))
    return t.round_().clamp_(-qmax, qmax).to(carrier)


def payload_bytes(params, bits: int) -> int:
    """All-reduce payload per step under compression (codes + one pair of
    scales per leaf of the reference's pytree)."""
    named = named_tensors(params)
    n = sum(p.numel() for p in named.values())
    return n * bits // 8 + len(_groups(named)) * 8
