"""AdamW + cosine schedule + global-norm clipping — the port of
``repro.optim.adamw``, in the reference's own arithmetic.

Not ``torch.optim.AdamW``: its rounding and its state layout differ.
Here the moments are float32 whatever the parameter's type, the update is
computed in float32 and cast to the parameter's type, the clipping scale
is cast to the gradient's type before it multiplies, and ``b1 ** step``
is a float32 power, as in the reference (rounded correctly, which XLA's
is at all but a few steps).

Parameters are a ``TransformerLM`` (any ``nn.Module``: its
``named_parameters()``) or a ``{name: tensor}`` dict; gradients, the
moments ``m`` / ``v`` and the error feedback are ``{name: tensor}`` dicts
under the same names (``layers.0.attn.wq``), which
``convert.train_state_to_arrays`` stacks into the reference's
``{"m", "v", "step"}`` pytree for a checkpoint.  ``init_opt_state`` gives
zero moments of each parameter's type, as the reference's ``zeros_like``
does; the first update makes them float32.  ``adamw_update`` writes the
new parameters, and the float32 moments, IN PLACE, and puts each new
float32 moment into the state's own ``m`` / ``v`` dict as it is made,
freeing the moment it replaces: that stands in for the reference's
donated buffers (the first update of a bf16 model never holds every
bf16 zero moment beside every float32 one).

On shards (a ``TransformerLM`` cut by ``launch.shardings.shard_params``,
``mesh`` set): the global norm is the reference's norm of the global
arrays.  Each leaf's sum of squares is summed over the mesh axes its
spec cuts it over (one float64 ``psum`` for the leaves cut alike), and
a replicated leaf counts once; the float64 total is rounded once, as
without a mesh.  The update itself is elementwise, so it runs on each
shard unchanged.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
from torch import nn

from ..models.sharding import psum, spec_axes

__all__ = [
    "AdamWConfig",
    "adamw_update",
    "clip_by_global_norm",
    "init_opt_state",
    "schedule",
]


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1
    clip_norm: float = 1.0


def named_tensors(params) -> dict[str, torch.Tensor]:
    """``{name: tensor}`` of a module's parameters, or the dict itself."""
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def init_opt_state(params):
    """Zero moments shaped and typed like each parameter, and step 0
    (int32, on the parameters' device)."""
    named = named_tensors(params)
    device = next(iter(named.values())).device
    return {
        "m": {n: torch.zeros_like(p) for n, p in named.items()},
        "v": {n: torch.zeros_like(p) for n, p in named.items()},
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


def schedule(cfg: AdamWConfig, step):
    """Linear warm-up, then a cosine down to ``min_lr_frac`` of ``lr``; a
    float32 0-d tensor (on ``step``'s device when it is a tensor)."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp(
        (step - cfg.warmup_steps)
        / max(cfg.total_steps - cfg.warmup_steps, 1),
        0.0,
        1.0,
    )
    cos = 0.5 * (1 + torch.cos(math.pi * t))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def _global_norm(grads: dict, params=None) -> torch.Tensor:
    """The float32 global L2 norm.  The squares are float32, as in the
    reference; they are summed in float64, so the norm does not depend on
    the order of the sums (XLA's and torch's reductions differ).  With
    ``params`` a sharded ``TransformerLM``, ``grads`` are its shards':
    each group of leaves cut over the same axes has its sum added over
    those axes."""
    mesh = getattr(params, "mesh", None)
    groups: dict[tuple[str, ...], torch.Tensor] = {}
    for n, g in grads.items():
        axes = spec_axes(params.pspecs[n]) if mesh is not None else ()
        sq = torch.sum(torch.square(g.float()), dtype=torch.float64)
        groups[axes] = groups[axes] + sq if axes in groups else sq
    groups = {a: psum(t, a, mesh) if a else t for a, t in groups.items()}
    return torch.sqrt(sum(groups.values())).float()


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    # a true division: a Python number over a tensor would multiply by
    # the tensor's reciprocal
    limit = torch.full_like(norm, max_norm)
    return torch.clamp(limit / torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled so their global L2 norm is at most ``max_norm``, the
    float32 norm before scaling).  The scale is cast to each gradient's
    type before it multiplies."""
    grads = dict(grads)
    norm = _global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return {n: g * scale.to(g.dtype) for n, g in grads.items()}, norm


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params, grads, state):
    """Returns (params, new state, metrics ``{"grad_norm", "lr"}``).

    Clips ``grads`` by their global norm (of the global arrays when
    ``params`` are a rank's shards), then one AdamW step a
    parameter, one parameter at a time, in two float32 scratch tensors of
    that parameter's size (three for a bf16 parameter).  ``params`` is
    updated in place and returned; a float32 moment of ``state`` is
    updated in place, a moment of another type is replaced, in
    ``state["m"]`` / ``state["v"]`` itself and as soon as its parameter
    is done, by a float32 tensor.  The returned state holds those two
    dicts."""
    named = named_tensors(params)
    grads = dict(grads)
    norm = _global_norm(grads, params)
    scale = _clip_scale(norm, cfg.clip_norm)
    step = state["step"] + 1
    lr = schedule(cfg, step)
    b1, b2 = cfg.beta1, cfg.beta2
    bc1 = 1 - _pow(b1, step)
    bc2 = 1 - _pow(b2, step)
    new_m, new_v = state["m"], state["v"]
    for n, p in named.items():
        g = grads[n]
        gf = (g * scale.to(g.dtype)).float()
        m = _f32(state["m"][n])
        v = _f32(state["v"][n])
        # the reference's expressions, evaluated in the same order and
        # rounded at the same places, into gf and tmp
        tmp = torch.mul(gf, 1 - b1)
        m.mul_(b1).add_(tmp)  # m = b1 m + (1 - b1) g
        torch.mul(gf, 1 - b2, out=tmp).mul_(gf)
        v.mul_(b2).add_(tmp)  # v = b2 v + (1 - b2) g g
        _sqrt_(torch.div(v, bc2, out=tmp)).add_(cfg.eps)
        delta = torch.div(m, bc1, out=gf).div_(tmp)  # mhat / (sqrt + eps)
        pf = p.float()
        delta.add_(torch.mul(pf, cfg.weight_decay, out=tmp))
        p.copy_(torch.sub(pf, delta.mul_(lr), out=tmp))  # p - lr delta
        new_m[n], new_v[n] = m, v
    return params, {"m": new_m, "v": new_v, "step": step}, {"grad_norm": norm, "lr": lr}


def _pow(base: float, step: torch.Tensor) -> torch.Tensor:
    """float32 ``base ** step``, correctly rounded (a float64 power rounded
    once), so the card and the CPU agree: their float32 ``pow``s, and
    XLA's, miss by an ulp at a few steps (XLA's at 0.95 ** 58)."""
    base32 = torch.tensor(base, dtype=torch.float32, device=step.device)
    return (base32.double() ** step.double()).float()


def _sqrt_(t: torch.Tensor) -> torch.Tensor:
    """``t`` replaced by its correctly rounded float32 square root, as XLA
    computes it.  The card's ``sqrt`` is correctly rounded; the CPU's
    vectorised one is not always (it may miss by an ulp), so there it
    goes through float64, whose root rounds to the correctly rounded
    float32 one."""
    if t.is_cuda:
        return t.sqrt_()
    return t.copy_(torch.sqrt(t.double()))


def _f32(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when float32 (updated in place), else a float32 copy."""
    return t if t.dtype == torch.float32 else t.float()
