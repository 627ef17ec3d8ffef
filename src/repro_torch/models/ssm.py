"""Selective SSM (Mamba-style) branch of Hymba's parallel heads — the port
of ``repro.models.ssm``.

Diagonal selective state space: h_t = exp(dt_t * A) h_{t-1} + dt_t * B_t
x_t, y_t = C_t h_t + D x_t, with data-dependent dt / B / C, behind a
depthwise causal conv of width 4 done as explicit shifts.  The state is
(B, d_inner, ssm_state) float32 per layer: O(1) in context length.

Parameters live in an ``SSM`` module whose names are the reference's
leaves.  The reference runs the recurrence through XLA without a Pallas
kernel, so the port has no kernel for it either: ``selective_scan`` is a
plain PyTorch loop over the steps (one fused ``addcmul`` a step on the
(B, d_inner, ssm_state) state), with each chunk's decays, inputs and
outputs computed together.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import ModelConfig
from .attention import _param

__all__ = [
    "SSM",
    "init_ssm",
    "init_ssm_cache",
    "selective_scan",
    "ssm_decode",
    "ssm_prefill",
    "ssm_train",
]

_CONV_W = 4


class SSM(nn.Module):
    """w_in (d, 2 d_inner): u and the gate z; conv_w (4, d_inner); w_dt
    (d_inner, d_inner) and dt_bias (d_inner,); w_b / w_c (d_inner,
    ssm_state); a_log (d_inner, ssm_state), A = -exp(a_log); d_skip
    (d_inner,); w_out (d_inner, d)."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        d, di, st = cfg.d_model, cfg.d_inner_, cfg.ssm_state
        self.w_in = _param((d, 2 * di), dtype, device)
        self.conv_w = _param((_CONV_W, di), dtype, device)
        self.w_dt = _param((di, di), dtype, device)
        self.dt_bias = _param((di,), dtype, device)
        self.w_b = _param((di, st), dtype, device)
        self.w_c = _param((di, st), dtype, device)
        self.a_log = _param((di, st), dtype, device)
        self.d_skip = _param((di,), dtype, device)
        self.w_out = _param((di, d), dtype, device)


@torch.no_grad()
def init_ssm(p: SSM, cfg: ModelConfig, gen: torch.Generator) -> SSM:
    """Fill ``p`` at the reference's scales: projections normal *
    d_in**-0.5, conv_w normal * 0.5, dt_bias and a_log 0, d_skip 1 (same
    scales, not the same bits)."""
    d, di = cfg.d_model, cfg.d_inner_
    p.w_in.normal_(0.0, d**-0.5, generator=gen)
    p.conv_w.normal_(0.0, 0.5, generator=gen)
    for w in (p.w_dt, p.w_b, p.w_c, p.w_out):
        w.normal_(0.0, di**-0.5, generator=gen)
    p.dt_bias.zero_()
    p.a_log.zero_()
    p.d_skip.fill_(1.0)
    return p


def _conv(u, conv_w, conv_cache=None):
    """Depthwise causal width-4 conv via shifts. u: (B,S,di)."""
    b, s, di = u.shape
    if conv_cache is None:
        pad = u.new_zeros((b, _CONV_W - 1, di))
    else:
        pad = conv_cache  # (B, 3, di) — last 3 inputs
    full = torch.cat([pad, u], dim=1)  # (B, S+3, di)
    out = sum(full[:, i:i + s, :] * conv_w[i] for i in range(_CONV_W))
    new_cache = full[:, -(_CONV_W - 1):, :]
    return F.silu(out), new_cache


def _ssm_params(p: SSM, u):
    dt = F.softplus(u @ p.w_dt + p.dt_bias).float()
    bmat = (u @ p.w_b).float()
    cmat = (u @ p.w_c).float()
    a = -torch.exp(p.a_log.float())  # (di, st)
    return dt, bmat, cmat, a


def selective_scan(u, dt, bmat, cmat, a, d_skip, h0, chunk: int = 16):
    """u: (B,S,di); dt: (B,S,di); b/c: (B,S,st); a: (di,st); h0: (B,di,st).

    The reference's recurrence, step by step in float32: per chunk of
    ``chunk`` steps the decays exp(dt A) and inputs dt u B are computed
    at once, then each step is one ``addcmul`` on the carried state, then
    the chunk's outputs C h are one product.  ``chunk`` changes only how
    many steps share those launches, never a result.  Returns (y
    (B,S,di) float32, final state (B,di,st)).
    """
    b, s, di = u.shape
    uf = u.float()
    h = h0.float()
    ys = []
    for c0 in range(0, s, chunk):
        c1 = min(c0 + chunk, s)
        dtc = dt[:, c0:c1]
        da = torch.exp(dtc[..., None] * a)  # (B,C,di,st)
        dbu = (dtc * uf[:, c0:c1])[..., None] * bmat[:, c0:c1, None, :]
        hs = []
        for da_t, dbu_t in zip(da.unbind(1), dbu.unbind(1)):
            h = torch.addcmul(dbu_t, da_t, h)
            hs.append(h)
        ys.append(torch.einsum("bcds,bcs->bcd", torch.stack(hs, 1),
                               cmat[:, c0:c1]))
    y = torch.cat(ys, 1)
    return y + uf * d_skip.float(), h


def ssm_train(p: SSM, cfg: ModelConfig, x):
    out, _ = ssm_prefill(p, cfg, x)
    return out


def _ssm_branch(p: SSM, cfg: ModelConfig, x, h0, conv_cache=None):
    uz = x @ p.w_in
    u, z = uz.chunk(2, dim=-1)
    u, conv_cache = _conv(u, p.conv_w, conv_cache)
    dt, bmat, cmat, a = _ssm_params(p, u)
    y, h = selective_scan(u, dt, bmat, cmat, a, p.d_skip, h0)
    y = y.to(x.dtype) * F.silu(z)
    return y @ p.w_out, {"h": h, "conv": conv_cache}


def ssm_prefill(p: SSM, cfg: ModelConfig, x):
    """x: (B,S,d) -> ((B,S,d), decode cache {h, conv})."""
    h0 = torch.zeros((x.shape[0], cfg.d_inner_, cfg.ssm_state),
                     dtype=torch.float32, device=x.device)
    return _ssm_branch(p, cfg, x, h0)


def init_ssm_cache(cfg: ModelConfig, batch: int, dtype, device):
    return {
        "h": torch.zeros((batch, cfg.d_inner_, cfg.ssm_state),
                         dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, _CONV_W - 1, cfg.d_inner_), dtype=dtype,
                            device=device),
    }


def ssm_decode(p: SSM, cfg: ModelConfig, x, cache):
    """x: (B,1,d). Returns (out (B,1,d), new cache)."""
    return _ssm_branch(p, cfg, x, cache["h"], cache["conv"])
