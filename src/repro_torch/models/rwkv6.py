"""RWKV-6 "Finch" (arXiv:2404.05892): attention-free time-mix with
data-dependent per-channel decay + squared-ReLU channel-mix — the port of
``repro.models.rwkv6``.

Parameters live in ``RWKV6TimeMix`` and ``ChannelMix`` modules whose
parameter names are the reference's leaves, so a reference pytree carries
across unchanged (``convert.lm_params_from_arrays``).  The functions keep
the reference's names, layouts and float32 state.

The recurrence runs three ways.  ``rwkv6_prefill(..., use_flash=False)``
does what the reference does: ``wkv_chunked`` at S >= 64 with S a multiple
of 16, else ``wkv_scan``, in torch.  With ``use_flash=True`` the prompt's
recurrence goes through ``kernels.rwkv6_scan.ops.wkv6``: K8 on a card, its
plain version on the CPU (the reference's model never reaches its Pallas
kernel; its twins stay here as the comparison).  ``ops.wkv6`` no longer
folds the layout: K8 reads the (B, S, H, hd) r, k, v (in the model's
type) and the float32 w and state that ``_mix_inputs`` makes, as they
are, and writes y contiguous in (B, S, H, hd).  Decode is one
``wkv_scan`` step over the (B, H, hd, hd) state, as in the reference.

Tensor parallelism (``models.tensor_parallel``; the parameters are this
rank's shards): ``_time_mix_tp`` (the train block's) /
``rwkv6_prefill_tp`` / ``rwkv6_decode_tp`` run the time-mix of the rank's heads (its column
blocks of ``w_r``, ``w_k``, ``w_v``, ``w_g``; its rows of ``w_o``, a
float32 partial the caller sums over ``model``), K8 on those heads when
``use_flash``; ``channel_mix_tp`` gathers the squared-ReLU k along d_ff
and each rank's d_model columns of the output.  The residual stays whole
on every model rank (the reference's ``_res_ax`` for RWKV6); the
token-shift caches hold the rank's d_model slice and are gathered each
step.  In training the leaves every model rank holds whole (``mu``,
``w0``, the LoRA factors, ``u``, ``head_norm``) enter the rank's heads
or columns through ``partitioned_leaf``, which sums their gradients over
``model``.

Simplifications vs the full Finch release (as in the reference): single-
lerp token shift (not ddlerp) and RMS head-norm instead of GroupNorm.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import ModelConfig
from ..kernels.rwkv6_scan.ops import wkv6
from .attention import _param
from .layers import matmul_f32, rms_norm
from .sharding import all_gather
from .tensor_parallel import partitioned_leaf

__all__ = [
    "ChannelMix",
    "RWKV6TimeMix",
    "WKV_CHUNK_THRESHOLD",
    "channel_mix_decode",
    "channel_mix_decode_tp",
    "channel_mix_tp",
    "channel_mix_train",
    "init_channel_mix",
    "init_rwkv6",
    "init_rwkv6_cache",
    "rwkv6_decode",
    "rwkv6_decode_tp",
    "rwkv6_prefill",
    "rwkv6_prefill_tp",
    "rwkv6_train",
    "wkv_chunked",
    "wkv_scan",
]

_LORA = 64

# sequence length at which the chunked form takes over from the plain scan
WKV_CHUNK_THRESHOLD = 64


class RWKV6TimeMix(nn.Module):
    """mu (5, d): the r, k, v, w, g shift mixes; w_r / w_k / w_v / w_g / w_o
    (d, d); w0 (d,) the base log-decay; w_lora_a (d, 64) and w_lora_b
    (64, d) the decay's data-dependent part; u (H, hd) the per-head bonus;
    head_norm (hd,)."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        d, h, hd = cfg.d_model, cfg.n_heads, cfg.head_dim_
        self.mu = _param((5, d), dtype, device)
        for name in ("w_r", "w_k", "w_v", "w_g", "w_o"):
            setattr(self, name, _param((d, d), dtype, device))
        self.w0 = _param((d,), dtype, device)
        self.w_lora_a = _param((d, _LORA), dtype, device)
        self.w_lora_b = _param((_LORA, d), dtype, device)
        self.u = _param((h, hd), dtype, device)
        self.head_norm = _param((hd,), dtype, device)


class ChannelMix(nn.Module):
    """mu (2, d): the k, r shift mixes; w_k (d, d_ff), w_v (d_ff, d),
    w_r (d, d)."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        self.mu = _param((2, d), dtype, device)
        self.w_k = _param((d, f), dtype, device)
        self.w_v = _param((f, d), dtype, device)
        self.w_r = _param((d, d), dtype, device)


@torch.no_grad()
def init_rwkv6(p: RWKV6TimeMix, cfg: ModelConfig,
               gen: torch.Generator) -> RWKV6TimeMix:
    """Fill ``p`` at the reference's scales: projections normal *
    d_in**-0.5, the LoRA factors normal * 0.01, mu 0.5, w0 -5 (slow
    decay), u 0, head_norm 1 (same scales, not the same bits)."""
    d = cfg.d_model
    for w in (p.w_r, p.w_k, p.w_v, p.w_g, p.w_o):
        w.normal_(0.0, d**-0.5, generator=gen)
    p.w_lora_a.normal_(0.0, 0.01, generator=gen)
    p.w_lora_b.normal_(0.0, 0.01, generator=gen)
    p.mu.fill_(0.5)
    p.w0.fill_(-5.0)
    p.u.zero_()
    p.head_norm.fill_(1.0)
    return p


@torch.no_grad()
def init_channel_mix(p: ChannelMix, cfg: ModelConfig,
                     gen: torch.Generator) -> ChannelMix:
    d, f = cfg.d_model, cfg.d_ff
    p.mu.fill_(0.5)
    p.w_k.normal_(0.0, d**-0.5, generator=gen)
    p.w_v.normal_(0.0, f**-0.5, generator=gen)
    p.w_r.normal_(0.0, d**-0.5, generator=gen)
    return p


def _token_shift(x, x_prev):
    """x: (B,S,d). Returns x_{t-1} with x_prev filling t=0."""
    return torch.cat([x_prev[:, None, :], x[:, :-1, :]], dim=1)


def _mix_inputs(p: RWKV6TimeMix, cfg: ModelConfig, x, x_prev):
    xs = _token_shift(x, x_prev)
    mu = p.mu  # (5, d)

    def mix(i):
        return x + (xs - x) * mu[i]

    xr, xk, xv, xw, xg = (mix(i) for i in range(5))
    b, s, _ = x.shape
    h, hd = cfg.n_heads, cfg.head_dim_
    r = (xr @ p.w_r).reshape(b, s, h, hd)
    k = (xk @ p.w_k).reshape(b, s, h, hd)
    v = (xv @ p.w_v).reshape(b, s, h, hd)
    g = F.silu(xg @ p.w_g)
    # data-dependent decay (Finch): w = exp(-exp(w0 + tanh(xw A) B))
    dw = torch.tanh(xw @ p.w_lora_a) @ p.w_lora_b
    logw = p.w0.float() + dw.float()
    w = torch.exp(-torch.exp(logw)).reshape(b, s, h, hd)  # in (0,1)
    return r, k, v, g, w


def wkv_scan(r, k, v, w, u, state):
    """The WKV6 recurrence (float32 state for stability).

    r,k,v,w: (B,S,H,hd); u: (H,hd); state: (B,H,hd,hd).
    Returns (out (B,S,H,hd), final state).
      y_t = r_t . (S_{t-1} + (u*k_t) v_t^T);  S_t = diag(w_t) S_{t-1} + k_t v_t^T
    """
    rf, kf, vf, wf = (a.float() for a in (r, k, v, w))
    uf = u.float()[..., :, None]
    s_t = state.float()
    ys = []
    for t in range(rf.shape[1]):
        kv = kf[:, t, ..., :, None] * vf[:, t, ..., None, :]  # (B,H,hd,hd)
        ys.append(torch.einsum("bhi,bhij->bhj", rf[:, t], s_t + uf * kv))
        s_t = wf[:, t, ..., :, None] * s_t + kv
    return torch.stack(ys, 1), s_t


def wkv_chunked(r, k, v, w, u, state, chunk: int = 16):
    """Chunk-parallel WKV6 (the reference's jnp twin of its kernel; math
    identical to wkv_scan).

    Within a chunk of C steps, with L the inclusive cumulative log-decay
    and L_ex the exclusive one:

      y_t = (r_t * e^{L_ex,t}) . S_0                         (inter-chunk)
          + sum_{i<t} [sum_k r_t k_i e^{L_ex,t - L_i}] v_i    (intra)
          + (r_t . (u * k_t)) v_t                            (bonus diag)
      S' = e^{L_C} * S_0 + sum_i (k_i e^{L_C - L_i}) v_i^T

    The intra-chunk exponent L_ex,t - L_i (i < t) sums log-decays strictly
    after i, so it is <= 0 and cannot overflow for any decay; the pairwise
    tensor is (B,C,C,H,hd).
    """
    b, s, h, hd = r.shape
    chunk = min(chunk, s)
    assert s % chunk == 0, (s, chunk)
    n = s // chunk
    rf, kf, vf = (a.float() for a in (r, k, v))
    lw = torch.log(torch.clamp(w.float(), min=1e-38))  # (B,S,H,hd) <= 0
    uf = u.float()

    def resh(a):
        return a.reshape(b, n, chunk, h, hd).transpose(0, 1)

    rs, ks, vs, lws = resh(rf), resh(kf), resh(vf), resh(lw)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=r.device), -1)  # strict i < t
    s0 = state.float()
    ys = []
    for c in range(n):
        rc, kc, vc, lwc = rs[c], ks[c], vs[c], lws[c]  # (B,C,H,hd)
        L = torch.cumsum(lwc, dim=1)  # inclusive
        L_ex = L - lwc  # exclusive (L_{t-1})
        rr = rc * torch.exp(L_ex)
        y_inter = torch.einsum("bchk,bhkj->bchj", rr, s0)
        delta = L_ex[:, :, None] - L[:, None]  # (B,C,C,H,hd), [t, i]
        delta = torch.where(tri[None, :, :, None, None], delta, -torch.inf)
        scores = torch.einsum("bthk,bihk,btihk->bhti", rc, kc,
                              torch.exp(delta))
        y_intra = torch.einsum("bhti,bihj->bthj", scores, vc)
        diag = torch.einsum("bchk,bchk->bch", rc, uf[None, None] * kc)
        ys.append(y_inter + y_intra + diag[..., None] * vc)
        k_tail = kc * torch.exp(L[:, -1:] - L)
        s0 = torch.exp(L[:, -1])[..., None] * s0 + torch.einsum(
            "bchk,bchj->bhkj", k_tail, vc
        )
    return torch.cat(ys, dim=1), s0


def rwkv6_train(p: RWKV6TimeMix, cfg: ModelConfig, x, positions=None,
                use_flash: bool = False):
    out, _ = rwkv6_prefill(p, cfg, x, use_flash)
    return out


def rwkv6_prefill(p: RWKV6TimeMix, cfg: ModelConfig, x,
                  use_flash: bool = False):
    """Full-sequence time-mix; also returns the O(1)-size decode cache
    pieces for this branch, ``{"state", "x_prev_tm"}``.

    ``use_flash`` picks the recurrence: False computes what the reference
    does (``wkv_chunked`` at S >= 64 with S % 16 == 0, else ``wkv_scan``);
    True sends it through ``ops.wkv6``, which is K8 on a card."""
    b, s, d = x.shape
    h, hd = cfg.n_heads, cfg.head_dim_
    x_prev = torch.zeros((b, d), dtype=x.dtype, device=x.device)
    r, k, v, g, w = _mix_inputs(p, cfg, x, x_prev)
    state = torch.zeros((b, h, hd, hd), dtype=torch.float32, device=x.device)
    if use_flash:
        y, state = wkv6(r, k, v, w, p.u, state)
    elif s >= WKV_CHUNK_THRESHOLD and s % 16 == 0:
        y, state = wkv_chunked(r, k, v, w, p.u, state)
    else:
        y, state = wkv_scan(r, k, v, w, p.u, state)
    y = rms_norm(y, p.head_norm, cfg.rms_eps).to(x.dtype)
    y = y.reshape(b, -1, d) * g.to(x.dtype)
    out = y @ p.w_o
    return out, {"state": state, "x_prev_tm": x[:, -1, :]}


def channel_mix_train(p: ChannelMix, x, x_prev=None):
    b, _, d = x.shape
    xp = x_prev if x_prev is not None else torch.zeros(
        (b, d), dtype=x.dtype, device=x.device)
    xs = _token_shift(x, xp)
    xk = x + (xs - x) * p.mu[0]
    xr = x + (xs - x) * p.mu[1]
    k = torch.square(torch.relu(xk @ p.w_k))
    r = torch.sigmoid(xr @ p.w_r)
    return r * (k @ p.w_v)


# ---------------------------------------------------------------------------
# decode: O(1) state per layer = (wkv state, x_prev_timemix, x_prev_chanmix)
# ---------------------------------------------------------------------------
def init_rwkv6_cache(cfg: ModelConfig, batch: int, dtype, device):
    h, hd, d = cfg.n_heads, cfg.head_dim_, cfg.d_model
    return {
        "state": torch.zeros((batch, h, hd, hd), dtype=torch.float32,
                             device=device),
        "x_prev_tm": torch.zeros((batch, d), dtype=dtype, device=device),
        "x_prev_cm": torch.zeros((batch, d), dtype=dtype, device=device),
    }


def rwkv6_decode(p_tm: RWKV6TimeMix, cfg: ModelConfig, x, cache):
    """x: (B,1,d). Returns (time-mix out, new state, new x_prev_tm)."""
    b, _, d = x.shape
    r, k, v, g, w = _mix_inputs(p_tm, cfg, x, cache["x_prev_tm"])
    y, state = wkv_scan(r, k, v, w, p_tm.u, cache["state"])
    y = rms_norm(y, p_tm.head_norm, cfg.rms_eps).to(x.dtype)
    y = y.reshape(b, 1, d) * g.to(x.dtype)
    out = y @ p_tm.w_o
    return out, state, x[:, 0, :]


def channel_mix_decode(p_cm: ChannelMix, x, x_prev):
    out = channel_mix_train(p_cm, x, x_prev)
    return out, x[:, 0, :]


# ---------------------------------------------------------------------------
# tensor parallelism: this rank's heads and FF columns
# ---------------------------------------------------------------------------
def _own_d(L, x):
    """This rank's d_model slice of ``x`` (..., d): the cut
    ``cache_pspecs`` gives the token-shift caches ``x_prev_tm`` /
    ``x_prev_cm`` (``check_cut`` makes d_model divide the model axis)."""
    n = x.shape[-1] // L.model
    return x[..., L.mi * n:(L.mi + 1) * n]


def _whole_d(L, x_prev):
    """The whole (B, d) token-shift input from this rank's slice."""
    return all_gather(x_prev, "model", dim=-1, mesh=L.mesh)


def _mix_inputs_tp(p: RWKV6TimeMix, cfg: ModelConfig, L, x, x_prev):
    """``_mix_inputs`` for this rank's heads: r, k, v (B, S, h_loc, hd) and
    g from its column blocks of ``w_r`` / ``w_k`` / ``w_v`` / ``w_g``, the
    decay from its columns of ``w_lora_b`` and ``w0`` (both whole), each
    made contiguous in the model's layout as K8 reads it.  The whole
    leaves enter through ``partitioned_leaf``."""
    xs = _token_shift(x, x_prev)
    mu = partitioned_leaf(L, p.mu)

    def mix(i):
        return x + (xs - x) * mu[i]

    xr, xk, xv, xw, xg = (mix(i) for i in range(5))
    b, s, _ = x.shape
    h, hd = L.h_loc, cfg.head_dim_
    cols = slice(L.h_lo * hd, (L.h_lo + h) * hd)
    r = (xr @ p.w_r).reshape(b, s, h, hd)
    k = (xk @ p.w_k).reshape(b, s, h, hd)
    v = (xv @ p.w_v).reshape(b, s, h, hd)
    g = F.silu(xg @ p.w_g)
    dw = (torch.tanh(xw @ partitioned_leaf(L, p.w_lora_a))
          @ partitioned_leaf(L, p.w_lora_b)[:, cols])
    logw = partitioned_leaf(L, p.w0)[cols].float() + dw.float()
    w = torch.exp(-torch.exp(logw)).reshape(b, s, h, hd)
    return r, k, v, g, w


def _time_mix_out(p: RWKV6TimeMix, cfg: ModelConfig, L, y, g, dtype):
    """The rank's heads' WKV output, head-normed and gated, against its
    rows of ``w_o``: its float32 partial of the time-mix (B, S, d)."""
    b, s = y.shape[:2]
    y = rms_norm(y, partitioned_leaf(L, p.head_norm), cfg.rms_eps).to(dtype)
    return matmul_f32(y.reshape(b, s, -1) * g.to(dtype), p.w_o)


def _time_mix_tp(p: RWKV6TimeMix, cfg: ModelConfig, L, x, use_flash: bool):
    """The time-mix of this rank's heads over the whole sequence ``x``
    (B, S, d) from a zero state: (its float32 partial of the output, its
    final state (B, h_loc, hd, hd)).  The recurrence takes the
    reference's route (``wkv_chunked`` at S >= 64 with S a multiple of
    16, else ``wkv_scan``), or K8 when ``use_flash`` (``u`` its (h_loc,
    hd) rows), which refuses autograd."""
    b, s, d = x.shape
    x_prev = torch.zeros((b, d), dtype=x.dtype, device=x.device)
    r, k, v, g, w = _mix_inputs_tp(p, cfg, L, x, x_prev)
    u = partitioned_leaf(L, p.u)[L.h_lo:L.h_lo + L.h_loc]
    state = torch.zeros((b, L.h_loc, cfg.head_dim_, cfg.head_dim_),
                        dtype=torch.float32, device=x.device)
    if use_flash:
        y, state = wkv6(r, k, v, w, u, state)
    elif s >= WKV_CHUNK_THRESHOLD and s % 16 == 0:
        y, state = wkv_chunked(r, k, v, w, u, state)
    else:
        y, state = wkv_scan(r, k, v, w, u, state)
    return _time_mix_out(p, cfg, L, y, g, x.dtype), state


def rwkv6_prefill_tp(p: RWKV6TimeMix, cfg: ModelConfig, L, x,
                     use_flash: bool = False):
    """``_time_mix_tp``'s partial, to be summed over ``model``, and this
    rank's cache ``{"state": (B, h_loc, hd, hd), "x_prev_tm": its d_model
    slice}``."""
    part, state = _time_mix_tp(p, cfg, L, x, use_flash)
    return part, {"state": state, "x_prev_tm": _own_d(L, x[:, -1, :])}


def rwkv6_decode_tp(p: RWKV6TimeMix, cfg: ModelConfig, L, x, cache):
    """One step of this rank's heads, x (B, 1, d) whole: (its float32
    partial, its new state, its slice of the new ``x_prev_tm``).  The
    token shift takes the whole previous token, gathered from the
    ranks' slices."""
    r, k, v, g, w = _mix_inputs_tp(p, cfg, L, x,
                                   _whole_d(L, cache["x_prev_tm"]))
    y, state = wkv_scan(r, k, v, w, p.u[L.h_lo:L.h_lo + L.h_loc],
                        cache["state"])
    return _time_mix_out(p, cfg, L, y, g, x.dtype), state, _own_d(L, x[:, 0])


def channel_mix_tp(p: ChannelMix, L, x, x_prev=None):
    """The channel-mix on this rank, x (B, S, d) whole: the whole output.

    The stored cuts do not line up as Megatron's would: ``w_k`` holds the
    rank's d_ff / model columns and ``w_r`` its d_model / model columns,
    but ``w_v`` (d_ff, d) all of d_ff for its d_model / model columns.  So
    the squared-ReLU k of the rank's FF columns is gathered over
    ``model`` along d_ff, each rank computes its d_model columns of
    ``r * (k @ w_v)`` whole (each sums all of d_ff, as one process does),
    and those are gathered, in a prefill and a decode step alike: the
    one site that does not follow ``TPLayout.move_weights``, for one path
    over both.  Gathering ``w_v`` instead would move 14 % fewer bytes at
    rwkv6-1.6b's 4 x 2,048 prefill, and 29 MB a layer in every decode
    step.

    In training ``x`` enters through ``column_input`` (each rank's
    gradient of it is partial), ``mu`` through ``partitioned_leaf``; k's
    gather transposes to a reduce-scatter of the ranks' partial
    gradients, the output's to this rank's block of the whole gradient
    every rank holds."""
    b, _, d = x.shape
    xp = x_prev if x_prev is not None else torch.zeros(
        (b, d), dtype=x.dtype, device=x.device)
    xs = _token_shift(x, xp)
    mu = partitioned_leaf(L, p.mu)
    xk = x + (xs - x) * mu[0]
    xr = x + (xs - x) * mu[1]
    k = all_gather(torch.square(torch.relu(xk @ p.w_k)), "model", dim=-1,
                   mesh=L.mesh)
    r = torch.sigmoid(xr @ p.w_r)
    return all_gather(r * (k @ p.w_v), "model", dim=-1, mesh=L.mesh,
                      grad="slice")


def channel_mix_decode_tp(p: ChannelMix, L, x, x_prev):
    """One step, x (B, 1, d) whole: (the whole output, this rank's slice of
    the new ``x_prev_cm``); ``x_prev`` is the rank's slice."""
    return channel_mix_tp(p, L, x, _whole_d(L, x_prev)), _own_d(L, x[:, 0])
