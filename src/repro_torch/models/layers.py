"""Shared model primitives: RMS norm, RoPE, the SwiGLU MLP, linear init
and the losses — the port of ``repro.models.layers``.  ``swiglu_partial``
is the SwiGLU of tensor parallelism: this rank's FF columns, its partial
of the output.

The losses take ``vocab=(mesh, lo)`` for vocab-parallel logits: each rank
holds the logits of its vocab rows [lo, lo + V / model) only, never the
whole (B, S, V).  The shift is the ``pmax`` of the local maxima over
``model`` (detached: the log-sum-exp's gradient does not depend on it),
the log-sum-exp the log of the ``psum`` of the local sums of exponentials,
the gold logit the ``psum`` of the one the label's owner holds (zero on
the others); each rank then holds every token's loss.  ``count`` divides
the sum instead of the local token count: the caller's global count,
whose ranks' sums it adds over ``data``."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .sharding import (
    ax,
    in_manual_region,
    layout_installed,
    layout_state,
    pmax,
    psum,
)

__all__ = [
    "apply_rope",
    "chunked_ce_loss",
    "cross_entropy_loss",
    "init_linear",
    "matmul_f32",
    "rms_norm",
    "rope_freqs",
    "swiglu",
    "swiglu_partial",
]


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """RMS norm over the last axis, computed in float32 and cast back."""
    dtype = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * scale.float()).to(dtype)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """theta ** -(2i / head_dim), float32, as the reference's compiled
    programs hold it: the exponent in float32, as the reference writes it,
    then the power and its reciprocal folded at compile time, one rounding
    (here through float64; to the bit at the registry's thetas), or, in a
    ``shard_map`` body (``sharding.manual_region``), computed at run time
    in float32, two roundings.  The two are an ulp apart at some
    frequencies, which moves a value rotated at position 4,096 by
    ~5e-5."""
    y = torch.arange(0, head_dim, 2, dtype=torch.float32,
                     device=device) / head_dim
    if in_manual_region():
        return 1.0 / theta ** y
    return (1.0 / theta ** y.double()).float()


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


def _swiglu_hidden(x, w1, w3, b1=None, b3=None):
    """silu(x w1 + b1) * (x w3 + b3), the SwiGLU's FF activation."""
    h = x @ w1
    g = x @ w3
    if b1 is not None:
        h = h + b1
        g = g + b3
    h = F.silu(h) * g
    return ax(h, "batch", None, "ff") if h.dim() == 3 else h


def swiglu(x, w1, w3, w2, b1=None, b3=None, b2=None):
    """SwiGLU MLP: w2( silu(x w1) * (x w3) ); weights (d_in, d_out)."""
    out = _swiglu_hidden(x, w1, w3, b1, b3) @ w2
    if b2 is not None:
        out = out + b2
    return out


class _MatmulF32(torch.autograd.Function):
    """``torch.mm(x, w, out_dtype=float32)``, which has no derivative in
    PyTorch, with the product's own: the float32 cotangent (of a partial
    that is rounded to ``x``'s type after its sum, so it holds that
    type's numbers) is cast back and multiplied in ``x``'s type."""

    @staticmethod
    def forward(ctx, x2, w):
        ctx.save_for_backward(x2, w)
        return torch.mm(x2, w, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        x2, w = ctx.saved_tensors
        g = g.to(x2.dtype)
        return g @ w.T, x2.T @ g


def matmul_f32(x, w):
    """``x @ w`` in float32: for bf16 operands the GEMM's float32
    accumulator itself (``torch.mm(..., out_dtype=float32)`` on the card,
    the operands widened on the CPU), not its bf16 rounding.  A
    row-parallel partial is summed across ranks in float32 and rounded
    once after, as the one-process product rounds once.  Differentiable
    (``_MatmulF32`` on the card)."""
    if x.dtype == torch.float32:
        return x @ w
    x2 = x.reshape(-1, x.shape[-1])
    if x2.is_cuda:
        out = _MatmulF32.apply(x2, w)
    else:
        out = x2.float() @ w.float()
    return out.reshape(*x.shape[:-1], w.shape[-1])


def swiglu_partial(x, w1, w3, w2, b1=None, b3=None, cols=slice(None)):
    """The column- / row-parallel SwiGLU of one rank: its FF columns of
    ``w1`` / ``w3`` (``cols`` of the whole ``b1`` / ``b3``) and its rows of
    ``w2`` give its float32 partial of the output (``matmul_f32``), which
    the caller sums over the model axis; a ``b2`` is added once, after
    that sum."""
    if b1 is not None:
        b1, b3 = b1[cols], b3[cols]
    return matmul_f32(_swiglu_hidden(x, w1, w3, b1, b3), w2)


def init_linear(gen: torch.Generator, d_in: int, d_out: int, dtype,
                scale: float | None = None) -> torch.Tensor:
    """A (d_in, d_out) weight: float32 normal * ``scale`` (d_in**-0.5 by
    default) drawn from ``gen`` on its device, cast to ``dtype`` (the
    reference's scale, not its bits)."""
    scale = scale if scale is not None else d_in**-0.5
    w = torch.randn((d_in, d_out), generator=gen, device=gen.device)
    return (w * scale).to(dtype)


def _gold(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return torch.take_along_dim(logits, labels.long()[..., None], -1)[..., 0]


def _nll(logits: torch.Tensor, labels: torch.Tensor,
         vocab=None) -> torch.Tensor:
    """Each token's negative log-likelihood, float32: whole logits, or
    this rank's vocab rows under ``vocab=(mesh, lo)`` (module
    docstring)."""
    logits = logits.float()
    if vocab is None:
        return torch.logsumexp(logits, dim=-1) - _gold(logits, labels)
    mesh, lo = vocab
    shift = pmax(logits.amax(-1), "model", mesh)
    sumexp = torch.exp(logits - shift[..., None]).sum(-1)
    lse = shift + torch.log(psum(sumexp, "model", mesh))
    mine = (labels >= lo) & (labels < lo + logits.shape[-1])
    gold = _gold(logits, torch.where(mine, labels - lo, 0))
    return lse - psum(torch.where(mine, gold, 0.0), "model", mesh)


def cross_entropy_loss(
    logits: torch.Tensor, labels: torch.Tensor,
    mask: torch.Tensor | None = None, vocab=None, count: int | None = None,
) -> torch.Tensor:
    """Stable softmax cross entropy in float32; logits (B, S, V) (or this
    rank's vocab rows, ``vocab``), labels (B, S); the mean over tokens,
    over ``mask``'s weight (at least 1), or the sum over ``count``."""
    nll = _nll(logits, labels, vocab)
    if mask is not None:
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    if count is not None:
        return nll.sum() / count
    return nll.mean()


def _chunk_nll_sum(xc, head, lc, vocab=None):
    return _nll(xc @ head, lc, vocab).sum()


def chunked_ce_loss(
    x: torch.Tensor,  # final hidden states (B, S, d)
    head: torch.Tensor,  # (d, V), or this rank's (d, V / model)
    labels: torch.Tensor,  # (B, S)
    chunk: int = 512,
    vocab=None,
    count: int | None = None,
) -> torch.Tensor:
    """Cross entropy WITHOUT materializing the full (B, S, V) logits.

    Walks the sequence in chunks; each chunk's sum is checkpointed, so the
    backward pass recomputes that chunk's logits (and, vocab-parallel,
    its collectives, with this thread's layout state) instead of keeping
    them: peak logits memory drops from O(S V) to O(chunk V).  The chunk
    sums add in sequence order into a float32 total, divided by B S (or
    ``count``), as the reference's scan adds them."""
    b, s, _ = x.shape
    chunk = min(chunk, s)
    assert s % chunk == 0, (s, chunk)
    state = layout_state()

    def body(xc, lc):
        with layout_installed(state):
            return _chunk_nll_sum(xc, head, lc, vocab)

    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for lo in range(0, s, chunk):
        total = total + checkpoint(
            body, x[:, lo:lo + chunk], labels[:, lo:lo + chunk],
            use_reentrant=False, preserve_rng_state=False,
        )
    return total / (count if count is not None else b * s)
