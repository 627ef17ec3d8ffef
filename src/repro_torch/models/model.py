"""TransformerLM, dense-GQA and RWKV6 subset — the port of
``repro.models.model``.

Parameters live in ``nn.Module``s: ``TransformerLM`` holds the embedding,
the final norm, the untied head and an ``nn.ModuleList`` of ``Block``s
(``norm1``, ``Attention``, ``norm2``, ``MLP``).  The reference stacks its
layers on a leading L axis for ``lax.scan``; the port loops over the list.
The reference's function names stay as thin functions over those modules
(``forward(cfg, params, tokens, ...)``, ``prefill``, ``decode_step``, ...),
so a test calls both packages the same way.  The decode cache is
``{"layers": [{"k", "v"} per layer], "pos": (B,) int32}``.

This slice serves the dense GQA family (qwen3, qwen2.5, starcoder2,
deepseek-7b, and the musicgen / internvl2 backbones behind their frontend
stubs) and RWKV6 (``Block`` then holds ``RWKV6TimeMix`` and
``ChannelMix``; its per-layer cache is ``{"state", "x_prev_tm",
"x_prev_cm"}``).  ``use_flash=True`` sends the prompt through the
hand-written kernels: flash attention (K7) for GQA, the WKV6 recurrence
(K8) for RWKV6.  MLA, MoE and the Hymba hybrid, ``remat``, ``loss_fn``
and ``mtp_loss`` raise ``NotImplementedError`` naming their ROADMAP
item.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import ModelConfig
from ..device import resolve_device
from .attention import (
    Attention,
    _param,
    attention_decode,
    attention_prefill,
    attention_train,
    init_attention,
    init_kv_cache,
)
from .layers import rms_norm, swiglu
from .rwkv6 import (
    ChannelMix,
    RWKV6TimeMix,
    channel_mix_decode,
    channel_mix_train,
    init_channel_mix,
    init_rwkv6,
    init_rwkv6_cache,
    rwkv6_decode,
    rwkv6_prefill,
    rwkv6_train,
)

__all__ = [
    "Block",
    "MLP",
    "TransformerLM",
    "decode_step",
    "embed_inputs",
    "forward",
    "hidden_states",
    "init_cache",
    "init_params",
    "lm_head",
    "loss_fn",
    "mtp_loss",
    "prefill",
]

_UNPORTED_ATTN = {
    "mla": "MLA attention (models/mla.py)",
    "hymba": "the Hymba attention + SSM hybrid (models/ssm.py)",
}


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP Queue 1 item 12)"
    )


def _check_supported(cfg: ModelConfig) -> None:
    if cfg.attn_type in _UNPORTED_ATTN:
        raise _not_ported(_UNPORTED_ATTN[cfg.attn_type])
    if cfg.attn_type not in ("gqa", "rwkv6"):
        raise ValueError(cfg.attn_type)
    if cfg.mlp_type == "moe":
        raise _not_ported("the MoE MLP (models/moe.py)")
    if cfg.mtp_depth:
        raise _not_ported("the multi-token-prediction head")


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


class MLP(nn.Module):
    """Dense SwiGLU weights: w1 / w3 (d, d_ff), w2 (d_ff, d); b1 / b3 /
    b2 with ``mlp_bias`` (``None`` otherwise)."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        self.w1 = _param((d, f), dtype, device)
        self.w3 = _param((d, f), dtype, device)
        self.w2 = _param((f, d), dtype, device)
        for name, n in (("b1", f), ("b3", f), ("b2", d)):
            self.register_parameter(
                name, _param((n,), dtype, device) if cfg.mlp_bias else None
            )

    def forward(self, x):
        return swiglu(x, self.w1, self.w3, self.w2, self.b1, self.b3, self.b2)


class Block(nn.Module):
    """One decoder layer: pre-norm attention (RWKV6: time-mix), pre-norm
    MLP (RWKV6: channel-mix)."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        d = cfg.d_model
        self.norm1 = _param((d,), dtype, device)
        self.norm2 = _param((d,), dtype, device)
        if cfg.attn_type == "rwkv6":
            self.attn = RWKV6TimeMix(cfg, dtype, device)
            self.mlp = ChannelMix(cfg, dtype, device)
        else:
            self.attn = Attention(cfg, dtype, device)
            self.mlp = MLP(cfg, dtype, device)


class TransformerLM(nn.Module):
    """The whole LM's parameters: embed (V, d), final_norm (d,), lm_head
    (d, V) unless tied, and ``layers``."""

    def __init__(self, cfg: ModelConfig, device="cuda"):
        super().__init__()
        _check_supported(cfg)
        dev = resolve_device(device)
        dtype = _dtype(cfg)
        d, v = cfg.d_model, cfg.vocab_size
        self.cfg = cfg
        self.embed = _param((v, d), dtype, dev)
        self.final_norm = _param((d,), dtype, dev)
        self.register_parameter(
            "lm_head", None if cfg.tie_embeddings else _param((d, v), dtype, dev)
        )
        self.layers = nn.ModuleList(
            Block(cfg, dtype, dev) for _ in range(cfg.n_layers)
        )

    @property
    def device(self) -> torch.device:
        return self.embed.device


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
@torch.no_grad()
def init_params(cfg: ModelConfig, seed: int = 0,
                device="cuda") -> TransformerLM:
    """A ``TransformerLM`` drawn from an explicit ``torch.Generator`` on the
    target device, at the reference's scales (normal * d_in**-0.5, the
    embedding * 0.02, unit norms, zero biases; RWKV6's own in
    ``rwkv6.init_rwkv6``), not its bits.  Raises
    ``RuntimeError`` for CUDA on a host without a card."""
    params = TransformerLM(cfg, device)
    gen = torch.Generator(device=params.device).manual_seed(seed)
    d = cfg.d_model
    params.embed.normal_(0.0, 0.02, generator=gen)
    params.final_norm.fill_(1.0)
    if params.lm_head is not None:
        params.lm_head.normal_(0.0, d**-0.5, generator=gen)
    for blk in params.layers:
        blk.norm1.fill_(1.0)
        blk.norm2.fill_(1.0)
        if cfg.attn_type == "rwkv6":
            init_rwkv6(blk.attn, cfg, gen)
            init_channel_mix(blk.mlp, cfg, gen)
            continue
        init_attention(blk.attn, cfg, gen)
        mlp = blk.mlp
        mlp.w1.normal_(0.0, d**-0.5, generator=gen)
        mlp.w3.normal_(0.0, d**-0.5, generator=gen)
        mlp.w2.normal_(0.0, cfg.d_ff**-0.5, generator=gen)
        for b in (mlp.b1, mlp.b3, mlp.b2):
            if b is not None:
                b.zero_()
    return params


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------
def _block_train(cfg: ModelConfig, p: Block, x, positions, use_flash: bool):
    h = rms_norm(x, p.norm1, cfg.rms_eps)
    if cfg.attn_type == "rwkv6":
        x = x + rwkv6_train(p.attn, cfg, h, positions, use_flash)
        return x + channel_mix_train(p.mlp, rms_norm(x, p.norm2, cfg.rms_eps))
    x = x + attention_train(p.attn, cfg, h, positions, use_flash)
    h = rms_norm(x, p.norm2, cfg.rms_eps)
    return x + p.mlp(h)


def _block_prefill(cfg: ModelConfig, p: Block, x, positions, max_len: int,
                   use_flash: bool):
    h = rms_norm(x, p.norm1, cfg.rms_eps)
    if cfg.attn_type == "rwkv6":
        a, cache = rwkv6_prefill(p.attn, cfg, h, use_flash)
        x = x + a
        h = rms_norm(x, p.norm2, cfg.rms_eps)
        cache["x_prev_cm"] = h[:, -1, :]
        return x + channel_mix_train(p.mlp, h), cache
    a, cache = attention_prefill(p.attn, cfg, h, positions, max_len,
                                 use_flash)
    x = x + a
    h = rms_norm(x, p.norm2, cfg.rms_eps)
    return x + p.mlp(h), cache


def _block_decode(cfg: ModelConfig, p: Block, x, cache, position):
    """One-token step. cache: this layer's cache (GQA: updated in place;
    RWKV6: a new dict of new tensors)."""
    h = rms_norm(x, p.norm1, cfg.rms_eps)
    if cfg.attn_type == "rwkv6":
        a, state, xprev = rwkv6_decode(p.attn, cfg, h, cache)
        x = x + a
        h = rms_norm(x, p.norm2, cfg.rms_eps)
        m, xprev_cm = channel_mix_decode(p.mlp, h, cache["x_prev_cm"])
        return x + m, {"state": state, "x_prev_tm": xprev,
                       "x_prev_cm": xprev_cm}
    a, cache = attention_decode(p.attn, cfg, h, cache, position)
    x = x + a
    h = rms_norm(x, p.norm2, cfg.rms_eps)
    return x + p.mlp(h), cache


# ---------------------------------------------------------------------------
# forward (train / prefill)
# ---------------------------------------------------------------------------
def _tokens(params: TransformerLM, tokens) -> torch.Tensor:
    return torch.as_tensor(tokens, device=params.device).long()


def embed_inputs(cfg: ModelConfig, params: TransformerLM, tokens,
                 frontend_embeds=None):
    x = F.embedding(_tokens(params, tokens), params.embed)
    if cfg.frontend is not None and frontend_embeds is not None:
        fe = torch.as_tensor(frontend_embeds, device=x.device).to(x.dtype)
        nf = fe.shape[1]
        fe = F.pad(fe, (0, 0, 0, x.shape[1] - nf))
        is_frontend = (torch.arange(x.shape[1], device=x.device) < nf)
        x = torch.where(is_frontend[None, :, None], fe, x)
    return x


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, device=device)[None, :].expand(b, s)


def hidden_states(
    cfg: ModelConfig,
    params: TransformerLM,
    tokens,
    frontend_embeds=None,
    use_flash: bool = False,
    remat: str | None = None,
):
    """tokens (B,S) -> (final-normed hidden (B,S,d), moe aux loss = 0)."""
    _check_supported(cfg)
    if remat is not None:
        raise _not_ported(f"remat={remat!r} (activation checkpointing)")
    x = embed_inputs(cfg, params, tokens, frontend_embeds)
    b, s = x.shape[:2]
    positions = _positions(b, s, x.device)
    for layer in params.layers:
        x = _block_train(cfg, layer, x, positions, use_flash)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return rms_norm(x, params.final_norm, cfg.rms_eps), aux


def lm_head(cfg: ModelConfig, params: TransformerLM) -> torch.Tensor:
    return params.embed.T if cfg.tie_embeddings else params.lm_head


def forward(
    cfg: ModelConfig,
    params: TransformerLM,
    tokens,
    frontend_embeds=None,
    use_flash: bool = False,
    remat: str | None = None,
):
    """tokens (B,S) -> logits (B,S,V), aux (0: no MoE in this slice)."""
    x, aux = hidden_states(cfg, params, tokens, frontend_embeds, use_flash,
                           remat)
    logits = x @ lm_head(cfg, params)
    return logits, aux


def loss_fn(cfg: ModelConfig, params, tokens, labels, *args, **kwargs):
    raise _not_ported("loss_fn (the LM training slice)")


def mtp_loss(cfg: ModelConfig, params, tokens, labels_next, labels_next2):
    raise _not_ported("mtp_loss (the LM training slice)")


# ---------------------------------------------------------------------------
# prefill: full-prompt forward that also builds the decode cache
# ---------------------------------------------------------------------------
def prefill(
    cfg: ModelConfig,
    params: TransformerLM,
    tokens,
    frontend_embeds=None,
    max_len: int | None = None,
    use_flash: bool = False,
):
    """Process the whole prompt; return (last-token logits (B,V), cache).

    The returned cache is layout-identical to init_cache(cfg, B, max_len)
    so decode_step continues from position S.
    """
    _check_supported(cfg)
    x = embed_inputs(cfg, params, tokens, frontend_embeds)
    b, s = x.shape[:2]
    max_len = max_len or s
    positions = _positions(b, s, x.device)
    layers = []
    for layer in params.layers:
        x, c = _block_prefill(cfg, layer, x, positions, max_len, use_flash)
        layers.append(c)
    cache: dict[str, Any] = {
        "layers": layers,
        "pos": torch.full((b,), s, dtype=torch.int32, device=x.device),
    }
    x = rms_norm(x[:, -1:], params.final_norm, cfg.rms_eps)
    logits = (x @ lm_head(cfg, params))[:, 0]
    return logits, cache


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------
def init_cache(cfg: ModelConfig, batch: int, max_len: int, device="cuda"):
    """Per-layer caches + current position (zeros), on ``device``."""
    _check_supported(cfg)
    dev = resolve_device(device)
    dtype = _dtype(cfg)
    if cfg.attn_type == "rwkv6":
        layers = [init_rwkv6_cache(cfg, batch, dtype, dev)
                  for _ in range(cfg.n_layers)]
    else:
        layers = [init_kv_cache(cfg, batch, max_len, dtype, dev)
                  for _ in range(cfg.n_layers)]
    return {
        "layers": layers,
        "pos": torch.zeros((batch,), dtype=torch.int32, device=dev),
    }


def decode_step(cfg: ModelConfig, params: TransformerLM, tokens, cache):
    """tokens (B,) current token ids -> (logits (B,V), new cache).  GQA
    layers' key / value buffers are written in place and shared with the
    returned cache; RWKV6 layers get new tensors; ``pos`` is a new
    tensor."""
    _check_supported(cfg)
    position = cache["pos"]
    x = F.embedding(_tokens(params, tokens)[:, None], params.embed)
    layers = []
    for layer, layer_c in zip(params.layers, cache["layers"]):
        x, c = _block_decode(cfg, layer, x, layer_c, position)
        layers.append(c)
    x = rms_norm(x, params.final_norm, cfg.rms_eps)
    logits = (x @ lm_head(cfg, params))[:, 0]
    return logits, dict(cache, layers=layers, pos=position + 1)
