"""Prefill / decode step functions — the serving half of
``repro.launch.steps`` (the train steps belong to the LM training slice,
ROADMAP Queue 1 item 12).

PyTorch runs eagerly, so a step is the plain function the reference would
``jax.jit``.  The prefill step also takes ``max_len``, the decode cache's
length, which the reference's driver passes by calling ``prefill``
directly.
"""
from __future__ import annotations

from ..configs.base import ModelConfig
from ..models import decode_step as _decode_step
from ..models import prefill

__all__ = ["make_decode_step", "make_prefill_step"]


def make_prefill_step(cfg: ModelConfig, *, use_flash: bool = False):
    """(params, tokens[, frontend_embeds][, max_len=]) -> (last logits,
    decode cache).  ``use_flash=True`` runs the prompt through the
    hand-written kernels: K7 for GQA attention, K8 for the RWKV6
    recurrence."""

    def prefill_step(params, tokens, frontend_embeds=None,
                     max_len: int | None = None):
        return prefill(cfg, params, tokens, frontend_embeds, max_len=max_len,
                       use_flash=use_flash)

    return prefill_step


def make_decode_step(cfg: ModelConfig):
    """(params, tokens (B,), cache) -> (logits (B,V), new cache)."""

    def serve_step(params, tokens, cache):
        return _decode_step(cfg, params, tokens, cache)

    return serve_step
