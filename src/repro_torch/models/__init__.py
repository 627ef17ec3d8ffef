"""repro_torch.models — the decoder-only LM (the port of
``repro.models``): dense GQA, MoE, MLA, RWKV6 and the Hymba hybrid."""

from .model import (
    TransformerLM,
    decode_step,
    embed_inputs,
    forward,
    init_cache,
    init_leaves,
    init_params,
    loss_fn,
    mtp_loss,
    prefill,
)

__all__ = [
    "TransformerLM",
    "decode_step",
    "embed_inputs",
    "forward",
    "init_cache",
    "init_leaves",
    "init_params",
    "loss_fn",
    "mtp_loss",
    "prefill",
]
