"""repro_torch.models — the decoder-only LM, dense-GQA and RWKV6 subset
(the port of ``repro.models``)."""

from .model import (
    TransformerLM,
    decode_step,
    embed_inputs,
    forward,
    init_cache,
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
    "init_params",
    "loss_fn",
    "mtp_loss",
    "prefill",
]
