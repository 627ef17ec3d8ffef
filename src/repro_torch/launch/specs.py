"""Stand-ins for every model input — the port of ``repro.launch.specs``:
``meta`` tensors (shape and dtype, no storage) where the reference uses
``jax.ShapeDtypeStruct``.  The dry-run traces against these; nothing is
ever allocated.

``input_specs(cfg, shape, mesh)`` returns (args, pspec tree) for the step
that the cell runs:
  * train_*   -> train_step(params, opt_state, batch)
  * prefill_* -> prefill_step(params, tokens[, frontend_embeds])
  * decode_*  -> serve_step(params, tokens, cache)

``params`` is a ``TransformerLM`` on ``meta``; its specs, and the
optimizer's and the cache's, are keyed by the port's names
(``launch.shardings``).
"""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig, ShapeConfig
from ..models import init_cache
from . import shardings as sh

__all__ = ["batch_pspecs", "batch_struct", "input_specs"]


def _token_struct(b, s=None, dtype=torch.int32):
    shape = (b,) if s is None else (b, s)
    return torch.empty(shape, dtype=dtype, device="meta")


def _frontend_struct(cfg: ModelConfig, b: int):
    return torch.empty((b, cfg.n_frontend_tokens, cfg.d_model),
                       dtype=getattr(torch, cfg.dtype), device="meta")


def batch_struct(cfg: ModelConfig, shape: ShapeConfig):
    """Training batch (the host pipeline produces exactly this)."""
    b, s = shape.global_batch, shape.seq_len
    batch = {
        "tokens": _token_struct(b, s),
        "labels": _token_struct(b, s),
    }
    if cfg.frontend is not None and cfg.n_frontend_tokens:
        batch["frontend_embeds"] = _frontend_struct(cfg, b)
    return batch


def batch_pspecs(cfg: ModelConfig, mesh, shape: ShapeConfig):
    b = shape.global_batch
    specs = {
        "tokens": sh.batch_spec(mesh, b, 2),
        "labels": sh.batch_spec(mesh, b, 2),
    }
    if cfg.frontend is not None and cfg.n_frontend_tokens:
        specs["frontend_embeds"] = sh.batch_spec(mesh, b, 3)
    return specs


def input_specs(cfg: ModelConfig, shape: ShapeConfig, mesh):
    """(abstract args tuple, matching PartitionSpec tuple) for the cell."""
    params, opt = sh.abstract_train_state(cfg)
    pspecs = sh.param_pspecs(cfg, mesh)
    b, s = shape.global_batch, shape.seq_len

    if shape.kind == "train":
        args = (params, opt, batch_struct(cfg, shape))
        specs = (pspecs, sh.opt_pspecs(cfg, mesh, pspecs),
                 batch_pspecs(cfg, mesh, shape))
        return args, specs

    if shape.kind == "prefill":
        args = [params, _token_struct(b, s)]
        specs = [pspecs, sh.batch_spec(mesh, b, 2)]
        if cfg.frontend is not None and cfg.n_frontend_tokens:
            args.append(_frontend_struct(cfg, b))
            specs.append(sh.batch_spec(mesh, b, 3))
        return tuple(args), tuple(specs)

    # decode: one new token against a seq_len cache
    cache = init_cache(cfg, b, s, device="meta")
    cache_specs = sh.cache_pspecs(cfg, mesh, b, s)
    args = (params, _token_struct(b), cache)
    specs = (pspecs, sh.batch_spec(mesh, b, 1), cache_specs)
    return args, specs
