"""Train / prefill / decode step functions — the port of
``repro.launch.steps``.

PyTorch runs eagerly, so a step is the plain function the reference would
``jax.jit``.  The prefill step also takes ``max_len``, the decode cache's
length, which the reference's driver passes by calling ``prefill``
directly.

The train step differentiates ``loss_fn`` with ``torch.autograd.grad``
(an unused parameter, such as DeepSeek-V3's MTP head under ``loss_fn``,
gets a zero gradient, as ``jax.value_and_grad`` gives it), then
optionally compresses the gradients and takes one AdamW step, updating
the parameters and the float32 moments in place where the reference
donates them.

With sharded parameters (``launch.shardings.shard_params``) under
``logical_sharding`` the step is this rank's part of the reference's
sharded ``jit`` of the same step: ``loss_and_grads`` differentiates the
tensor-parallel loss (the collectives' transposes run in the backward,
where a leaf every model rank holds enters one rank's heads, experts or
FF columns too) and adds the sums the batch's and the sequence's cut
leave (``models.tensor_parallel.sum_partial_grads``), so it returns
this rank's gradient shards (ZeRO-3: reduce-scattered over ``data``);
AdamW clips by the global norm of the global arrays and updates the
shards and their moments (``launch.shardings.shard_train_state``).
With gradient compression on, ``compress_gradients`` quantizes the
rank's gradient shards with each leaf's global min and max, and the
error feedback (``opt_state["ef"]``) is kept in the gradients' cut, as
the reference's sharded ``jit`` of the step computes them (one ``pmax``
a step).  Parameters require grad only inside the step.  The step
runs under deterministic algorithms (``deterministic_algorithms``): on a
card, the one sum of the train path that PyTorch otherwise adds with
atomics in no fixed order — the gradient of the MoE dispatch's gather
(``index_select``; each token is gathered ``top_k`` times, so its
``index_add_`` backward meets repeated rows) — then adds in a fixed
order, so a run resumed from a checkpoint ends bit-equal to an
uninterrupted one.  The embedding's backward already orders repeated
tokens, and ``take_along_dim``'s scatters one value into each place.
"""
from __future__ import annotations

import contextlib
import warnings

import torch

from ..configs.base import ModelConfig
from ..models import decode_step as _decode_step
from ..models import loss_fn, mtp_loss, prefill
from ..optim.adamw import AdamWConfig, adamw_update
from ..optim.compression import GradCompressionConfig, compress_gradients

__all__ = [
    "deterministic_algorithms",
    "loss_and_grads",
    "make_decode_step",
    "make_prefill_step",
    "make_train_step",
    "make_wire_train_step",
    "mtp_loss_and_grads",
    "whole_logits",
]


@contextlib.contextmanager
def deterministic_algorithms():
    """PyTorch's deterministic algorithms inside the block, the previous
    setting after it.  Uninitialised memory is not filled (nothing here
    reads it), and cuBLAS's warning about ``CUBLAS_WORKSPACE_CONFIG`` is
    silenced: that concerns workspaces shared by several streams, and a
    train step runs on one.  Any other operation without a deterministic
    implementation warns."""
    enabled = torch.are_deterministic_algorithms_enabled()
    warn_only = torch.is_deterministic_algorithms_warn_only_enabled()
    fill = torch.utils.deterministic.fill_uninitialized_memory
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.utils.deterministic.fill_uninitialized_memory = False
    try:
        with warnings.catch_warnings():
            warnings.filterwarnings(
                "ignore", message=".*CUBLAS_WORKSPACE_CONFIG.*")
            yield
    finally:
        torch.use_deterministic_algorithms(enabled, warn_only=warn_only)
        torch.utils.deterministic.fill_uninitialized_memory = fill


def _value_and_grads(cfg: ModelConfig, params, batch, loss_of):
    """(``loss_of()``, {parameter name: gradient}), as ``jax.value_and_grad``
    gives them (an unused parameter's gradient is zero), the parameters
    requiring grad only inside; on sharded ``params`` each gradient this
    rank's shard of the global one (``sum_partial_grads``)."""
    names, plist = zip(*params.named_parameters())
    params.requires_grad_(True)
    try:
        loss = loss_of()
        grads = torch.autograd.grad(loss, plist, allow_unused=True,
                                    materialize_grads=True)
    finally:
        params.requires_grad_(False)
    grads = dict(zip(names, grads))
    if params.mesh is not None:
        from ..models.tensor_parallel import sum_partial_grads, tp_layout

        b, s = batch["tokens"].shape
        grads = sum_partial_grads(tp_layout(cfg, params.mesh, b, s), grads,
                                  params.pspecs)
    return loss, grads


def loss_and_grads(cfg: ModelConfig, params, batch, *,
                   remat: str | None = "full", use_flash: bool = False,
                   aux_weight: float = 0.01):
    """(loss, {parameter name: gradient}) of ``loss_fn`` on ``batch``, as
    ``jax.value_and_grad`` gives them (an unused parameter's gradient is
    zero).  The parameters require grad only inside.  Sharded ``params``
    under ``logical_sharding``: ``batch`` is the global batch on every
    rank, the loss the global one and the gradients this rank's shards
    of the global gradients."""
    return _value_and_grads(cfg, params, batch, lambda: loss_fn(
        cfg, params, batch["tokens"], batch["labels"],
        batch.get("frontend_embeds"), aux_weight=aux_weight,
        use_flash=use_flash, remat=remat))


def mtp_loss_and_grads(cfg: ModelConfig, params, batch):
    """``loss_and_grads`` of ``mtp_loss`` (DeepSeek-V3's main plus depth-1
    MTP loss): ``batch`` holds ``"tokens"``, ``"labels"`` (the next
    tokens) and ``"labels_next2"`` (the tokens after them)."""
    return _value_and_grads(cfg, params, batch, lambda: mtp_loss(
        cfg, params, batch["tokens"], batch["labels"],
        batch["labels_next2"]))


def make_train_step(
    cfg: ModelConfig,
    opt_cfg: AdamWConfig,
    *,
    remat: str | None = "full",
    grad_comp: GradCompressionConfig | None = None,
    use_flash: bool = False,
    aux_weight: float = 0.01,
):
    """(params, opt_state, batch) -> (params, opt_state, metrics).

    ``params`` is a ``TransformerLM``; ``batch`` holds ``"tokens"`` and
    ``"labels"`` (B, S) (numpy or tensors) and optionally
    ``"frontend_embeds"``.  When grad compression is on, opt_state
    additionally carries the ``"ef"`` error-feedback dict (init with
    ``optim.compression.init_error_feedback``).  Metrics are 0-d tensors:
    ``"loss"``, ``"grad_norm"``, ``"lr"``.  Sharded ``params`` (and an
    ``opt_state`` of shards, ``launch.shardings.shard_train_state``)
    under ``logical_sharding``: the rank's updated shards, the metrics
    equal on every rank; with compression, ``"ef"`` holds float32 shards
    in the gradients' cut (``shard_train_state(..., grad_comp=...)``)."""

    def train_step(params, opt_state, batch):
        with deterministic_algorithms():
            loss, grads = loss_and_grads(cfg, params, batch, remat=remat,
                                         use_flash=use_flash,
                                         aux_weight=aux_weight)
            if grad_comp is not None and grad_comp.enabled:
                grads, new_ef = compress_gradients(
                    grad_comp, grads, opt_state["ef"]
                )
            params, new_opt, metrics = adamw_update(
                opt_cfg, params, grads, opt_state
            )
        if grad_comp is not None and grad_comp.enabled:
            new_opt["ef"] = new_ef
        metrics["loss"] = loss.detach()
        return params, new_opt, metrics

    return train_step


def make_wire_train_step(
    cfg: ModelConfig,
    opt_cfg: AdamWConfig,
    mesh,
    pspecs,
    *,
    bits: int = 4,
    remat: str | None = "full",
    aux_weight: float = 0.01,
    rules: dict | None = None,
    dither=None,
):
    """Train step with the data-parallel gradient sync done by hand, so
    §7's dithered quantizer runs at the wire level: the cross-data
    traffic is int8 codes (``bits`` 4 on up to 18 ranks) instead of
    bf16 / float32 gradients.

    SPMD: every rank of ``mesh`` (a ``DeviceMesh`` with ``data`` and
    ``model`` axes) calls ``train_step(params_shard, opt_state, batch)``
    with LOCAL tensors: ``params_shard`` {name: this rank's shard}, a leaf
    cut along the dimension its spec in ``pspecs`` ({name:
    PartitionSpec}, ``launch.shardings.param_pspecs``) shards over
    ``data`` (whole where none does); ``opt_state`` {"m", "v": shards
    alike, "step"}; ``batch`` {"tokens", "labels"}: this rank's rows.
    Returns the updated shards (in place), the state and the metrics,
    equal on every rank.

    The reference's order: the shards all-gathered for compute into a
    whole model (built on the first call), the loss's ``pmean``,
    ``wire_quantized_psum`` with a dither seeded by ``step * d_size +
    rank`` (the reference folds that into ``PRNGKey(0)``; ``dither``, a
    callable (step, rank) -> {name: draws}, gives draws instead), a
    global clip on the rank-identical full gradients, a slice back to
    the shards and AdamW with ``clip_norm=inf``.  Inside, ``batch`` and
    ``d_model_fsdp`` map to no mesh axis, as in the reference's manual
    region, which the step runs in (``manual_region``); the step runs
    under deterministic algorithms.
    """
    import dataclasses

    from ..models.model import TransformerLM
    from ..models.sharding import (
        all_gather,
        axis_index,
        logical_sharding,
        manual_region,
        mesh_axis_names,
        mesh_shape,
        pmean,
    )
    from ..optim.adamw import clip_by_global_norm
    from ..optim.compression import wire_quantized_psum
    from .shardings import _data_dim

    assert "pod" not in mesh_axis_names(mesh), "wire grad sync: single-pod demo"
    d_size = mesh_shape(mesh)["data"]
    dims = {n: _data_dim(spec) for n, spec in pspecs.items()}
    inner_rules = dict(rules or {})
    inner_rules.update({"batch": None, "d_model_fsdp": None})
    no_clip_cfg = dataclasses.replace(opt_cfg, clip_norm=float("inf"))
    whole: dict[str, TransformerLM] = {}

    def train_step(params_shard, opt_state, batch):
        rank = axis_index("data", mesh)
        shards = dict(params_shard)
        with deterministic_algorithms(), logical_sharding(
                mesh, inner_rules), manual_region():
            if "model" not in whole:
                whole["model"] = TransformerLM(
                    cfg, next(iter(shards.values())).device)
            model = whole["model"]
            with torch.no_grad():
                for n, p in model.named_parameters():
                    dim = dims[n]
                    p.copy_(shards[n] if dim is None else
                            all_gather(shards[n], "data", dim, mesh=mesh))
            loss, grads = loss_and_grads(cfg, model, batch, remat=remat,
                                         aux_weight=aux_weight)
            loss = pmean(loss.detach(), "data", mesh)
            step = int(opt_state["step"])
            draws = dither(step, rank) if dither is not None else None
            grads = wire_quantized_psum(
                grads, "data", bits=bits, n_ranks=d_size, dither=draws,
                key=None if draws is not None else step * d_size + rank,
                mesh=mesh)
            # global clip on the (rank-identical) full gradients, then
            # slice to FSDP shards for the update
            grads, gnorm = clip_by_global_norm(grads, opt_cfg.clip_norm)
            for n, dim in dims.items():
                if dim is not None:
                    shard = grads[n].shape[dim] // d_size
                    grads[n] = grads[n].narrow(dim, rank * shard, shard)
            params_shard, new_opt, metrics = adamw_update(
                no_clip_cfg, params_shard, grads, opt_state
            )
        metrics["loss"] = loss
        metrics["grad_norm"] = gnorm
        return params_shard, new_opt, metrics

    return train_step


def make_prefill_step(cfg: ModelConfig, *, use_flash: bool = False):
    """(params, tokens[, frontend_embeds][, max_len=]) -> (last logits,
    decode cache).  ``use_flash=True`` runs the prompt through the
    hand-written kernels: K7 for GQA and Hymba attention, K8 for the
    RWKV6 recurrence (MLA never takes K7, as in the reference).  With
    sharded ``params`` under ``logical_sharding`` the step is this rank's
    cut: the global batch's tokens in, this rank's logits (batch rows x
    vocab slice) and cache shards out; K7 runs at the rank's heads."""

    def prefill_step(params, tokens, frontend_embeds=None,
                     max_len: int | None = None):
        return prefill(cfg, params, tokens, frontend_embeds, max_len=max_len,
                       use_flash=use_flash)

    return prefill_step


def whole_logits(cfg: ModelConfig, logits, batch: int, mesh=None):
    """The whole (B, V) logits on every rank from a tensor-parallel step's
    local (B / data, V / model) block: gathered over ``model`` along the
    vocab and over ``data`` along the batch, where each was cut (the
    mesh installed by ``logical_sharding`` unless given)."""
    from ..models.sharding import all_gather, current_mesh, mesh_shape

    mesh = mesh if mesh is not None else current_mesh()
    shape = mesh_shape(mesh)
    if logits.shape[1] != cfg.vocab_size:
        logits = all_gather(logits, "model", dim=1, mesh=mesh)
    if logits.shape[0] != batch:
        logits = all_gather(logits, "data", dim=0, mesh=mesh)
    assert tuple(logits.shape) == (batch, cfg.vocab_size), shape
    return logits


def make_decode_step(cfg: ModelConfig):
    """(params, tokens (B,), cache) -> (logits (B,V), new cache).  With
    sharded ``params`` (``launch.shardings.shard_params``) under
    ``logical_sharding``, ``tokens`` are the global batch's, and the
    logits and cache this rank's (``whole_logits`` gathers the
    logits)."""

    def serve_step(params, tokens, cache):
        return _decode_step(cfg, params, tokens, cache)

    return serve_step
