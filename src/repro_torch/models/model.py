"""TransformerLM — the port of ``repro.models.model``, serving every family
of the reference: dense GQA, GQA + MoE (granite-moe), MLA + MoE with a
multi-token-prediction head (deepseek-v3), RWKV6, the Hymba attention +
SSM hybrid, and the modality-stub backbones.

Parameters live in ``nn.Module``s: ``TransformerLM`` holds the embedding,
the final norm, the untied head, ``layers_dense`` (an MoE config's
leading dense blocks; empty otherwise), ``layers`` and, with
``mtp_depth``, the ``mtp`` head (``proj``, a dense ``block``, ``norm``),
which serving carries but does not run, as in the reference.  A ``Block``
holds ``norm1``, the mixer (``Attention``, ``MLA`` or ``RWKV6TimeMix``;
Hymba: ``Attention`` and ``SSM`` side by side with ``norm_attn_out``,
``norm_ssm_out`` and ``branch_beta``), ``norm2`` and the MLP (``MLP``,
``MoE`` or ``ChannelMix``).  The reference stacks its layers on a leading
L axis for ``lax.scan``; the port loops over the lists.  The reference's
function names stay as thin functions over those modules
(``forward(cfg, params, tokens, ...)``, ``prefill``, ``decode_step``,
...), so a test calls both packages the same way.

The decode cache is ``{"layers": [one cache per layer], "pos": (B,)
int32}``, plus ``"layers_dense"`` for the leading dense layers of an MoE
config.  A layer's cache is ``{"k", "v"}`` (GQA), ``{"c_kv", "k_rope"}``
(MLA), ``{"state", "x_prev_tm", "x_prev_cm"}`` (RWKV6) or ``{"kv",
"ssm"}`` (Hymba).  ``use_flash=True`` sends the prompt through the
hand-written kernels: flash attention (K7) for GQA and Hymba's attention,
the WKV6 recurrence (K8) for RWKV6; MLA never takes K7, as in the
reference.  The kernels have no backward pass, so training keeps
``use_flash=False``, as the reference's train step does; ``prefill`` and
``decode_step`` run under ``torch.no_grad()``, so serving keeps no
autograd graph whatever the parameters' ``requires_grad``.

Tensor parallelism.  ``launch.shardings.shard_params`` gives a rank a
``TransformerLM`` of its shards (``mesh`` set); ``prefill``,
``decode_step``, ``hidden_states``, ``forward`` and ``loss_fn`` then run
the rank's cut of the call under the installed ``logical_sharding``
(``models.tensor_parallel``): they take the global batch's token ids on
every rank and compute this rank's batch rows, heads, FF columns, vocab
slice and sequence slice.  Serving returns this rank's logits (batch
rows x vocab slice) and its cache of local shards (``TPCache``);
``hidden_states`` this rank's residual slice, ``forward`` its logits
(batch rows x whole sequence x vocab slice), ``loss_fn`` the global loss
on every rank through the vocab-parallel cross entropy, differentiable
into the rank's shards (``launch.steps.loss_and_grads`` sums the partial
gradients).  The train block and the prefill block are one body
(``_block_tp``); prefill adds the cache.  ``remat`` checkpoints each
tensor-parallel block with its ZeRO-3 gathers inside, so the recompute
gathers the weights again; the block carries this thread's layout state
into the recompute, which the card's autograd engine runs on a thread of
its own.  Every family is cut, for serving and training alike: RWKV6 and
Hymba with their residual whole on every model rank (the rank's heads,
FF columns and d_inner channels, Hymba's two branch partials each summed
before its norm), MLA (its heads, latents gathered along the sequence,
the latent cache cut along time) and DeepSeek-V3's shared expert (its FF
columns, summed with the routed experts' partial).  ``mtp_loss`` on
shards runs the MTP head on the residual slice (``_mtp_loss_tp``).  A
cut ``tensor_parallel.check_cut`` does not take raises
``NotImplementedError`` with the reason.
``init_leaves`` draws ``init_params``'s numbers one block at a time, so a
rank can cut a seeded model without ever holding it whole.

Training: ``loss_fn`` (dense cross entropy, or ``chunked_ce_loss`` from
2,048 tokens in chunks of 512, plus ``aux_weight`` times the MoE aux
loss) and ``mtp_loss`` (DeepSeek-V3's depth-1 multi-token prediction).
``remat`` checkpoints each block (``torch.utils.checkpoint``,
non-reentrant): ``"full"`` keeps only the block's input, ``"dots"`` also
keeps its matmul outputs and recomputes the rest, as the reference's
``jax.checkpoint`` policies do.
"""
from __future__ import annotations

import functools
import math
import re
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from ..configs.base import ModelConfig
from ..device import resolve_device
from .attention import (
    Attention,
    _param,
    attention_decode,
    attention_decode_tp,
    attention_prefill,
    attention_prefill_tp,
    attention_train,
    attention_train_tp,
    init_attention,
    init_kv_cache,
)
from .layers import (
    chunked_ce_loss,
    cross_entropy_loss,
    rms_norm,
    swiglu,
    swiglu_partial,
)
from .mla import (
    MLA,
    _mla_attend_tp,
    init_mla,
    init_mla_cache,
    mla_decode,
    mla_decode_tp,
    mla_prefill,
    mla_prefill_tp,
    mla_train,
)
from .moe import MoE, _moe_ep_partial, init_moe, moe_apply
from .rwkv6 import (
    ChannelMix,
    RWKV6TimeMix,
    _own_d,
    _time_mix_tp,
    channel_mix_decode,
    channel_mix_decode_tp,
    channel_mix_tp,
    channel_mix_train,
    init_channel_mix,
    init_rwkv6,
    init_rwkv6_cache,
    rwkv6_decode,
    rwkv6_decode_tp,
    rwkv6_prefill,
    rwkv6_prefill_tp,
    rwkv6_train,
)
from .sharding import (
    ax,
    current_mesh,
    layout_installed,
    layout_state,
    logical_sizes,
    psum,
)
from .ssm import (
    SSM,
    init_ssm,
    init_ssm_cache,
    ssm_decode,
    ssm_decode_tp,
    ssm_prefill,
    ssm_prefill_tp,
    ssm_train,
)
from .tensor_parallel import (
    TPCache,
    column_input,
    embed_tokens,
    fsdp_gathered,
    gathered,
    last_position,
    own_seq,
    partitioned_leaf,
    row_reduce,
    tp_layout,
)

__all__ = [
    "Block",
    "MLP",
    "MTP",
    "TransformerLM",
    "decode_step",
    "embed_inputs",
    "forward",
    "hidden_states",
    "init_cache",
    "init_leaves",
    "init_params",
    "lm_head",
    "loss_fn",
    "mtp_loss",
    "prefill",
    "reference_path",
]

_ATTN_TYPES = ("gqa", "mla", "rwkv6", "hymba")


def _check_supported(cfg: ModelConfig) -> None:
    if cfg.attn_type not in _ATTN_TYPES:
        raise ValueError(cfg.attn_type)


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _n_layers(cfg: ModelConfig) -> tuple[int, int]:
    """(leading dense layers, main layers): an MoE config's first
    ``n_dense_layers`` blocks have a dense MLP and their own list."""
    n_dense = cfg.n_dense_layers if cfg.mlp_type == "moe" else 0
    return n_dense, cfg.n_layers - n_dense


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
    """One decoder layer: pre-norm mixer (attention, MLA, RWKV6 time-mix,
    or Hymba's attention + SSM), pre-norm MLP (dense, MoE when ``moe``,
    RWKV6 channel-mix)."""

    def __init__(self, cfg: ModelConfig, dtype, device, moe: bool = False):
        super().__init__()
        d = cfg.d_model
        self.norm1 = _param((d,), dtype, device)
        self.norm2 = _param((d,), dtype, device)
        if cfg.attn_type == "rwkv6":
            self.attn = RWKV6TimeMix(cfg, dtype, device)
        elif cfg.attn_type == "mla":
            self.attn = MLA(cfg, dtype, device)
        else:
            self.attn = Attention(cfg, dtype, device)
        if cfg.attn_type == "hymba":
            self.ssm = SSM(cfg, dtype, device)
            self.norm_attn_out = _param((d,), dtype, device)
            self.norm_ssm_out = _param((d,), dtype, device)
            self.branch_beta = _param((2,), dtype, device)
        if cfg.attn_type == "rwkv6":
            self.mlp = ChannelMix(cfg, dtype, device)
        elif moe:
            self.mlp = MoE(cfg, dtype, device)
        else:
            self.mlp = MLP(cfg, dtype, device)


class MTP(nn.Module):
    """The multi-token-prediction head: proj (2 d, d), a dense ``block``,
    norm (d,)."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        d = cfg.d_model
        self.proj = _param((2 * d, d), dtype, device)
        self.block = Block(cfg, dtype, device)
        self.norm = _param((d,), dtype, device)


def _abstract_or(device) -> torch.device:
    """``device`` resolved, or the ``meta`` device: shapes and types with
    no storage, for the partition specs and the dry-run
    (``launch.shardings.abstract_train_state``)."""
    if torch.device(device).type == "meta":
        return torch.device("meta")
    return resolve_device(device)


class TransformerLM(nn.Module):
    """The whole LM's parameters: embed (V, d), final_norm (d,), lm_head
    (d, V) unless tied, ``layers_dense``, ``layers`` and ``mtp``
    (``None`` without ``mtp_depth``).  On ``device="meta"`` nothing is
    allocated."""

    def __init__(self, cfg: ModelConfig, device="cuda"):
        super().__init__()
        _check_supported(cfg)
        dev = _abstract_or(device)
        dtype = _dtype(cfg)
        d, v = cfg.d_model, cfg.vocab_size
        moe = cfg.mlp_type == "moe"
        n_dense, n_main = _n_layers(cfg)
        self.cfg = cfg
        self.embed = _param((v, d), dtype, dev)
        self.final_norm = _param((d,), dtype, dev)
        self.register_parameter(
            "lm_head", None if cfg.tie_embeddings else _param((d, v), dtype, dev)
        )
        self.layers_dense = nn.ModuleList(
            Block(cfg, dtype, dev) for _ in range(n_dense)
        )
        self.layers = nn.ModuleList(
            Block(cfg, dtype, dev, moe) for _ in range(n_main)
        )
        self.mtp = MTP(cfg, dtype, dev) if cfg.mtp_depth else None
        # set by launch.shardings.shard_params: the mesh this rank's shards
        # were cut for, each parameter's spec and its dim cut over ``data``
        self.mesh = None
        self.pspecs: dict[str, tuple] = {}
        self.fsdp_dims: dict[str, int | None] = {}

    @property
    def device(self) -> torch.device:
        return self.embed.device


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
@torch.no_grad()
def _init_mlp_dense(mlp: MLP, cfg: ModelConfig, gen: torch.Generator):
    d = cfg.d_model
    mlp.w1.normal_(0.0, d**-0.5, generator=gen)
    mlp.w3.normal_(0.0, d**-0.5, generator=gen)
    mlp.w2.normal_(0.0, cfg.d_ff**-0.5, generator=gen)
    for b in (mlp.b1, mlp.b3, mlp.b2):
        if b is not None:
            b.zero_()


@torch.no_grad()
def _init_block(blk: Block, cfg: ModelConfig, gen: torch.Generator):
    blk.norm1.fill_(1.0)
    blk.norm2.fill_(1.0)
    if cfg.attn_type == "rwkv6":
        init_rwkv6(blk.attn, cfg, gen)
        init_channel_mix(blk.mlp, cfg, gen)
        return
    if cfg.attn_type == "mla":
        init_mla(blk.attn, cfg, gen)
    else:
        init_attention(blk.attn, cfg, gen)
    if cfg.attn_type == "hymba":
        init_ssm(blk.ssm, cfg, gen)
        blk.norm_attn_out.fill_(1.0)
        blk.norm_ssm_out.fill_(1.0)
        blk.branch_beta.fill_(1.0)
    if isinstance(blk.mlp, MoE):
        init_moe(blk.mlp, cfg, gen)
    else:
        _init_mlp_dense(blk.mlp, cfg, gen)


@torch.no_grad()
def init_leaves(cfg: ModelConfig, seed: int = 0, device="cuda"):
    """Every parameter of ``init_params(cfg, seed, device)`` as (name,
    whole tensor), one at a time, drawn in ``init_params``'s order from
    the same ``torch.Generator``: the embedding, the final norm, the head,
    then one block at a time (a block's leaves are drawn together, and
    each is dropped once it has been handed over), then the MTP head.  A
    consumer that keeps only a slice of each leaf never holds the whole
    model, nor the whole of a block past the leaf it is cutting (an MoE
    block's expert stacks are most of a cut DeepSeek-V3)."""
    dev = resolve_device(device)
    dtype = _dtype(cfg)
    d, v = cfg.d_model, cfg.vocab_size
    gen = torch.Generator(device=dev).manual_seed(seed)
    yield "embed", torch.empty((v, d), dtype=dtype, device=dev).normal_(
        0.0, 0.02, generator=gen)
    yield "final_norm", torch.ones((d,), dtype=dtype, device=dev)
    if not cfg.tie_embeddings:
        yield "lm_head", torch.empty((d, v), dtype=dtype, device=dev).normal_(
            0.0, d**-0.5, generator=gen)
    n_dense, n_main = _n_layers(cfg)
    for key, n, moe in (("layers_dense", n_dense, False),
                        ("layers", n_main, cfg.mlp_type == "moe")):
        for i in range(n):
            blk = Block(cfg, dtype, dev, moe)
            _init_block(blk, cfg, gen)
            for name, p in blk.named_parameters():
                yield f"{key}.{i}.{name}", p.data
                p.data = p.data.new_empty(0)  # the consumer has its slice
            del blk
    if cfg.mtp_depth:
        mtp = MTP(cfg, dtype, dev)
        mtp.proj.normal_(0.0, (2 * d) ** -0.5, generator=gen)
        _init_block(mtp.block, cfg, gen)
        mtp.norm.fill_(1.0)
        for name, p in mtp.named_parameters():
            yield f"mtp.{name}", p.data


@torch.no_grad()
def init_params(cfg: ModelConfig, seed: int = 0,
                device="cuda") -> TransformerLM:
    """A ``TransformerLM`` drawn from an explicit ``torch.Generator`` on the
    target device, at the reference's scales (normal * d_in**-0.5, the
    embedding * 0.02, unit norms and ``branch_beta``, zero biases; RWKV6's,
    the SSM's, MLA's and MoE's own in their modules), not its bits,
    drawn in place.  Raises ``RuntimeError`` for CUDA on a host without a
    card."""
    params = TransformerLM(cfg, device)
    gen = torch.Generator(device=params.device).manual_seed(seed)
    d = cfg.d_model
    params.embed.normal_(0.0, 0.02, generator=gen)
    params.final_norm.fill_(1.0)
    if params.lm_head is not None:
        params.lm_head.normal_(0.0, d**-0.5, generator=gen)
    for blk in (*params.layers_dense, *params.layers):
        _init_block(blk, cfg, gen)
    if params.mtp is not None:
        params.mtp.proj.normal_(0.0, (2 * d) ** -0.5, generator=gen)
        _init_block(params.mtp.block, cfg, gen)
        params.mtp.norm.fill_(1.0)
    return params


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------
def _hymba_mix(cfg: ModelConfig, p: Block, att, ssm_o):
    """Hymba's two branches, each normed, mixed by branch_beta."""
    att = rms_norm(att, p.norm_attn_out, cfg.rms_eps)
    ssm_o = rms_norm(ssm_o, p.norm_ssm_out, cfg.rms_eps)
    beta = p.branch_beta
    return 0.5 * (beta[0] * att + beta[1] * ssm_o)


def _mlp(cfg: ModelConfig, p: Block, h):
    """(the MLP's output, its aux loss or None)."""
    if isinstance(p.mlp, MoE):
        return moe_apply(p.mlp, cfg, h)
    return p.mlp(h), None


def _block_train(cfg: ModelConfig, p: Block, x, positions, use_flash: bool):
    """Returns (x, MoE aux loss or None)."""
    h = rms_norm(x, p.norm1, cfg.rms_eps)
    if cfg.attn_type == "rwkv6":
        x = x + rwkv6_train(p.attn, cfg, h, positions, use_flash)
        return x + channel_mix_train(p.mlp,
                                     rms_norm(x, p.norm2, cfg.rms_eps)), None
    if cfg.attn_type == "mla":
        a = mla_train(p.attn, cfg, h, positions)
    elif cfg.attn_type == "hymba":
        a = _hymba_mix(cfg, p,
                       attention_train(p.attn, cfg, h, positions, use_flash),
                       ssm_train(p.ssm, cfg, h))
    else:
        a = attention_train(p.attn, cfg, h, positions, use_flash)
    x = x + a
    m, aux = _mlp(cfg, p, rms_norm(x, p.norm2, cfg.rms_eps))
    return x + m, aux


def _block_prefill(cfg: ModelConfig, p: Block, x, positions, max_len: int,
                   use_flash: bool):
    h = rms_norm(x, p.norm1, cfg.rms_eps)
    if cfg.attn_type == "rwkv6":
        a, cache = rwkv6_prefill(p.attn, cfg, h, use_flash)
        x = x + a
        h = rms_norm(x, p.norm2, cfg.rms_eps)
        cache["x_prev_cm"] = h[:, -1, :]
        return x + channel_mix_train(p.mlp, h), cache
    if cfg.attn_type == "mla":
        a, cache = mla_prefill(p.attn, cfg, h, positions, max_len)
    elif cfg.attn_type == "hymba":
        att, kv = attention_prefill(p.attn, cfg, h, positions, max_len,
                                    use_flash)
        ssm_o, ssm_c = ssm_prefill(p.ssm, cfg, h)
        a = _hymba_mix(cfg, p, att, ssm_o)
        cache = {"kv": kv, "ssm": ssm_c}
    else:
        a, cache = attention_prefill(p.attn, cfg, h, positions, max_len,
                                     use_flash)
    x = x + a
    m, _ = _mlp(cfg, p, rms_norm(x, p.norm2, cfg.rms_eps))
    return x + m, cache


def _block_decode(cfg: ModelConfig, p: Block, x, cache, position):
    """One-token step. cache: this layer's cache (GQA and MLA buffers, and
    Hymba's key / value buffers, are updated in place; RWKV6 and the SSM
    get new tensors)."""
    h = rms_norm(x, p.norm1, cfg.rms_eps)
    if cfg.attn_type == "rwkv6":
        a, state, xprev = rwkv6_decode(p.attn, cfg, h, cache)
        x = x + a
        h = rms_norm(x, p.norm2, cfg.rms_eps)
        m, xprev_cm = channel_mix_decode(p.mlp, h, cache["x_prev_cm"])
        return x + m, {"state": state, "x_prev_tm": xprev,
                       "x_prev_cm": xprev_cm}
    if cfg.attn_type == "mla":
        a, cache = mla_decode(p.attn, cfg, h, cache, position)
    elif cfg.attn_type == "hymba":
        att, kv = attention_decode(p.attn, cfg, h, cache["kv"], position)
        ssm_o, ssm_c = ssm_decode(p.ssm, cfg, h, cache["ssm"])
        a = _hymba_mix(cfg, p, att, ssm_o)
        cache = {"kv": kv, "ssm": ssm_c}
    else:
        a, cache = attention_decode(p.attn, cfg, h, cache, position)
    x = x + a
    m, _ = _mlp(cfg, p, rms_norm(x, p.norm2, cfg.rms_eps))
    return x + m, cache


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


_STACKED = re.compile(r"^(layers_dense|layers)\.(\d+)\.(.+)$")


def reference_path(name: str) -> tuple[str, int | None]:
    """Where a parameter of the port (``named_parameters`` name) lives in
    the reference's pytree: its ``/``-joined path and, for a block of
    ``layers`` / ``layers_dense`` (stacked on a leading L axis there), its
    index in the stack (``None`` otherwise).  ``"layers.3.attn.wq"`` ->
    ``("layers/attn/wq", 3)``; ``"mtp.block.norm1"`` ->
    ``("mtp/block/norm1", None)``."""
    m = _STACKED.match(name)
    if m:
        return f"{m[1]}/{m[3].replace('.', '/')}", int(m[2])
    return name.replace(".", "/"), None


def _all_layers(params: TransformerLM):
    """The blocks in order: the leading dense ones, then the main ones."""
    return (*params.layers_dense, *params.layers)


# the matmuls the "dots" policy keeps (``x @ w`` and einsum reach these)
_DOT_OPS = frozenset({
    torch.ops.aten.mm.default,
    torch.ops.aten.bmm.default,
    torch.ops.aten.addmm.default,
    torch.ops.aten.baddbmm.default,
})


def _save_dots(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    if op in _DOT_OPS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


_REMAT_POLICIES = {
    # save nothing: recompute the whole block in backward (min memory)
    "full": None,
    # save matmul outputs, recompute elementwise ops (jax's dots_saveable)
    "dots": _save_dots,
}


def _maybe_remat(fn, remat: str | None):
    """``fn`` run under a non-reentrant ``torch.utils.checkpoint`` with
    ``remat``'s policy (``None``: ``fn`` itself).  The blocks draw no
    random numbers, so no RNG state is kept for the recompute."""
    if remat is None:
        return fn
    policy = _REMAT_POLICIES[remat]
    kw: dict[str, Any] = {"use_reentrant": False,
                          "preserve_rng_state": False}
    if policy is not None:
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, policy)
    return functools.partial(checkpoint, fn, **kw)


def hidden_states(
    cfg: ModelConfig,
    params: TransformerLM,
    tokens,
    frontend_embeds=None,
    use_flash: bool = False,
    remat: str | None = None,
):
    """tokens (B,S) -> (final-normed hidden (B,S,d), moe aux loss: the sum
    over the MoE layers, float32; 0 without MoE).  ``remat`` ("full",
    "dots" or None) checkpoints each block.  Sharded ``params``: this
    rank's residual slice (``_hidden_tp``)."""
    _check_supported(cfg)
    if params.mesh is not None:
        return _hidden_tp(cfg, params, tokens, frontend_embeds, use_flash,
                          remat)[1:]
    block = _maybe_remat(_block_train, remat)
    x = embed_inputs(cfg, params, tokens, frontend_embeds)
    b, s = x.shape[:2]
    positions = _positions(b, s, x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for layer in _all_layers(params):
        x, a = block(cfg, layer, x, positions, use_flash)
        if a is not None:
            aux = aux + a
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
    """tokens (B,S) -> logits (B,S,V), aux (moe load-balance loss).
    Sharded ``params``: this rank's batch rows and vocab slice of the
    logits, the whole sequence."""
    if params.mesh is not None:
        L, x, aux = _hidden_tp(cfg, params, tokens, frontend_embeds,
                               use_flash, remat)
        with logical_sizes(L.sizes(cfg)):
            x = column_input(L, x, partitioned=L.vocab_split)
            return ax(x @ _head_tp(cfg, params, L), "batch", None,
                      "vocab"), aux
    x, aux = hidden_states(cfg, params, tokens, frontend_embeds, use_flash,
                           remat)
    logits = x @ lm_head(cfg, params)
    return logits, aux


# below this sequence length the full logits tensor is cheap enough to
# materialize; above it the loss walks sequence chunks (checkpointed)
_CE_CHUNK_THRESHOLD = 2048
_CE_CHUNK = 512


def loss_fn(
    cfg: ModelConfig,
    params: TransformerLM,
    tokens,
    labels,
    frontend_embeds=None,
    aux_weight: float = 0.01,
    use_flash: bool = False,
    remat: str | None = None,
):
    """Mean next-token cross entropy (float32, a 0-d tensor), plus
    ``aux_weight`` times the MoE aux loss for an MoE config.  From 2,048
    tokens (a multiple of 512) the loss never holds the whole (B, S, V)
    logits (``chunked_ce_loss``).  Sharded ``params``: the global loss on
    every rank, through the vocab-parallel cross entropy
    (``_loss_tp``)."""
    if params.mesh is not None:
        return _loss_tp(cfg, params, tokens, labels, frontend_embeds,
                        aux_weight, use_flash, remat)
    s = _tokens(params, tokens).shape[1]
    x, aux = hidden_states(cfg, params, tokens, frontend_embeds, use_flash,
                           remat)
    head = lm_head(cfg, params)
    labels = _tokens(params, labels)
    if s >= _CE_CHUNK_THRESHOLD and s % _CE_CHUNK == 0:
        loss = chunked_ce_loss(x, head, labels, _CE_CHUNK)
    else:
        loss = cross_entropy_loss(x @ head, labels)
    if cfg.mlp_type == "moe":
        loss = loss + aux_weight * aux
    return loss


def mtp_loss(cfg: ModelConfig, params: TransformerLM, tokens, labels_next,
             labels_next2):
    """Main next-token loss + depth-1 MTP loss sharing the embedding and
    the head: the MTP block reads the token's embedding beside the next
    token's (teacher forcing) through ``mtp.proj``.  Sharded ``params``:
    the global loss on every rank (``_mtp_loss_tp``)."""
    if params.mesh is not None:
        return _mtp_loss_tp(cfg, params, tokens, labels_next, labels_next2)
    logits, aux = forward(cfg, params, tokens)
    labels_next = _tokens(params, labels_next)
    main = cross_entropy_loss(logits, labels_next)
    p = params.mtp
    tok = _tokens(params, tokens)
    b, s = tok.shape
    h_last = F.embedding(labels_next, params.embed)  # teacher forcing
    x = torch.cat([F.embedding(tok, params.embed), h_last], dim=-1)
    x = x @ p.proj
    x, _ = _block_train(cfg, p.block, x, _positions(b, s, x.device), False)
    x = rms_norm(x, p.norm, cfg.rms_eps)
    logits2 = x @ lm_head(cfg, params)
    mtp = cross_entropy_loss(logits2, _tokens(params, labels_next2))
    return main + 0.3 * mtp + 0.01 * aux


# ---------------------------------------------------------------------------
# prefill: full-prompt forward that also builds the decode cache
# ---------------------------------------------------------------------------
@torch.no_grad()
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
    so decode_step continues from position S.  With sharded ``params``
    (``shard_params``) the call is this rank's cut (``_prefill_tp``).
    """
    _check_supported(cfg)
    if params.mesh is not None:
        return _prefill_tp(cfg, params, tokens, frontend_embeds, max_len,
                           use_flash)
    x = embed_inputs(cfg, params, tokens, frontend_embeds)
    b, s = x.shape[:2]
    max_len = max_len or s
    positions = _positions(b, s, x.device)
    cache: dict[str, Any] = {
        "pos": torch.full((b,), s, dtype=torch.int32, device=x.device),
    }
    for key in ("layers_dense", "layers"):
        layers = []
        for layer in getattr(params, key):
            x, c = _block_prefill(cfg, layer, x, positions, max_len,
                                  use_flash)
            layers.append(c)
        if layers or key == "layers":
            cache[key] = layers
    x = rms_norm(x[:, -1:], params.final_norm, cfg.rms_eps)
    logits = (x @ lm_head(cfg, params))[:, 0]
    return logits, cache


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------
def _init_layer_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                      device):
    if cfg.attn_type == "gqa":
        return init_kv_cache(cfg, batch, max_len, dtype, device)
    if cfg.attn_type == "mla":
        return init_mla_cache(cfg, batch, max_len, dtype, device)
    if cfg.attn_type == "rwkv6":
        return init_rwkv6_cache(cfg, batch, dtype, device)
    return {  # hymba
        "kv": init_kv_cache(cfg, batch, max_len, dtype, device),
        "ssm": init_ssm_cache(cfg, batch, dtype, device),
    }


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device="cuda"):
    """Per-layer caches + current position (zeros), on ``device``
    (``"meta"``: shapes only)."""
    _check_supported(cfg)
    dev = _abstract_or(device)
    dtype = _dtype(cfg)
    n_dense, n_main = _n_layers(cfg)
    cache: dict[str, Any] = {
        "layers": [_init_layer_cache(cfg, batch, max_len, dtype, dev)
                   for _ in range(n_main)],
        "pos": torch.zeros((batch,), dtype=torch.int32, device=dev),
    }
    if n_dense:
        cache["layers_dense"] = [
            _init_layer_cache(cfg, batch, max_len, dtype, dev)
            for _ in range(n_dense)
        ]
    return cache


@torch.no_grad()
def decode_step(cfg: ModelConfig, params: TransformerLM, tokens, cache):
    """tokens (B,) current token ids -> (logits (B,V), new cache).  Key /
    value and latent buffers are written in place and shared with the
    returned cache; recurrent states get new tensors; ``pos`` is a new
    tensor.  With sharded ``params`` the call is this rank's cut
    (``_decode_step_tp``)."""
    _check_supported(cfg)
    if params.mesh is not None:
        return _decode_step_tp(cfg, params, tokens, cache)
    position = cache["pos"]
    x = F.embedding(_tokens(params, tokens)[:, None], params.embed)
    new_cache = dict(cache, pos=position + 1)
    for key in ("layers_dense", "layers"):
        if key not in cache:
            continue
        layers = []
        for layer, layer_c in zip(getattr(params, key), cache[key]):
            x, c = _block_decode(cfg, layer, x, layer_c, position)
            layers.append(c)
        new_cache[key] = layers
    x = rms_norm(x, params.final_norm, cfg.rms_eps)
    logits = (x @ lm_head(cfg, params))[:, 0]
    return logits, new_cache


# ---------------------------------------------------------------------------
# tensor parallelism: this rank's cut of train / prefill / decode
# ---------------------------------------------------------------------------
def _tp_mesh(params: TransformerLM):
    mesh = current_mesh()
    if mesh is not params.mesh:
        raise RuntimeError(
            "sharded parameters run under logical_sharding(mesh, rules) "
            "with the mesh they were cut for")
    return mesh


def _res_ax(cfg: ModelConfig, x):
    """The residual stream between blocks, the reference's ``_res_ax``:
    batch over data, sequence over model for the attention families;
    batch over data only for the recurrent ones (RWKV6, Hymba), which
    scan over time."""
    if cfg.attn_type in ("rwkv6", "hymba"):
        return ax(x, "batch", None, None)
    return ax(x, "batch", "seq_sp", None)


def _shared_expert_tp(cfg: ModelConfig, L, sp, h):
    """A shared expert's float32 output of the whole sequence ``h`` on this
    rank: the partial of its FF columns where ``L.shared_cols``, else the
    whole (every rank alike); None without one.  Its hidden activation's
    FF axis is the expert's own width."""
    if sp is None:
        return None
    fs = cfg.moe_d_ff * cfg.n_shared_experts
    with logical_sizes(dict(L.sizes(cfg), ff=fs)):
        return swiglu_partial(h, sp.w1, sp.w3, sp.w2)


def _mlp_tp(cfg: ModelConfig, L, p: Block, h, with_aux: bool = False):
    """This rank's MLP of the residual slice ``h`` (normed), summed over
    ``model`` (``row_reduce``): its FF columns (or, where they are not
    cut, the whole MLP on every rank, then its sequence slice), or its
    experts and a shared expert's FF columns, their float32 partials
    added before the one sum (a shared expert whose columns are not cut
    runs whole on every rank and is added after it, on the sequence
    slice); ``b2`` added once, after the sum.  Returns (output, the MoE
    aux loss or None)."""
    if isinstance(p.mlp, MoE):
        hc = column_input(L, h)
        part, aux = _moe_ep_partial(
            p.mlp, cfg, hc, L.mesh, with_aux=with_aux,
            token_axes=("data",) if L.rows_cut else (),
            whole_leaf=functools.partial(partitioned_leaf, L))
        # a shared expert whose columns are not cut runs whole on every
        # rank: over a whole residual its gradient is whole already
        shared = _shared_expert_tp(
            cfg, L, p.mlp.shared,
            hc if L.shared_cols or L.seq_split else h)
        if shared is not None and L.shared_cols:
            part = part + shared
        out = row_reduce(L, part, h.dtype)
        if shared is not None and not L.shared_cols:
            out = out + own_seq(L, shared.to(h.dtype))
        return out, aux
    m = p.mlp
    h = column_input(L, h, partitioned=L.ff_cols)
    if L.ff_cols:
        n = cfg.d_ff // L.model
        out = row_reduce(L, swiglu_partial(
            h, m.w1, m.w3, m.w2, partitioned_leaf(L, m.b1),
            partitioned_leaf(L, m.b3), slice(L.mi * n, (L.mi + 1) * n)),
            h.dtype)
    else:
        out = own_seq(L, swiglu_partial(h, m.w1, m.w3, m.w2, m.b1,
                                        m.b3).to(h.dtype))
    return (out if m.b2 is None else out + m.b2), None


def _block_tp(cfg: ModelConfig, L, p: Block, x, positions,
              max_len: int | None = None, use_flash: bool = False,
              with_aux: bool = False):
    """One block on this rank: x its residual slice (B / data, S / model,
    d; the recurrent families' whole sequence).  A prefill block
    (``max_len`` given) also builds its cache; a train block builds none.
    Its attention takes the flash kernel when ``use_flash`` (which
    refuses autograd), else the plain one; RWKV6's time-mix takes K8 on
    the rank's heads when ``use_flash`` (which refuses autograd too).
    Hymba's attention and SSM partials are each summed over ``model``
    before their norms.  MLA takes the residual slice and gathers its
    latents, not the residual (``_mla_attend_tp``).
    Returns (x, the cache or None, the MoE aux loss or None)."""
    serve = max_len is not None
    h = rms_norm(x, p.norm1, cfg.rms_eps)
    if cfg.attn_type == "mla":
        if serve:
            a, cache = mla_prefill_tp(p.attn, cfg, L, h, positions, max_len)
        else:
            a, cache = _mla_attend_tp(p.attn, cfg, L, h, positions)[0], None
        x = _res_ax(cfg, x + row_reduce(L, a, x.dtype))
        m, aux = _mlp_tp(cfg, L, p, rms_norm(x, p.norm2, cfg.rms_eps),
                         with_aux)
        return _res_ax(cfg, x + m), cache, aux
    h = column_input(L, h)
    if cfg.attn_type == "rwkv6":
        if serve:
            a, cache = rwkv6_prefill_tp(p.attn, cfg, L, h, use_flash)
        else:
            a, cache = _time_mix_tp(p.attn, cfg, L, h, use_flash)[0], None
        x = _res_ax(cfg, x + row_reduce(L, a, x.dtype))
        h = rms_norm(x, p.norm2, cfg.rms_eps)
        if serve:
            cache["x_prev_cm"] = _own_d(L, h[:, -1, :])
        m = channel_mix_tp(p.mlp, L, column_input(L, h))
        return _res_ax(cfg, x + m), cache, None
    if serve:
        a, cache = attention_prefill_tp(p.attn, cfg, L, h, positions,
                                        max_len, use_flash)
    else:
        a, cache = attention_train_tp(p.attn, cfg, L, h, positions,
                                      use_flash), None
    if cfg.attn_type == "hymba":
        ssm_o, ssm_c = ssm_prefill_tp(p.ssm, cfg, L, h)
        if serve:
            cache = {"kv": cache, "ssm": ssm_c}
        att, ssm_o = row_reduce(L, torch.stack([a, ssm_o]),
                                x.dtype).unbind(0)
        a = _hymba_mix(cfg, p, att, ssm_o)
    else:
        a = row_reduce(L, a, x.dtype)
    x = _res_ax(cfg, x + a)
    m, aux = _mlp_tp(cfg, L, p, rms_norm(x, p.norm2, cfg.rms_eps), with_aux)
    return _res_ax(cfg, x + m), cache, aux


def _block_decode_tp(cfg: ModelConfig, L, p: Block, x, cache, position,
                     max_len: int):
    """x: (B, 1, d), whole on every model rank."""
    h = rms_norm(x, p.norm1, cfg.rms_eps)
    if cfg.attn_type == "rwkv6":
        a, state, xprev = rwkv6_decode_tp(p.attn, cfg, L, h, cache)
        x = x + row_reduce(L, a, x.dtype)
        m, xprev_cm = channel_mix_decode_tp(
            p.mlp, L, rms_norm(x, p.norm2, cfg.rms_eps), cache["x_prev_cm"])
        return x + m, {"state": state, "x_prev_tm": xprev,
                       "x_prev_cm": xprev_cm}
    if cfg.attn_type == "hymba":
        a, kv = attention_decode_tp(p.attn, cfg, L, h, cache["kv"], position,
                                    max_len)
        ssm_o, ssm_c = ssm_decode_tp(p.ssm, cfg, L, h, cache["ssm"])
        att, ssm_o = row_reduce(L, torch.stack([a, ssm_o]),
                                x.dtype).unbind(0)
        a, cache = _hymba_mix(cfg, p, att, ssm_o), {"kv": kv, "ssm": ssm_c}
    else:
        attend = (mla_decode_tp if cfg.attn_type == "mla"
                  else attention_decode_tp)
        a, cache = attend(p.attn, cfg, L, h, cache, position, max_len)
        a = row_reduce(L, a, x.dtype)
    x = x + a
    m, _ = _mlp_tp(cfg, L, p, rms_norm(x, p.norm2, cfg.rms_eps))
    return x + m, cache


def _head_tp(cfg: ModelConfig, params: TransformerLM, L) -> torch.Tensor:
    """(d, V / model): this rank's vocab columns of the head, gathered
    over ``data`` (the tied embedding's rows, transposed)."""
    if cfg.tie_embeddings:
        return gathered(L, params.embed, params.fsdp_dims["embed"]).T
    return gathered(L, params.lm_head, params.fsdp_dims["lm_head"])


def _tp_layers(params: TransformerLM):
    """(cache key, its blocks) in order, with each block's name prefix."""
    for key in ("layers_dense", "layers"):
        yield key, [(f"{key}.{i}.", blk)
                    for i, blk in enumerate(getattr(params, key))]


def _embed_tp(cfg: ModelConfig, params: TransformerLM, L, ids,
              frontend_embeds):
    """The residual slice of this rank's rows ``ids`` (B / data, S): the
    vocab-parallel lookup, frontend embeddings on the first positions."""
    x = embed_tokens(L, gathered(L, params.embed, params.fsdp_dims["embed"]),
                     ids)
    if cfg.frontend is not None and frontend_embeds is not None:
        fe = torch.as_tensor(frontend_embeds, device=x.device)
        fe = fe[L.rows].to(x.dtype)
        pos = L.s_lo + torch.arange(x.shape[1], device=x.device)
        fe = F.pad(fe, (0, 0, 0, L.seq - fe.shape[1]))[:, pos]
        x = torch.where((pos < frontend_embeds.shape[1])[None, :, None],
                        fe, x)
    return _res_ax(cfg, x)


def _hidden_tp(cfg: ModelConfig, params: TransformerLM, tokens,
               frontend_embeds, use_flash: bool, remat: str | None):
    """``hidden_states``' cut on this rank: (its ``TPLayout``, its
    final-normed residual slice (B / data, S / model, d), the MoE aux
    loss summed over the layers).  Each block, its ZeRO-3 gathers
    inside, runs under ``remat``'s checkpoint with this thread's layout
    state."""
    mesh = _tp_mesh(params)
    ids = _tokens(params, tokens)
    b, s = ids.shape
    L = tp_layout(cfg, mesh, b, s)
    moe = cfg.mlp_type == "moe"
    with logical_sizes(L.sizes(cfg)):
        x = _embed_tp(cfg, params, L, ids[L.rows], frontend_embeds)
        positions = _positions(x.shape[0], s, x.device)
        state = layout_state()
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for _, blocks in _tp_layers(params):
            for prefix, blk in blocks:
                def run(x, prefix=prefix, blk=blk):
                    with layout_installed(state), fsdp_gathered(
                            L, blk, params.fsdp_dims, prefix):
                        x, _, a = _block_tp(cfg, L, blk, x, positions,
                                            use_flash=use_flash,
                                            with_aux=moe)
                    return x, a
                x, a = _maybe_remat(run, remat)(x)
                if a is not None:
                    aux = aux + a
        return L, rms_norm(x, params.final_norm, cfg.rms_eps), aux


def _ce_tp(cfg: ModelConfig, params: TransformerLM, L, x, labels, count):
    """The mean cross entropy over ``count`` global tokens of this rank's
    final-normed residual slice ``x`` against ``labels`` (the global
    (B, S) ids), the global value on every rank.  Vocab cut over
    ``model``: the whole sequence of the rank's rows against its vocab
    columns of the head (the vocab-parallel cross entropy; chunked from
    2,048 tokens).  Vocab whole: the rank's sequence slice against the
    whole head, its sum added over ``model``.  The rows' sums are added
    over ``data``.  Runs under the call's ``logical_sizes``."""
    labels = _tokens(params, labels)[L.rows]
    s = labels.shape[1]
    head = _head_tp(cfg, params, L)
    axes = ["data"] if L.rows_cut else []
    if L.vocab_split:
        x = column_input(L, x)
        vocab = (L.mesh, L.v_lo)
    else:
        labels = own_seq(L, labels)
        vocab = None
        if L.seq_split:
            axes.append("model")
    if s >= _CE_CHUNK_THRESHOLD and s % _CE_CHUNK == 0:
        loss = chunked_ce_loss(x, head, labels,
                               math.gcd(x.shape[1], _CE_CHUNK),
                               vocab=vocab, count=count)
    else:
        loss = cross_entropy_loss(x @ head, labels, vocab=vocab,
                                  count=count)
    if axes:
        loss = psum(loss, tuple(axes), mesh=L.mesh)
    return loss


def _loss_tp(cfg: ModelConfig, params: TransformerLM, tokens, labels,
             frontend_embeds, aux_weight: float, use_flash: bool,
             remat: str | None):
    """``loss_fn``'s cut on this rank: the global mean over the B S tokens
    on every rank (``_ce_tp``), plus ``aux_weight`` times the MoE aux
    loss."""
    b, s = _tokens(params, tokens).shape
    L, x, aux = _hidden_tp(cfg, params, tokens, frontend_embeds, use_flash,
                           remat)
    with logical_sizes(L.sizes(cfg)):
        loss = _ce_tp(cfg, params, L, x, labels, b * s)
    if cfg.mlp_type == "moe":
        loss = loss + aux_weight * aux
    return loss


def _mtp_loss_tp(cfg: ModelConfig, params: TransformerLM, tokens,
                 labels_next, labels_next2):
    """``mtp_loss``'s cut on this rank, the global loss on every rank: the
    main loss (``_hidden_tp``, ``_ce_tp``); the vocab-parallel lookups of
    ``tokens`` and ``labels_next`` in one, concatenated on the residual
    slice and taken through ``mtp.proj`` (whole over ``model``, its
    d_model rows gathered over ``data``); the MTP block through
    ``_block_tp`` with its ZeRO-3 gathers; its norm and the
    vocab-parallel cross entropy against ``labels_next2``; then ``main +
    0.3 * mtp + 0.01 * aux``, as the reference computes it."""
    b, s = _tokens(params, tokens).shape
    L, x, aux = _hidden_tp(cfg, params, tokens, None, False, None)
    p = params.mtp
    with logical_sizes(L.sizes(cfg)):
        main = _ce_tp(cfg, params, L, x, labels_next, b * s)
        ids = torch.cat([_tokens(params, tokens)[L.rows],
                         _tokens(params, labels_next)[L.rows]])
        e = embed_tokens(L, gathered(L, params.embed,
                                     params.fsdp_dims["embed"]), ids)
        x = torch.cat(e.chunk(2), dim=-1) @ gathered(
            L, p.proj, params.fsdp_dims["mtp.proj"])
        x = _res_ax(cfg, x)
        with fsdp_gathered(L, p.block, params.fsdp_dims, "mtp.block."):
            x, _, _ = _block_tp(cfg, L, p.block, x,
                                _positions(x.shape[0], s, x.device))
        x = rms_norm(x, p.norm, cfg.rms_eps)
        mtp = _ce_tp(cfg, params, L, x, labels_next2, b * s)
    return main + 0.3 * mtp + 0.01 * aux


@torch.no_grad()
def _prefill_tp(cfg: ModelConfig, params: TransformerLM, tokens,
                frontend_embeds, max_len, use_flash):
    """``prefill``'s cut on this rank: ``tokens`` (B, S) are the global
    batch's; returns (this rank's last-token logits (B / data, V / model),
    where each dim divides, its ``TPCache``)."""
    mesh = _tp_mesh(params)
    ids = _tokens(params, tokens)
    b, s = ids.shape
    max_len = max_len or s
    L = tp_layout(cfg, mesh, b, s)
    with logical_sizes(L.sizes(cfg)):
        x = _embed_tp(cfg, params, L, ids[L.rows], frontend_embeds)
        positions = _positions(x.shape[0], s, x.device)
        cache = TPCache(max_len=max_len)
        cache["pos"] = torch.full((x.shape[0],), s, dtype=torch.int32,
                                  device=x.device)
        for key, blocks in _tp_layers(params):
            layers = []
            for prefix, blk in blocks:
                with fsdp_gathered(L, blk, params.fsdp_dims, prefix):
                    x, c, _ = _block_tp(cfg, L, blk, x, positions, max_len,
                                        use_flash)
                layers.append(c)
            if layers or key == "layers":
                cache[key] = layers
        x = rms_norm(last_position(L, x), params.final_norm, cfg.rms_eps)
        logits = (x @ _head_tp(cfg, params, L))[:, 0]
        return ax(logits, "batch", "vocab"), cache


@torch.no_grad()
def _decode_step_tp(cfg: ModelConfig, params: TransformerLM, tokens, cache):
    """``decode_step``'s cut on this rank: ``tokens`` (B,) are the global
    batch's, ``cache`` this rank's ``TPCache`` (written in place).
    Returns (its logits (B / data, V / model), the new ``TPCache``)."""
    mesh = _tp_mesh(params)
    if not isinstance(cache, TPCache):
        raise TypeError("a tensor-parallel decode takes the TPCache of "
                        "prefill or launch.shardings.init_cache_shards")
    ids = _tokens(params, tokens)
    L = tp_layout(cfg, mesh, ids.shape[0], 1)
    ids = ids[L.rows]
    position = cache["pos"]
    with logical_sizes(L.sizes(cfg)):
        x = embed_tokens(L, gathered(L, params.embed,
                                     params.fsdp_dims["embed"]), ids[:, None])
        new_cache = TPCache(cache, pos=position + 1, max_len=cache.max_len)
        for key, blocks in _tp_layers(params):
            if key not in cache:
                continue
            layers = []
            for (prefix, blk), layer_c in zip(blocks, cache[key]):
                with fsdp_gathered(L, blk, params.fsdp_dims, prefix):
                    x, c = _block_decode_tp(cfg, L, blk, x, layer_c, position,
                                            cache.max_len)
                layers.append(c)
            new_cache[key] = layers
        x = rms_norm(x, params.final_norm, cfg.rms_eps)
        logits = (x @ _head_tp(cfg, params, L))[:, 0]
        return ax(logits, "batch", "vocab"), new_cache
