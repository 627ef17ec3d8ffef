"""Blockwise (flash) causal attention — the port of
``repro.kernels.flash_attention.flash_attention``: K7.

``flash_attention_bh(q, k, v, causal, window)`` takes
q (BH, S, hd) and k, v (BH, T, hd) in float32 or bfloat16 and returns
(BH, S, hd) in q's type, computed in float32 with an online softmax over
key/value blocks, as the Pallas kernel ``_flash_kernel`` does.
``_flash_attention_grouped`` is the same with k, v (BH / n_rep, T, hd):
query head b reads key/value head b // n_rep, so grouped-query attention
needs no repeated copy of the KV heads (``ops.flash_attention`` calls it).

Masks follow the kernel, not the oracle: rows and columns count from 0
in q and in k (``rows >= cols`` when causal, ``rows - cols < window``
with a window), so when T != S the result is LEFT-aligned, while
``ref.mha_reference`` right-aligns; the model only passes S == T.  A
dropped score is the finite -1e30, which is also the running max's
initial value, and a tile no row of its query block can reach is skipped
whole — so a row whose first visited tile is wholly masked for it
briefly sums p = exp(0) = 1 there, until the next real tile rescales it
by exp(-1e30 - m) = 0, as on the TPU.  A row that keeps no key at all
(S >= T + window, or window <= 0) is 0: the Pallas kernel returns the
mean of V over the masked tiles it visited there, which depends on its
tiling, while the port's routes and its plain version tile differently
and agree on the 0.  The ragged edge (S or T not a multiple of the
block) is masked: columns past T are dropped.  The interpret-mode Pallas
kernel reads NaN padding there instead and returns NaN rows for the last
query block; the port returns the oracle's values.

Dispatch is by the tensors' device.  On the CPU the entry runs the plain
PyTorch version ``_flash_plain`` (the same online softmax over 64 x 64
tiles, vectorised over BH and the query rows).  On a CUDA device it
launches the hand-written Hopper kernel in ``csrc/flash_attention.cu``
(``_launch_flash``) or raises; it never falls back.  On the card the
kernel's route is chosen by the type, one route per type: bfloat16 runs
on the tensor cores (``wgmma`` products, TMA loads, 128 x 128 query x
key tiles as ``tc_config`` reports them, P split into bf16 high and low
parts so that P V keeps float32's accuracy), float32 on the CUDA cores
(``TILE`` x ``TILE`` tiles, float32 FMAs: TF32 products would miss
float32's tolerance).
``LAUNCHES["flash"]`` counts the launches of both routes.  The
reference's ``block_q`` / ``block_k`` (its TPU tile sizes) and
``interpret=`` keywords are dropped; the tile sizes change only the
summation order.  Neither route has a backward pass: called where
autograd would differentiate it, the entry raises
``kernels.KernelGradientError``, as ``jax.grad`` raises through the
Pallas kernel.
"""
from __future__ import annotations

import ctypes

import torch

from .. import refuse_autograd

__all__ = ["LAUNCHES", "flash_attention_bh", "reset_launches"]

_NEG_INF = -1e30

#: Head widths the kernel is instantiated for.
HEAD_DIMS = (32, 64, 128)
#: The float32 route's query and key/value tile (rows); the plain version
#: sums in it too.
TILE = 64
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: What ``fa_tc_config`` reports, in its order.
_TC_CONFIG_KEYS = ("block_q", "block_k", "stages", "consumer_warpgroups",
                   "dynamic_smem_bytes", "producer_registers",
                   "consumer_registers")

#: CUDA launches of K7 since the last reset.
LAUNCHES = {"flash": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "fa_forward": ([_P] * 4 + [_I] * 6 + [ctypes.c_float] + [_I] * 3 + [_P],
                   _I),
    "fa_tc_config": ([_I, ctypes.POINTER(_I)], _I),
    "fa_error_string": ([_I], ctypes.c_char_p),
}


def reset_launches() -> None:
    """Set the launch count to 0."""
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def flash_attention_bh(
    q: torch.Tensor,  # (BH, S, hd)
    k: torch.Tensor,  # (BH, T, hd)
    v: torch.Tensor,  # (BH, T, hd)
    causal: bool = True,
    window: int | None = None,
) -> torch.Tensor:
    """Attention of q over k / v per (batch * head); see the module
    docstring for the masks.  CPU tensors run ``_flash_plain``; CUDA
    tensors launch K7 or raise."""
    return _flash_attention_grouped(q, k, v, 1, causal, window)


def _flash_attention_grouped(q, k, v, n_rep: int, causal: bool = True,
                             window: int | None = None) -> torch.Tensor:
    """``flash_attention_bh`` with k, v of (BH / n_rep, T, hd): query head
    b attends over key/value head b // n_rep."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
    if not (q.device == k.device == v.device):
        raise ValueError(
            f"q, k, v on different devices: {q.device}, {k.device}, {v.device}"
        )
    refuse_autograd("flash attention (K7)", q, k, v)
    if q.device.type == "cpu":
        return _flash_plain(q, k, v, causal, window, n_rep=n_rep)
    return _launch_flash(q, k, v, causal, window, n_rep)


def _flash_plain(q, k, v, causal: bool = True, window: int | None = None,
                 block_q: int = TILE, block_k: int = TILE,
                 n_rep: int = 1) -> torch.Tensor:
    """K7's arithmetic in PyTorch: the online softmax over key blocks of
    ``block_k`` in float32, vectorised over BH and the query rows, with the
    kernel's masks, its -1e30 and its per-(query block, key block)
    reachability skip.  The block sizes default to the float32 route's
    tile; other sizes change only the summation order (clipped to S / T,
    as the reference clips them), which the tests use to meet the
    reference's tiles.  Query head b reads key/value head b // n_rep, as
    the kernel does; a row that keeps no key is 0."""
    bh, s, hd = q.shape
    t = k.shape[1]
    if n_rep > 1:
        heads = torch.arange(bh, device=k.device) // n_rep
        k, v = k.index_select(0, heads), v.index_select(0, heads)
    block_q = min(block_q, s)
    block_k = min(block_k, t)
    scale = hd**-0.5
    dev = q.device
    qf = q.float()
    n_k = -(-t // block_k)
    pad = n_k * block_k - t
    kf = torch.nn.functional.pad(k.float(), (0, 0, 0, pad))
    vf = torch.nn.functional.pad(v.float(), (0, 0, 0, pad))
    rows = torch.arange(s, device=dev)[:, None]  # (S, 1)
    q_start = (rows // block_q) * block_q  # each row's query-block start
    m = torch.full((bh, s, 1), _NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((bh, s, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((bh, s, hd), dtype=torch.float32, device=dev)
    for j in range(n_k):
        k_start = j * block_k
        run = torch.ones((s, 1), dtype=torch.bool, device=dev)
        if causal:
            run &= k_start <= q_start + block_q - 1
        if window is not None:
            run &= q_start - (k_start + block_k - 1) < window
        if not bool(run.any()):
            continue
        kb = kf[:, k_start:k_start + block_k]
        vb = vf[:, k_start:k_start + block_k]
        sc = torch.matmul(qf, kb.transpose(1, 2)) * scale  # (BH, S, bk)
        cols = k_start + torch.arange(block_k, device=dev)[None, :]
        mask = cols < t
        if causal:
            mask = mask & (rows >= cols)
        if window is not None:
            mask = mask & (rows - cols < window)
        sc = torch.where(mask, sc, _NEG_INF)
        m_new = torch.maximum(m, sc.amax(dim=-1, keepdim=True))
        p = torch.exp(sc - m_new)
        alpha = torch.exp(m - m_new)
        l_new = alpha * l + p.sum(dim=-1, keepdim=True)
        acc_new = acc * alpha + torch.matmul(p, vb)
        m = torch.where(run, m_new, m)
        l = torch.where(run, l_new, l)
        acc = torch.where(run, acc_new, acc)
    out = torch.where(m == _NEG_INF, 0.0, acc / torch.clamp(l, min=1e-30))
    return out.to(q.dtype)


def _library() -> ctypes.CDLL:
    from ..build import load

    return load("flash_attention", _SIGNATURES)


def tc_config(hd: int) -> dict[str, int]:
    """The bf16 route's tiles, ring depth, shared memory and register
    split at head width ``hd``, as the built library reports them."""
    out = (_I * len(_TC_CONFIG_KEYS))()
    _raise_on(_library().fa_tc_config(hd, out), "fa_tc_config")
    return dict(zip(_TC_CONFIG_KEYS, out))


def _raise_on(err: int, fn: str) -> None:
    if err:
        msg = _library().fa_error_string(err).decode()
        raise RuntimeError(f"{fn} failed: CUDA error {err} ({msg})")


def _check(name: str, t: torch.Tensor, dtype, shape, device) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def _launch_flash(q, k, v, causal: bool = True, window: int | None = None,
                  n_rep: int = 1) -> torch.Tensor:
    """Launch K7 on the card: bfloat16 on the tensor cores (CTAs of 128
    query rows of one head sweeping 128-row key/value tiles), float32 on
    the CUDA cores (CTAs of 64 query rows, 64-row tiles).  k and v hold
    BH / n_rep heads."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"K7 launches on a CUDA device, got {dev}")
    if q.dim() != 3:
        raise ValueError(f"q must be (BH, S, hd), got shape {tuple(q.shape)}")
    bh, s, hd = q.shape
    t = k.shape[1] if k.dim() == 3 else -1
    if q.dtype not in _DTYPES:
        raise ValueError(f"K7 takes float32 or bfloat16, got {q.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"K7 supports head_dim in {HEAD_DIMS}, got {hd}")
    if n_rep < 1 or bh % n_rep:
        raise ValueError(f"n_rep={n_rep} must divide BH={bh}")
    _check("q", q, q.dtype, (bh, s, hd), dev)
    _check("k", k, q.dtype, (bh // n_rep, t, hd), dev)
    _check("v", v, q.dtype, (bh // n_rep, t, hd), dev)
    if min(bh, s, t) <= 0:
        raise ValueError(f"K7 needs non-empty inputs, got BH={bh} S={s} T={t}")
    out = torch.empty_like(q)
    lib = _library()
    with torch.cuda.device(dev):
        err = lib.fa_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bh,
            n_rep, s, t, hd, _DTYPES[q.dtype], hd**-0.5, int(causal),
            int(window is not None), 0 if window is None else int(window),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on(err, "fa_forward")
    LAUNCHES["flash"] += 1
    return out
