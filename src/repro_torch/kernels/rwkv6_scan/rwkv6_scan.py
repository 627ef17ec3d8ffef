"""Chunked WKV6 recurrence — the port of
``repro.kernels.rwkv6_scan.rwkv6_scan``: K8.

``wkv6_scan(r, k, v, w, u, state, chunk)`` takes r, k, v, w (BH, S, hd)
float32, u (BH, hd) and the initial state (BH, hd, hd) float32, and
returns ``(y (BH, S, hd), final state (BH, hd, hd))``, both float32:

    y_t = r_t . (S_{t-1} + diag(u) k_t^T v_t)
    S_t = diag(w_t) S_{t-1} + k_t^T v_t

The decay w_t scales the state's rows (the k index), and y_t reads the
state from before step t's update.  ``chunk`` is the reference's
sequence tile: it must divide S (after ``chunk = min(chunk, S)``), as the
reference asserts.  It changes nothing in the result, since each step
follows the last one in order; K8 stages its own tiles.  ``wkv6_bh`` is
the same recurrence over any S, without the assertion, and also takes
the model's own layout: r, k, v (B, S, H, hd) in float32 or bf16, w
(B, S, H, hd) float32, u (H, hd), the state (B, H, hd, hd) float32; it
then returns a contiguous float32 y (B, S, H, hd) and the final state
(B, H, hd, hd).  ``ops.wkv6`` calls it so: on a card K8 reads those
tensors where they lie, with no fold into (BH, S, hd), no float32 copy
and no transpose (``bh_layout`` makes that fold, for the plain version
and for comparisons).

Dispatch is by the tensors' device.  On the CPU the entries run the plain
PyTorch versions: ``_wkv6_plain`` (the time loop, vectorised over BH) and
its model-layout twin ``_wkv6_model_plain`` (upcast, ``bh_layout``,
``_wkv6_plain``, unfold).  On a CUDA device they launch the hand-written
Hopper kernel in ``csrc/rwkv6_scan.cu`` (``_launch_wkv6``; the
(BH, S, hd) layout is the case B = BH, H = 1) or raise; they never fall
back, and the launch never copies an input: it refuses what the kernel
does not take.  ``LAUNCHES["wkv6"]`` counts the kernel's launches.  The
reference's ``interpret=`` keyword is dropped.
"""
from __future__ import annotations

import ctypes

import torch

from .ref import wkv6_reference

__all__ = ["LAUNCHES", "bh_layout", "config", "reset_launches", "wkv6_bh",
           "wkv6_scan"]

#: Head widths the kernel is instantiated for.
HEAD_DIMS = (16, 32, 64)
#: Types of r, k, v the kernel reads, by its dtype code.
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_GRID = (1 << 31) - 1

#: CUDA launches of K8 since the last reset.
LAUNCHES = {"wkv6": 0}

#: What ``wkv6_config`` reports, in its order.
CONFIG_KEYS = ("tile_steps", "stages", "step_threads", "helper_threads",
               "state_rows_per_thread", "state_cols_per_thread",
               "stage_bytes", "smem_bytes")

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "wkv6_forward": ([_P] * 8 + [_I] * 6 + [_P], _I),
    "wkv6_config": ([_I, _I, ctypes.POINTER(_I)], _I),
    "wkv6_error_string": ([_I], ctypes.c_char_p),
}


def reset_launches() -> None:
    """Set the launch count to 0."""
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def wkv6_scan(
    r: torch.Tensor,  # (BH, S, hd) float32
    k: torch.Tensor,
    v: torch.Tensor,
    w: torch.Tensor,
    u: torch.Tensor,  # (BH, hd)
    state: torch.Tensor,  # (BH, hd, hd)
    chunk: int = 64,
):
    """Returns (y (BH, S, hd) float32, final state (BH, hd, hd) float32).
    ``chunk`` must divide S, as the reference asserts; then ``wkv6_bh``."""
    s = r.shape[1]
    chunk = min(chunk, s)
    assert s % chunk == 0, "pad sequence to a chunk multiple"
    return wkv6_bh(r, k, v, w, u, state)


def _same_device(r, k, v, w, u, state) -> None:
    for name, t in (("r", r), ("k", k), ("v", v), ("w", w), ("u", u),
                    ("state", state)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
    devices = {t.device for t in (r, k, v, w, u, state)}
    if len(devices) != 1:
        raise ValueError(
            f"inputs on different devices: {sorted(map(str, devices))}")


def wkv6_bh(r, k, v, w, u, state):
    """The recurrence over any S >= 1, on the tensors' device and either
    layout: the reference's (BH, S, hd) or the model's (B, S, H, hd) (with
    u (H, hd) and the state (B, H, hd, hd)).  CPU tensors run the plain
    version of their layout, ``_wkv6_plain`` or ``_wkv6_model_plain``;
    CUDA tensors launch K8 on them as they are, or raise."""
    _same_device(r, k, v, w, u, state)
    if r.device.type == "cpu":
        plain = _wkv6_model_plain if r.dim() == 4 else _wkv6_plain
        return plain(r, k, v, w, u, state)
    return _launch_wkv6(r, k, v, w, u, state)


def bh_layout(r, k, v, w, u, state):
    """The contiguous float32 (BH, S, hd) r, k, v, w, (BH, hd) u and
    (BH, hd, hd) state of the model's (B, S, H, hd) inputs: heads moved
    next to the batch, u repeated over the batch."""
    b, s, h, hd = r.shape

    def fold(a):
        return a.float().transpose(1, 2).reshape(b * h, s, hd).contiguous()

    uf = u.float()[None].expand(b, h, hd).reshape(b * h, hd).contiguous()
    sf = state.float().reshape(b * h, hd, hd).contiguous()
    return fold(r), fold(k), fold(v), fold(w), uf, sf


def _wkv6_plain(r, k, v, w, u, state):
    """K8's recurrence in PyTorch, in float32: the oracle's time loop
    (``ref.wkv6_reference``), one step per time index, vectorised over
    BH."""
    return wkv6_reference(*(t.float() for t in (r, k, v, w, u, state)))


def _wkv6_model_plain(r, k, v, w, u, state):
    """``_wkv6_plain`` on the model's layout: the inputs upcast and folded
    by ``bh_layout``, y unfolded to a contiguous (B, S, H, hd) and the
    state to (B, H, hd, hd)."""
    b, s, h, hd = r.shape
    y, s_final = _wkv6_plain(*bh_layout(r, k, v, w, u, state))
    y = y.reshape(b, h, s, hd).transpose(1, 2).contiguous()
    return y, s_final.reshape(b, h, hd, hd)


def _library() -> ctypes.CDLL:
    from ..build import load

    return load("rwkv6_scan", _SIGNATURES)


def _raise_on(err: int, fn: str) -> None:
    if err:
        msg = _library().wkv6_error_string(err).decode()
        raise RuntimeError(f"{fn} failed: CUDA error {err} ({msg})")


def config(hd: int, dtype: torch.dtype = torch.bfloat16) -> dict[str, int]:
    """The built kernel's tiling at head width ``hd`` for r, k, v of
    ``dtype``, as the library reports it (``CONFIG_KEYS``)."""
    out = (_I * len(CONFIG_KEYS))()
    _raise_on(_library().wkv6_config(hd, DTYPES[dtype], out), "wkv6_config")
    return dict(zip(CONFIG_KEYS, out))


def _check(name: str, t: torch.Tensor, dtype, shape) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def _launch_wkv6(r, k, v, w, u, state):
    """Launch K8 on the card, on either layout as it lies in memory:
    r, k, v, w (B, S, H, hd) with u (H, hd) and the state (B, H, hd, hd),
    or (BH, S, hd) with u (BH, hd) and the state (BH, hd, hd).  r, k, v
    are float32 or bf16 alike; w, u and the state float32; every tensor
    contiguous.  Anything else raises before the launch: nothing is copied
    or converted here.  One CTA per (b, h) walks the sequence in TMA tiles
    (``config``); any S >= 1."""
    if not isinstance(r, torch.Tensor):
        raise TypeError("r must be a torch.Tensor")
    if r.dim() == 4:
        b, s, h, hd = r.shape
        u_shape, st_shape, per_batch = (h, hd), (b, h, hd, hd), 0
    elif r.dim() == 3:
        b, s, hd = r.shape
        h = 1
        u_shape, st_shape, per_batch = (b, hd), (b, hd, hd), 1
    else:
        raise ValueError("r must be (B, S, H, hd) or (BH, S, hd), got shape "
                         f"{tuple(r.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"K8 supports head_dim in {HEAD_DIMS}, got {hd}")
    if min(b, s, h) <= 0:
        raise ValueError(f"K8 needs non-empty inputs, got shape "
                         f"{tuple(r.shape)}")
    if b * h > _MAX_GRID:
        raise ValueError(f"K8's grid would exceed {_MAX_GRID} CTAs")
    if r.dtype not in DTYPES:
        raise ValueError(f"r has dtype {r.dtype}, expected one of "
                         f"{tuple(DTYPES)}")
    for name, t in (("r", r), ("k", k), ("v", v)):
        _check(name, t, r.dtype, r.shape)
    _check("w", w, torch.float32, r.shape)
    _check("u", u, torch.float32, u_shape)
    _check("state", state, torch.float32, st_shape)
    dev = r.device
    if dev.type != "cuda":
        raise ValueError(f"K8 launches on a CUDA device, got {dev}")
    for name, t in (("k", k), ("v", v), ("w", w), ("u", u),
                    ("state", state)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
    y = torch.empty(r.shape, dtype=torch.float32, device=dev)
    s_final = torch.empty_like(state)
    lib = _library()
    with torch.cuda.device(dev):
        err = lib.wkv6_forward(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), state.data_ptr(), y.data_ptr(), s_final.data_ptr(),
            b, s, h, hd, DTYPES[r.dtype], per_batch,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on(err, "wkv6_forward")
    LAUNCHES["wkv6"] += 1
    return y, s_final
