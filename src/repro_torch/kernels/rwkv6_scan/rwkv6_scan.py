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
follows the last one in order; K8 stages its own 64-step tiles.
``wkv6_bh`` is the same recurrence over any S, without the assertion;
``ops.wkv6`` calls it.

Dispatch is by the tensors' device.  On the CPU the entry runs the plain
PyTorch version ``_wkv6_plain`` (the time loop, vectorised over BH).  On
a CUDA device it launches the hand-written Hopper kernel in
``csrc/rwkv6_scan.cu`` (``_launch_wkv6``) or raises; it never falls back.
``LAUNCHES["wkv6"]`` counts the kernel's launches.  The reference's
``interpret=`` keyword is dropped.
"""
from __future__ import annotations

import ctypes

import torch

from .ref import wkv6_reference

__all__ = ["LAUNCHES", "reset_launches", "wkv6_bh", "wkv6_scan"]

#: Head widths the kernel is instantiated for.
HEAD_DIMS = (16, 32, 64)
_MAX_GRID = (1 << 31) - 1

#: CUDA launches of K8 since the last reset.
LAUNCHES = {"wkv6": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "wkv6_forward": ([_P] * 8 + [_I] * 3 + [_P], _I),
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


def wkv6_bh(r, k, v, w, u, state):
    """The recurrence over any S >= 1, on the tensors' device: CPU tensors
    run ``_wkv6_plain``; CUDA tensors launch K8 or raise."""
    for name, t in (("r", r), ("k", k), ("v", v), ("w", w), ("u", u),
                    ("state", state)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
    devices = {t.device for t in (r, k, v, w, u, state)}
    if len(devices) != 1:
        raise ValueError(
            f"inputs on different devices: {sorted(map(str, devices))}")
    if r.device.type == "cpu":
        return _wkv6_plain(r, k, v, w, u, state)
    return _launch_wkv6(r, k, v, w, u, state)


def _wkv6_plain(r, k, v, w, u, state):
    """K8's recurrence in PyTorch, in float32: the oracle's time loop
    (``ref.wkv6_reference``), one step per time index, vectorised over
    BH."""
    return wkv6_reference(*(t.float() for t in (r, k, v, w, u, state)))


def _library() -> ctypes.CDLL:
    from ..build import load

    return load("rwkv6_scan", _SIGNATURES)


def _raise_on(err: int, fn: str) -> None:
    if err:
        msg = _library().wkv6_error_string(err).decode()
        raise RuntimeError(f"{fn} failed: CUDA error {err} ({msg})")


def _check(name: str, t: torch.Tensor, shape, device) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise ValueError(f"{name} has dtype {t.dtype}, expected float32")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def _launch_wkv6(r, k, v, w, u, state):
    """Launch K8 on the card: one CTA of 256 threads per (b * h), the
    state in registers, the sequence walked in 64-step tiles; any S >= 1
    (a ragged last tile is masked in the kernel)."""
    dev = r.device
    if dev.type != "cuda":
        raise ValueError(f"K8 launches on a CUDA device, got {dev}")
    if r.dim() != 3:
        raise ValueError(f"r must be (BH, S, hd), got shape {tuple(r.shape)}")
    bh, s, hd = r.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"K8 supports head_dim in {HEAD_DIMS}, got {hd}")
    if min(bh, s) <= 0:
        raise ValueError(f"K8 needs non-empty inputs, got BH={bh} S={s}")
    if bh > _MAX_GRID:
        raise ValueError(f"K8's grid would exceed {_MAX_GRID} CTAs")
    for name, t in (("r", r), ("k", k), ("v", v), ("w", w)):
        _check(name, t, (bh, s, hd), dev)
    _check("u", u, (bh, hd), dev)
    _check("state", state, (bh, hd, hd), dev)
    y = torch.empty_like(r)
    s_final = torch.empty_like(state)
    lib = _library()
    with torch.cuda.device(dev):
        err = lib.wkv6_forward(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), state.data_ptr(), y.data_ptr(), s_final.data_ptr(),
            bh, s, hd, torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on(err, "wkv6_forward")
    LAUNCHES["wkv6"] += 1
    return y, s_final
