"""Public wrapper: the (B, S, H, hd) model layout into K8 — the port of
``repro.kernels.rwkv6_scan.ops``."""
from __future__ import annotations

from .rwkv6_scan import wkv6_bh

__all__ = ["wkv6"]


def wkv6(r, k, v, w, u, state, chunk: int = 64):
    """r,k,v,w: (B,S,H,hd); u: (H,hd); state: (B,H,hd,hd) float32.

    Returns (y (B,S,H,hd) float32, contiguous; final state (B,H,hd,hd)).
    K8 runs on the tensors' device (the plain version on the CPU) over any
    S.  Unlike the reference, nothing is folded into (BH, S, hd): on a
    card K8 reads r, k, v (float32 or bf16, the model's type), w (float32)
    and the state as they are, and writes y in this layout; only u is
    upcast to float32.  A tensor K8 does not take (another type, not
    contiguous) raises; it is not copied.  The reference pads S to a
    multiple of ``chunk`` with w = 1 and r = k = v = 0, steps that leave
    the state exactly as it was; here nothing is padded (K8 masks its
    ragged last tile), so ``chunk``, kept for the reference's signature,
    changes nothing."""
    return wkv6_bh(r, k, v, w, u.float(), state)
