"""Public wrapper: the (B, S, H, hd) model layout around K8 — the port of
``repro.kernels.rwkv6_scan.ops``."""
from __future__ import annotations

from .rwkv6_scan import wkv6_bh

__all__ = ["bh_layout", "wkv6"]


def wkv6(r, k, v, w, u, state, chunk: int = 64):
    """r,k,v,w: (B,S,H,hd); u: (H,hd); state: (B,H,hd,hd) float32.

    Returns (y (B,S,H,hd) float32, final state (B,H,hd,hd)).  K8 runs on
    the tensors' device (the plain version on the CPU) over any S.  The
    reference pads S to a multiple of ``chunk`` with w = 1 and
    r = k = v = 0, steps that leave the state exactly as it was; here
    nothing is padded (K8 masks its ragged last tile), so ``chunk``,
    kept for the reference's signature, changes nothing."""
    b, s, h, hd = r.shape
    y, s_final = wkv6_bh(*bh_layout(r, k, v, w, u, state))
    return y.reshape(b, h, s, hd).transpose(1, 2), s_final.reshape(b, h, hd, hd)


def bh_layout(r, k, v, w, u, state):
    """The contiguous float32 (BH, S, hd) r, k, v, w, (BH, hd) u and
    (BH, hd, hd) state that ``wkv6`` hands K8: heads
    moved next to the batch, u repeated over the batch."""
    b, s, h, hd = r.shape

    def fold(a):
        return a.float().transpose(1, 2).reshape(b * h, s, hd).contiguous()

    uf = u.float()[None].expand(b, h, hd).reshape(b * h, hd).contiguous()
    sf = state.float().reshape(b * h, hd, hd).contiguous()
    return fold(r), fold(k), fold(v), fold(w), uf, sf
