"""Plain-torch oracle for the WKV6 recurrence kernel — the twin of
``repro.kernels.rwkv6_scan.ref.wkv6_reference``."""
from __future__ import annotations

import torch

__all__ = ["wkv6_reference"]


def wkv6_reference(r, k, v, w, u, state):
    """r,k,v,w: (BH, S, hd) float32; u: (BH, hd); state: (BH, hd, hd).

    y_t = r_t . (S_{t-1} + (u*k_t) v_t^T);  S_t = diag(w_t) S_{t-1} + k_t v_t^T
    Returns (y (BH, S, hd), final state)."""
    ys = []
    for t in range(r.shape[1]):
        rt, kt, vt, wt = r[:, t], k[:, t], v[:, t], w[:, t]  # (BH, hd)
        kv = kt[..., :, None] * vt[..., None, :]
        ys.append(torch.einsum("bi,bij->bj", rt, state + u[..., :, None] * kv))
        state = wt[..., :, None] * state + kv
    return torch.stack(ys, 1), state
