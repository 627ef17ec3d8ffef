"""K8, the WKV6 recurrence kernel, on the CPU: the port's plain version
(``_wkv6_plain``, reached through ``ops.wkv6`` / ``wkv6_scan`` on CPU
tensors), its oracle twin and the model's torch twins (``wkv_scan``,
``wkv_chunked``) against the reference's interpret-mode Pallas kernel, its
jnp oracle and its model twins, on the same numpy inputs.

Tolerances are the reference's own: atol = rtol = 1e-4 for the kernel
against its oracle (``tests/test_kernels.py``) and for the chunked twin
against the scan (``tests/test_perf_paths.py``), 1e-3 for the chunked twin
at the extreme decays.  Every comparison is float32; the two sides sum
the hd products of each step in other orders.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rwkv6_scan.ops import wkv6 as ref_wkv6
from repro.kernels.rwkv6_scan.ref import wkv6_reference as ref_wkv6_reference
from repro.models.rwkv6 import wkv_chunked as ref_wkv_chunked
from repro.models.rwkv6 import wkv_scan as ref_wkv_scan
from repro_torch.kernels.rwkv6_scan import rwkv6_scan as ws
from repro_torch.kernels.rwkv6_scan.ops import wkv6
from repro_torch.kernels.rwkv6_scan.ref import wkv6_reference
from repro_torch.models.rwkv6 import wkv_chunked, wkv_scan

TOL = 1e-4


def _inputs(seed, b, s, h, hd, decay="sigmoid", lw_hi=1.0):
    """numpy float32 r, k, v, w (B, S, H, hd), u (H, hd) ~ 0.1 N(0, 1) and
    a non-zero initial state (B, H, hd, hd) ~ 0.1 N(0, 1).  ``decay``:
    "sigmoid" as ``tests/test_kernels.py`` draws w; "loguniform" as
    ``tests/test_perf_paths.py`` does, w = exp(-exp(U(-6, lw_hi))) (lw_hi =
    2.5 puts w near 0, -6 near 1)."""
    rng = np.random.default_rng(seed)
    r, k, v, z = (rng.standard_normal((b, s, h, hd)).astype(np.float32)
                  for _ in range(4))
    if decay == "sigmoid":
        w = (1.0 / (1.0 + np.exp(-z))).astype(np.float32)
    else:
        logw = rng.uniform(-6.0, lw_hi, (b, s, h, hd)).astype(np.float32)
        w = np.exp(-np.exp(logw)).astype(np.float32)
    u = (rng.standard_normal((h, hd)) * 0.1).astype(np.float32)
    s0 = (rng.standard_normal((b, h, hd, hd)) * 0.1).astype(np.float32)
    return r, k, v, w, u, s0


def _t(arrs):
    return [torch.from_numpy(np.array(a)) for a in arrs]


def _fold(a):
    b, s, h, hd = a.shape
    return a.transpose(0, 2, 1, 3).reshape(b * h, s, hd)


def _close(got: torch.Tensor, want, tol=TOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


SHAPES = [(2, 128, 2, 32, 32), (1, 96, 4, 64, 32), (1, 64, 1, 16, 16),
          (2, 70, 2, 32, 32)]  # the last is ragged: the reference pads it


@pytest.mark.parametrize("b,s,h,hd,chunk", SHAPES)
def test_wkv6_matches_interpret_kernel_and_oracle(b, s, h, hd, chunk):
    arrs = _inputs(s * hd + h, b, s, h, hd)
    r, k, v, w, u, s0 = arrs
    y, sf = wkv6(*_t(arrs), chunk=chunk)
    assert y.shape == (b, s, h, hd) and y.dtype == torch.float32
    assert sf.shape == (b, h, hd, hd) and sf.dtype == torch.float32
    yk, sk = ref_wkv6(*(jnp.asarray(a) for a in arrs), chunk=chunk,
                      interpret=True)
    _close(y, yk)
    _close(sf, sk)
    uf = np.broadcast_to(u[None], (b, h, hd)).reshape(b * h, hd)
    yr, sr = ref_wkv6_reference(
        *(jnp.asarray(_fold(a)) for a in (r, k, v, w)), jnp.asarray(uf),
        jnp.asarray(s0.reshape(b * h, hd, hd)))
    _close(y, np.asarray(yr).reshape(b, h, s, hd).transpose(0, 2, 1, 3))
    _close(sf.reshape(b * h, hd, hd), sr)


@pytest.mark.parametrize("b,s,h,hd,chunk", SHAPES[:3])
def test_scan_entry_and_oracle_twin_match_reference_oracle(b, s, h, hd,
                                                           chunk):
    """``wkv6_scan`` on the (BH, S, hd) layout and the torch oracle twin
    against ``wkv6_reference``."""
    r, k, v, w, u, s0 = _inputs(7 + s, b, s, h, hd)
    folded = [_fold(a) for a in (r, k, v, w)]
    uf = np.ascontiguousarray(
        np.broadcast_to(u[None], (b, h, hd)).reshape(b * h, hd))
    sf = s0.reshape(b * h, hd, hd)
    yr, sr = ref_wkv6_reference(*(jnp.asarray(a) for a in (*folded, uf, sf)))
    args = _t([*folded, uf, sf])
    for y, st in (ws.wkv6_scan(*args, chunk=chunk), wkv6_reference(*args)):
        _close(y, yr)
        _close(st, sr)


def test_state_threading_across_chunks():
    """One 128-step call equals two chained 64-step calls (the reference's
    ``test_state_threading_across_chunks``), from a zero and from a
    non-zero initial state."""
    r, k, v, w, u, s0 = _t(_inputs(2, 1, 128, 2, 32))
    for init in (torch.zeros_like(s0), s0):
        y_full, s_full = wkv6(r, k, v, w, u, init, chunk=32)
        y1, s1 = wkv6(r[:, :64], k[:, :64], v[:, :64], w[:, :64], u, init,
                      chunk=32)
        y2, s2 = wkv6(r[:, 64:], k[:, 64:], v[:, 64:], w[:, 64:], u, s1,
                      chunk=32)
        _close(y_full, torch.cat([y1, y2], 1))
        _close(s_full, s2)


@pytest.mark.parametrize("s", [70, 2049])
def test_ragged_padding_leaves_the_state_unchanged(s):
    """A ragged S, which ``ops.wkv6`` runs unpadded, equals the time loop
    on the folded layout, and the reference's interpret-mode kernel, which
    pads it (w = 1, r = k = v = 0) and so leaves the state unchanged."""
    arrs = _inputs(s, 1, s, 2, 16)
    y, sf = wkv6(*_t(arrs), chunk=64)
    r, k, v, w, u, s0 = arrs
    folded = _t([_fold(a) for a in (r, k, v, w)])
    yp, sp = ws._wkv6_plain(*folded, torch.from_numpy(u),
                            torch.from_numpy(s0.reshape(2, 16, 16)))
    _close(y, yp.reshape(1, 2, s, 16).permute(0, 2, 1, 3))
    _close(sf.reshape(2, 16, 16), sp)
    if s == 70:
        yk, sk = ref_wkv6(*(jnp.asarray(a) for a in arrs), chunk=64,
                          interpret=True)
        _close(y, yk)
        _close(sf, sk)


@pytest.mark.parametrize("lw_hi", [1.0, 2.5])
def test_decay_range_matches_reference_scan(lw_hi):
    """w from exp(-exp(U(-6, lw_hi))): near 1 (the model's w0 = -5 gives
    w ~ 0.9933) down to near 0 at lw_hi = 2.5."""
    arrs = _inputs(1, 2, 64, 2, 32, decay="loguniform", lw_hi=lw_hi)
    y, sf = wkv6(*_t(arrs))
    yr, sr = ref_wkv_scan(*(jnp.asarray(a) for a in arrs))
    _close(y, yr)
    _close(sf, sr)
    assert bool(torch.isfinite(y).all())


def test_wkv6_scan_asserts_on_ragged_chunk():
    r = torch.zeros((2, 70, 16))
    u = torch.zeros((2, 16))
    s0 = torch.zeros((2, 16, 16))
    with pytest.raises(AssertionError, match="chunk multiple"):
        ws.wkv6_scan(r, r, r, r, u, s0, chunk=32)
    y, _ = ws.wkv6_scan(r, r, r, r, u, s0, chunk=70)  # chunk = min(chunk, S)
    assert y.shape == r.shape


@pytest.mark.parametrize("chunk", [8, 16, 32])
def test_torch_twins_match_reference_twins(chunk):
    """The model's ``wkv_scan`` and ``wkv_chunked`` against the
    reference's, on ``tests/test_perf_paths.py``'s inputs."""
    arrs = _inputs(0, 2, 64, 2, 8, decay="loguniform")
    ys, ss = wkv_scan(*_t(arrs))
    yc, sc = wkv_chunked(*_t(arrs), chunk=chunk)
    yr, sr = ref_wkv_scan(*(jnp.asarray(a) for a in arrs))
    ycr, scr = ref_wkv_chunked(*(jnp.asarray(a) for a in arrs), chunk=chunk)
    for got, want in ((ys, yr), (ss, sr), (yc, ycr), (sc, scr), (yc, yr),
                      (sc, sr)):
        _close(got, want)


def test_chunked_twin_stable_at_extreme_decay():
    arrs = _inputs(1, 2, 64, 2, 8, decay="loguniform", lw_hi=2.5)
    yc, _ = wkv_chunked(*_t(arrs), chunk=16)
    assert bool(torch.isfinite(yc).all())
    ys, _ = wkv_scan(*_t(arrs))
    _close(yc, ys, 1e-3)
    yr, _ = ref_wkv_chunked(*(jnp.asarray(a) for a in arrs), chunk=16)
    _close(yc, yr, 1e-3)


def test_launch_refuses_cpu_tensors_and_other_widths():
    r = torch.zeros((2, 8, 16))
    u = torch.zeros((2, 16))
    s0 = torch.zeros((2, 16, 16))
    ws.reset_launches()
    with pytest.raises(ValueError, match="CUDA"):
        ws._launch_wkv6(r, r, r, r, u, s0)
    assert ws.LAUNCHES == {"wkv6": 0}
    assert ws.HEAD_DIMS == (16, 32, 64)
    with pytest.raises(ValueError, match="different devices"):
        ws.wkv6_scan(r, r, r, r, u, s0.to("meta"))
