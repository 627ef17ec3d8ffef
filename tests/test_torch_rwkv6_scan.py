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


# ---------------------------------------------------------------------------
# K8 on the model's (B, S, H, hd) layout: ops.wkv6 hands it r, k, v in the
# model's type (bf16 or float32), w and the state float32, as they are
# ---------------------------------------------------------------------------

MODEL_SHAPES = [(2, 64, 3, 32, 32), (1, 70, 2, 64, 64), (2, 48, 2, 16, 16)]


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("b,s,h,hd,chunk", MODEL_SHAPES)
def test_ops_wkv6_model_layout_matches_interpret_kernel(b, s, h, hd, chunk,
                                                        dtype):
    """``ops.wkv6`` on (B, S, H, hd) r, k, v of the model's type (u too),
    float32 w and state, against the reference's ``ops.wkv6`` (interpret
    mode) on the same values; S = 70 is ragged (the reference pads it).
    y comes back float32 and contiguous in (B, S, H, hd)."""
    r, k, v, w, u, s0 = _inputs(3 * s + hd, b, s, h, hd)
    tdt = getattr(torch, dtype)
    rt, kt, vt, ut = (torch.from_numpy(a).to(tdt) for a in (r, k, v, u))
    y, sf = wkv6(rt, kt, vt, torch.from_numpy(w), ut, torch.from_numpy(s0),
                 chunk=chunk)
    assert y.shape == (b, s, h, hd) and y.dtype == torch.float32
    assert y.is_contiguous() and sf.shape == (b, h, hd, hd)
    same = [t.float().numpy() for t in (rt, kt, vt)]
    yk, sk = ref_wkv6(*(jnp.asarray(a) for a in (*same, w)),
                      jnp.asarray(ut.float().numpy()), jnp.asarray(s0),
                      chunk=chunk, interpret=True)
    _close(y, yk)
    _close(sf, sk)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_model_layout_twin_is_bh_layout_then_plain(dtype):
    """``_wkv6_model_plain`` (what ``ops.wkv6`` runs on the CPU) equals
    ``bh_layout`` -> ``_wkv6_plain`` -> unfold, bit for bit."""
    b, s, h, hd = 2, 37, 3, 16
    r, k, v, w, u, s0 = _inputs(11, b, s, h, hd)
    args = (*(torch.from_numpy(a).to(dtype) for a in (r, k, v)),
            torch.from_numpy(w), torch.from_numpy(u), torch.from_numpy(s0))
    y, sf = ws._wkv6_model_plain(*args)
    yp, sp = ws._wkv6_plain(*ws.bh_layout(*args))
    assert y.is_contiguous()
    assert torch.equal(y, yp.reshape(b, h, s, hd).transpose(1, 2))
    assert torch.equal(sf, sp.reshape(b, h, hd, hd))


# chip_smoke.py's K8 tolerance, (atol, rtol), and the row groups a (b, h)'s
# state is split into (hd / rows per thread: 8 at hd 16, 32 and 64)
WKV_TOL = (1e-4, 1e-4)
ROW_GROUPS = 8


def _k8_rehearsal(r, k, v, w, u, state):
    """K8's arithmetic in plain float32 torch on (BH, S, hd): the bonus
    factored out (a_t = sum_i r_i u_i k_i, added as v_j a_t), steps in
    pairs over the state before the pair (y_1 = r_1 . S, y_2 = (r_2 w_1)
    . S + (r_2 . k_1) v_1, S <- (w_1 w_2) S + (k_1 w_2) v_1 + k_2 v_2), a
    ragged S padded with w = 1, r = k = v = 0, and each y the sum of its
    ROW_GROUPS partials in group order, then + v a, then + v_1 c."""
    bh, s, hd = r.shape
    if s % 2:
        pad = [torch.zeros((bh, 1, hd)) for _ in range(3)]
        r, k, v = (torch.cat([a, z], 1) for a, z in zip((r, k, v), pad))
        w = torch.cat([w, torch.ones((bh, 1, hd))], 1)
    rows = hd // ROW_GROUPS
    a = (r * u[:, None] * k).sum(-1)  # (BH, S') bonus of each step

    def partial_sum(x, st):  # sum over row groups, in group order
        parts = (x[..., None] * st).reshape(bh, ROW_GROUPS, rows, hd).sum(2)
        y = parts[:, 0]
        for g in range(1, ROW_GROUPS):
            y = y + parts[:, g]
        return y

    ys = []
    for t in range(0, r.shape[1], 2):
        r1, r2, k1, k2 = r[:, t], r[:, t + 1], k[:, t], k[:, t + 1]
        v1, v2, w1, w2 = v[:, t], v[:, t + 1], w[:, t], w[:, t + 1]
        c = (r2 * k1).sum(-1)
        ys.append(partial_sum(r1, state) + v1 * a[:, t, None])
        ys.append(partial_sum(r2 * w1, state) + v2 * a[:, t + 1, None]
                  + v1 * c[:, None])
        kv = (k1 * w2)[..., None] * v1[:, None] + k2[..., None] * v2[:, None]
        state = (w1 * w2)[..., None] * state + kv
    return torch.stack(ys, 1)[:, :s], state


#: chip_smoke.py's WKV_PARITY_CASES without the chunk: (BH, S, hd, initial
#: state, decays)
REHEARSAL_CASES = [
    (8, 128, 64, "zero", "model"), (8, 2049, 64, "state", "model"),
    (8, 64, 64, "state", "extreme"), (8, 128, 32, "state", "extreme"),
    (8, 70, 32, "zero", "extreme"), (8, 64, 16, "state", "model"),
    (4, 2049, 16, "zero", "extreme"),
]


@pytest.mark.parametrize("bh,s,hd,init,decay", REHEARSAL_CASES)
def test_kernel_arithmetic_meets_the_cards_tolerance(bh, s, hd, init, decay):
    """K8's arithmetic (factored bonus, step pairs, partials summed by row
    group), rehearsed in float32 on the CPU at chip_smoke.py's parity
    inputs, is within WKV_TOL of ``_wkv6_plain``, y and final state; the
    extreme decays (log w up to 2.5, w near 0) included."""
    rng = np.random.default_rng(bh * s + hd)
    r, k, v = (torch.from_numpy(rng.standard_normal((bh, s, hd)).astype(
        np.float32)) for _ in range(3))
    hi = -4.0 if decay == "model" else 2.5
    logw = rng.uniform(-6.0, hi, (bh, s, hd)).astype(np.float32)
    w = torch.from_numpy(np.exp(-np.exp(logw)).astype(np.float32))
    u = torch.from_numpy((0.1 * rng.standard_normal((bh, hd))).astype(
        np.float32))
    s0 = torch.zeros((bh, hd, hd))
    if init == "state":
        s0 = torch.from_numpy((0.1 * rng.standard_normal(
            (bh, hd, hd))).astype(np.float32))
    got = _k8_rehearsal(r, k, v, w, u, s0)
    want = ws._wkv6_plain(r, k, v, w, u, s0)
    atol, rtol = WKV_TOL
    for g, wt in zip(got, want):
        assert bool(torch.isfinite(g).all())
        assert torch.allclose(g, wt, atol=atol, rtol=rtol), float(
            (g - wt).abs().max())


def _model_args(dtype=torch.bfloat16, b=2, s=8, h=3, hd=16):
    rkv = [torch.zeros((b, s, h, hd), dtype=dtype) for _ in range(3)]
    return [*rkv, torch.zeros((b, s, h, hd)), torch.zeros((h, hd)),
            torch.zeros((b, h, hd, hd))]


def _refusals():
    """(what, change to the model-layout arguments, expected message)."""
    def swap(i, t):
        def change(args):
            args[i] = t
            return args
        return change

    def strided(args):  # (B, S, H, hd) as a transposed (B, H, S, hd) view
        args[0] = torch.zeros((2, 3, 8, 16), dtype=torch.bfloat16
                              ).transpose(1, 2)
        return args

    return [
        ("r-float16", swap(0, torch.zeros((2, 8, 3, 16),
                                          dtype=torch.float16)), "dtype"),
        ("k-other-type", swap(1, torch.zeros((2, 8, 3, 16))), "dtype"),
        ("w-bfloat16", swap(3, torch.zeros((2, 8, 3, 16),
                                           dtype=torch.bfloat16)), "dtype"),
        ("u-bfloat16", swap(4, torch.zeros((3, 16), dtype=torch.bfloat16)),
         "dtype"),
        ("state-bfloat16", swap(5, torch.zeros((2, 3, 16, 16),
                                               dtype=torch.bfloat16)),
         "dtype"),
        ("r-not-contiguous", strided, "contiguous"),
        ("v-not-contiguous", swap(2, torch.zeros(
            (2, 8, 3, 32), dtype=torch.bfloat16)[..., ::2]), "contiguous"),
        ("u-per-batch-rows", swap(4, torch.zeros((6, 16))), "shape"),
        ("state-folded", swap(5, torch.zeros((6, 16, 16))), "shape"),
        ("head-dim-48", lambda a: _model_args(hd=48), "head_dim"),
        ("on-the-cpu", lambda a: a, "CUDA"),
    ]


@pytest.mark.parametrize("what,change,match", _refusals(),
                         ids=[c[0] for c in _refusals()])
def test_launch_refuses_model_layout_tensors_it_does_not_take(what, change,
                                                              match):
    """The launch takes the model's tensors as they are or raises before
    any launch: another type, a view that is not contiguous or another
    shape is refused, never copied; well-formed CPU tensors are refused
    for their device."""
    ws.reset_launches()
    with pytest.raises(ValueError, match=match):
        ws._launch_wkv6(*change(_model_args()))
    assert ws.LAUNCHES == {"wkv6": 0}
