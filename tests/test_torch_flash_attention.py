"""K7, the flash attention kernel, on the CPU: the port's plain version
(``_flash_plain``, reached through ``flash_attention_bh`` on CPU tensors),
its GQA wrapper and its oracle twin against the reference's interpret-mode
Pallas kernel and jnp oracle, on the same numpy inputs.

Tolerances are the reference's own (``tests/test_kernels.py``): 2e-5 in
float32, where both sides run the same online softmax in another
summation order; 2e-2 in bfloat16, where both round the float32 result to
bfloat16 (one ulp apart at most) and the oracle also rounds its scores.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.flash_attention import (
    flash_attention_bh as ref_flash_bh,
)
from repro.kernels.flash_attention.ops import (
    flash_attention as ref_flash_attention,
)
from repro.kernels.flash_attention.ops import (
    flash_attention_reference as ref_flash_attention_reference,
)
from repro.kernels.flash_attention.ref import mha_reference as ref_mha
from repro_torch.kernels.flash_attention import flash_attention as fa
from repro_torch.kernels.flash_attention.flash_attention import (
    flash_attention_bh,
)
from repro_torch.kernels.flash_attention.ops import (
    flash_attention,
    flash_attention_reference,
)
from repro_torch.kernels.flash_attention.ref import mha_reference

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(seed, shapes, dtype):
    """numpy float32 draws, handed to both packages in ``dtype`` (float32
    -> bfloat16 rounds to nearest even in both)."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    jx = [jnp.asarray(a, JNP[dtype]) for a in arrs]
    tx = [torch.from_numpy(a).to(TORCH[dtype]) for a in arrs]
    return jx, tx


def _close(got: torch.Tensor, want, tol):
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want, np.float32), atol=tol, rtol=tol
    )


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", [32, 64, 128])
@pytest.mark.parametrize("s", [16, 128, 256, 200])
@pytest.mark.parametrize("window", [None, 16, 64])
def test_plain_matches_interpret_kernel(window, s, hd, dtype):
    """Causal, S == T.  At S = 200 the 128-row blocks are ragged: the
    interpret-mode kernel reads NaN padding into its last block and returns
    NaN rows there (a condition of the reference, ROADMAP Queue 3), so the
    port is held to the kernel on the whole blocks and to the oracle on
    every row."""
    (jq, jk, jv), (q, k, v) = _inputs(s * hd, [(2, s, hd)] * 3, dtype)
    got = flash_attention_bh(q, k, v, causal=True, window=window)
    assert got.dtype == TORCH[dtype] and got.shape == (2, s, hd)
    want = ref_flash_bh(jq, jk, jv, causal=True, window=window,
                        interpret=True)
    whole = s if s <= 128 else (s // 128) * 128
    _close(got[:, :whole], np.asarray(want, np.float32)[:, :whole], TOL[dtype])
    oracle = ref_mha(jq[None], jk[None], jv[None], True, window)[0]
    _close(got, oracle, TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [128, 256])
def test_non_causal_matches_oracle(s, dtype):
    (jq, jk, jv), (q, k, v) = _inputs(7, [(3, s, 64)] * 3, dtype)
    got = flash_attention_bh(q, k, v, causal=False)
    _close(got, ref_mha(jq[None], jk[None], jv[None], False)[0], TOL[dtype])
    want = ref_flash_bh(jq, jk, jv, causal=False, interpret=True)
    _close(got, want, TOL[dtype])


@pytest.mark.parametrize("s,t", [(128, 256), (256, 128)])
def test_s_not_t_is_left_aligned_like_the_kernel(s, t):
    """The kernel counts rows and columns from 0 (row r attends to columns
    <= r); the oracle right-aligns causal (row r sits at key position
    r + T - S), so the two differ when S != T.  The port follows the
    kernel; the model only ever passes S == T."""
    (jq, jk, jv), (q, k, v) = _inputs(3, [(2, s, 64), (2, t, 64),
                                          (2, t, 64)], "float32")
    got = flash_attention_bh(q, k, v, causal=True)
    want = ref_flash_bh(jq, jk, jv, causal=True, interpret=True)
    _close(got, want, TOL["float32"])
    oracle = np.asarray(ref_mha(jq[None], jk[None], jv[None], True)[0])
    assert not np.allclose(got.numpy(), oracle, atol=1e-3)


@pytest.mark.parametrize("block_q,block_k,window", [
    (64, 32, None), (32, 64, 16), (64, 64, 64),
])
def test_block_sizes_change_only_the_summation_order(block_q, block_k,
                                                     window):
    """The plain version at the reference's tile sizes meets the
    interpret-mode kernel at the same sizes, and K7's own 64 x 64 tiling
    (what ``flash_attention_bh`` runs on either device)."""
    (jq, jk, jv), (q, k, v) = _inputs(11, [(2, 256, 32)] * 3, "float32")
    got = fa._flash_plain(q, k, v, True, window, block_q, block_k)
    _close(got, flash_attention_bh(q, k, v, True, window), TOL["float32"])
    want = ref_flash_bh(jq, jk, jv, causal=True, window=window,
                        block_q=block_q, block_k=block_k, interpret=True)
    _close(got, want, TOL["float32"])


@pytest.mark.parametrize("kv", [1, 2, 8])
@pytest.mark.parametrize("window", [None, 64])
def test_gqa_wrapper_matches_reference(kv, window):
    b, s, h, hd = 2, 128, 8, 32
    (jq, jk, jv), (q, k, v) = _inputs(
        kv, [(b, s, h, hd), (b, s, kv, hd), (b, s, kv, hd)], "float32"
    )
    got = flash_attention(q, k, v, causal=True, window=window)
    assert got.shape == (b, s, h, hd)
    want = ref_flash_attention(jq, jk, jv, causal=True, window=window,
                               interpret=True)
    _close(got, want, TOL["float32"])
    oracle = ref_flash_attention_reference(jq, jk, jv, causal=True,
                                           window=window)
    _close(got, oracle, TOL["float32"])
    _close(flash_attention_reference(q, k, v, causal=True, window=window),
           oracle, TOL["float32"])


def test_first_row_attends_only_to_itself():
    (_, (q, k, v)) = _inputs(1, [(1, 128, 2, 64)] * 3, "float32")
    out = flash_attention(q, k, v, causal=True)
    np.testing.assert_allclose(out[0, 0].numpy(), v[0, 0].numpy(), atol=1e-5)


@pytest.mark.parametrize("causal,window,s,t", [
    (True, None, 64, 64), (True, 16, 64, 64), (False, None, 64, 64),
    (True, None, 32, 64), (True, 8, 48, 64),
])
def test_mha_reference_twin_matches_the_oracle(causal, window, s, t):
    (jq, jk, jv), (q, k, v) = _inputs(
        5, [(2, 3, s, 32), (2, 3, t, 32), (2, 3, t, 32)], "float32"
    )
    _close(mha_reference(q, k, v, causal, window),
           ref_mha(jq, jk, jv, causal, window), TOL["float32"])


def test_cpu_dispatch_runs_the_plain_version_and_counts_no_launch():
    (_, (q, k, v)) = _inputs(2, [(2, 64, 32)] * 3, "float32")
    fa.reset_launches()
    got = flash_attention_bh(q, k, v)
    assert torch.equal(got, fa._flash_plain(q, k, v))
    assert fa.LAUNCHES == {"flash": 0}
    with pytest.raises(TypeError, match="torch.Tensor"):
        flash_attention_bh(q.numpy(), k, v)
    with pytest.raises(ValueError, match="different devices"):
        flash_attention_bh(q, k.to("meta"), v)


@pytest.mark.parametrize("n_rep", [1, 2, 4, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_grouped_kv_heads_equal_repeated_ones(n_rep, dtype):
    """Query head b reads KV head b // n_rep: bit-equal to repeating each
    KV head n_rep times, as the reference's wrapper does."""
    bh, s, hd = 8, 96, 32
    (_, (q, k, v)) = _inputs(n_rep, [(bh, s, hd), (bh // n_rep, s, hd),
                                     (bh // n_rep, s, hd)], dtype)
    got = fa._flash_plain(q, k, v, True, 16, n_rep=n_rep)
    want = fa._flash_plain(q, k.repeat_interleave(n_rep, 0),
                           v.repeat_interleave(n_rep, 0), True, 16)
    assert torch.equal(got, want)
    assert torch.equal(fa._flash_attention_grouped(q, k, v, n_rep, True, 16),
                       want)


@pytest.mark.parametrize("kv", [1, 2, 8])
def test_gqa_wrapper_hands_the_kernel_unrepeated_kv(kv, monkeypatch):
    """``flash_attention`` gives K7 the (B * KV, T, hd) KV heads and
    n_rep = H / KV; nothing repeats them."""
    b, s, t, h, hd = 2, 64, 80, 8, 32
    (_, (q, k, v)) = _inputs(3, [(b, s, h, hd), (b, t, kv, hd),
                                 (b, t, kv, hd)], "float32")
    calls = []
    plain = fa._flash_plain

    def capture(q, k, v, causal, window, **kw):
        calls.append((q, k, v, kw))
        return plain(q, k, v, causal, window, **kw)

    monkeypatch.setattr(fa, "_flash_plain", capture)
    got = flash_attention(q, k, v, causal=True)
    (cq, ck, cv, kw), = calls
    assert tuple(cq.shape) == (b * h, s, hd)
    assert tuple(ck.shape) == tuple(cv.shape) == (b * kv, t, hd)
    assert kw == {"n_rep": h // kv}
    assert torch.equal(ck, k.transpose(1, 2).reshape(b * kv, t, hd))
    assert torch.equal(cv, v.transpose(1, 2).reshape(b * kv, t, hd))
    assert got.shape == (b, s, h, hd)


@pytest.mark.parametrize("b", [1, 2])
def test_gqa_wrapper_hands_the_kernel_contiguous_heads(b, monkeypatch):
    """What ``flash_attention`` hands K7 is contiguous, as K7 requires
    (it raises otherwise), at a batch of one too: there the reshape of
    the heads-first transpose is a view, not a copy (1 x 4,096 Hymba
    prefills raised on the card before it was made contiguous)."""
    s, h, kv, hd = 16, 8, 2, 32
    (_, (q, k, v)) = _inputs(4, [(b, s, h, hd), (b, s, kv, hd),
                                 (b, s, kv, hd)], "float32")
    calls = []
    plain = fa._flash_plain

    def capture(q, k, v, causal, window, **kw):
        calls.append((q, k, v))
        return plain(q, k, v, causal, window, **kw)

    monkeypatch.setattr(fa, "_flash_plain", capture)
    got = flash_attention(q, k, v, causal=True, window=8)
    (handed,) = calls
    assert all(t.is_contiguous() for t in handed)
    torch.testing.assert_close(got, flash_attention_reference(
        q, k, v, causal=True, window=8), rtol=TOL["float32"],
        atol=TOL["float32"])


def _split_p_flash(q, k, v, causal, window, n_rep=1, split=True,
                   block_q=128, block_k=128):
    """The bf16 tensor-core route's arithmetic on the CPU: its 128 x 128
    tiles, float32 scores of the bf16 inputs, the float32 online softmax
    with l summing float32 p, and P V as p_hi V + p_lo V with p_hi =
    bf16(p), p_lo = bf16(p - p_hi), each product exact in float32 (bf16
    times bf16) and summed in float32, and 0 for a row that keeps no key.
    ``split=False`` rounds p once."""
    bh, s, hd = q.shape
    t = k.shape[1]
    heads = torch.arange(bh) // n_rep
    pad = (0, 0, 0, -t % block_k)  # zero keys and values past T
    k = torch.nn.functional.pad(k.index_select(0, heads).float(), pad)
    v = torch.nn.functional.pad(v.index_select(0, heads).float(), pad)
    qf = q.float()
    rows = torch.arange(s)[:, None]
    q_start = (rows // block_q) * block_q
    m = torch.full((bh, s, 1), -1e30)
    l = torch.zeros((bh, s, 1))
    acc = torch.zeros((bh, s, hd))
    for k0 in range(0, t, block_k):
        run = torch.ones((s, 1), dtype=torch.bool)
        if causal:
            run &= k0 <= q_start + block_q - 1
        if window is not None:
            run &= q_start - (k0 + block_k - 1) < window
        cols = k0 + torch.arange(block_k)[None, :]
        kb, vb = k[:, k0:k0 + block_k], v[:, k0:k0 + block_k]
        sc = torch.matmul(qf, kb.transpose(1, 2)) * hd**-0.5
        keep = cols < t
        if causal:
            keep = keep & (rows >= cols)
        if window is not None:
            keep = keep & (rows - cols < window)
        sc = torch.where(keep, sc, -1e30)
        m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
        p = torch.exp(sc - m_new)
        alpha = torch.exp(m - m_new)
        p_hi = p.to(torch.bfloat16).float()
        pv = torch.matmul(p_hi, vb)
        if split:
            pv = pv + torch.matmul((p - p_hi).to(torch.bfloat16).float(), vb)
        m = torch.where(run, m_new, m)
        l = torch.where(run, alpha * l + p.sum(-1, keepdim=True), l)
        acc = torch.where(run, acc * alpha + pv, acc)
    out = torch.where(m == -1e30, 0.0, acc / torch.clamp(l, min=1e-30))
    return out.to(q.dtype)


#: chip_smoke.py's bf16 parity shapes at small BH: (BH, S, T, hd, window,
#: n_rep)
SPLIT_P_CASES = [
    (2, 256, 256, 128, None, 1), (2, 512, 512, 64, 64, 1),
    (2, 256, 256, 32, None, 1), (1, 2049, 2049, 128, None, 1),
    (1, 1000, 2048, 128, None, 1), (1, 2048, 1000, 128, None, 1),
    (2, 1024, 1500, 64, None, 1), (2, 1024, 1024, 128, 256, 1),
    (4, 512, 512, 128, None, 2), (4, 512, 512, 64, 100, 4),
    (1, 2048, 1000, 64, 64, 1),
]


@pytest.mark.parametrize("bh,s,t,hd,window,n_rep", SPLIT_P_CASES)
def test_split_p_meets_the_cards_bf16_tolerance(bh, s, t, hd, window,
                                               n_rep):
    """The tensor-core route's split P, rehearsed on the CPU, is within
    chip_smoke.py's bf16 tolerance of ``_flash_plain`` (rtol 2**-7, atol
    2e-5, both rounded to bf16); at the first shape P rounded once to bf16
    is not."""
    (_, (q, k, v)) = _inputs(bh * s + t + hd, [
        (bh, s, hd), (bh // n_rep, t, hd), (bh // n_rep, t, hd)], "bfloat16")
    want = fa._flash_plain(q, k, v, True, window, n_rep=n_rep).float()
    got = _split_p_flash(q, k, v, True, window, n_rep).float()
    assert bool(torch.isfinite(got).all())
    assert torch.allclose(got, want, rtol=2**-7, atol=2e-5), float(
        (got - want).abs().max())
    if (bh, s, t, hd) == SPLIT_P_CASES[0][:4]:
        once = _split_p_flash(q, k, v, True, window, n_rep, split=False)
        assert not torch.allclose(once.float(), want, rtol=2**-7, atol=2e-5)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("block_q,block_k", [
    (64, 64), (128, 128), (32, 64), (64, 128),
])
def test_rows_that_keep_no_key_are_zero_at_any_tiling(block_q, block_k,
                                                      causal):
    """S = 256 over T = 128 with a window of 16: rows 143 on keep no key
    (r - c < 16 needs c > r - 16 >= T - 1).  They are 0 whatever the tiles
    (the float32 route's 64 x 64, the bf16 route's 128 x 128); the rows
    that keep keys meet the interpret-mode kernel, left-aligned."""
    (jq, jk, jv), (q, k, v) = _inputs(13, [(2, 256, 32), (2, 128, 32),
                                           (2, 128, 32)], "float32")
    got = fa._flash_plain(q, k, v, causal, 16, block_q, block_k)
    assert torch.equal(got[:, 143:], torch.zeros_like(got[:, 143:]))
    assert bool(got[:, :143].abs().amax(-1).gt(0).all())
    _close(got, flash_attention_bh(q, k, v, causal, 16), TOL["float32"])
    want = ref_flash_bh(jq, jk, jv, causal=causal, window=16, interpret=True)
    _close(got[:, :143], np.asarray(want, np.float32)[:, :143],
           TOL["float32"])
