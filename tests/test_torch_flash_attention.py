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
