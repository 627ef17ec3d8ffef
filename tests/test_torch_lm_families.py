"""The LM substrate's other families in the port on the CPU: Hymba (GQA
attention beside a selective SSM), Granite-MoE (GQA + MoE) and
DeepSeek-V3 (MLA + MoE with dense leading layers and an MTP head), each
at its smoke config in float32 with the reference's own weights carried
across by ``lm_params_from_arrays``, the same numpy tokens through both
packages; then the new functions alone (``chunked_attention``,
``selective_scan``, the MoE dispatch) against the reference's.

Everything is held at atol = rtol = 1e-4 (``TOL``), as in
``tests/test_torch_lm.py``: XLA's and torch's CPU matmuls and the scan's
fused multiply-adds round in other places (the measured gaps are ~5e-6).
Prefill with ``use_flash=True`` runs the reference's interpret-mode
Pallas kernel and the port's K7 plain version for the GQA attention of
Hymba and Granite; MLA takes no kernel in either package.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import decode_step as ref_decode_step
from repro.models import forward as ref_forward
from repro.models import init_params as ref_init_params
from repro.models import prefill as ref_prefill
from repro.models.attention import _attend_full as ref_attend_full
from repro.models.blockwise import chunked_attention as ref_chunked
from repro.models.moe import _moe_apply_dense as ref_moe_dense
from repro.models.ssm import selective_scan as ref_selective_scan
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_arrays
from repro_torch.models import (
    decode_step,
    forward,
    init_cache,
    init_params,
    prefill,
)
from repro_torch.models import moe as port_moe
from repro_torch.models.attention import _attend_full
from repro_torch.models.blockwise import chunked_attention
from repro_torch.models.ssm import selective_scan

TOL = 1e-4
B, S = 2, 16
HYMBA, GRANITE, DSV3 = "hymba-1.5b", "granite-moe-3b-a800m", "deepseek-v3-671b"
FAMILIES = [HYMBA, GRANITE, DSV3]


class _Pair:
    """One config in both packages: the reference's params and jitted
    decode step, and the port's ``TransformerLM`` holding the same
    numbers.  ``dropless`` sets an MoE config's capacity factor to E / k,
    so no assignment overflows (the reference's own decode test)."""

    def __init__(self, name, window=0, dropless=False):
        self.ref_cfg = ref_get_config(name).smoke()
        self.cfg = get_config(name).smoke()
        changes = {}
        if window:
            changes["sliding_window"] = window
        if dropless and self.cfg.mlp_type == "moe":
            changes["capacity_factor"] = (self.cfg.n_experts
                                          / self.cfg.top_k)
        self.ref_cfg = dataclasses.replace(self.ref_cfg, **changes)
        self.cfg = dataclasses.replace(self.cfg, **changes)
        self.ref_params = ref_init_params(self.ref_cfg, jax.random.PRNGKey(0))
        self.arrays = jax.tree.map(np.asarray, self.ref_params)
        self.lm = lm_params_from_arrays(self.cfg, self.arrays, device="cpu")
        rng = np.random.default_rng(1)
        self.tokens = rng.integers(0, self.cfg.vocab_size, (B, S)).astype(
            np.int32)
        self.ref_decode = jax.jit(functools.partial(ref_decode_step,
                                                    self.ref_cfg))

    def ref_prefill(self, max_len, use_flash, tokens=None):
        tokens = self.tokens if tokens is None else tokens
        return jax.jit(functools.partial(
            ref_prefill, self.ref_cfg, max_len=max_len, use_flash=use_flash
        ))(self.ref_params, tokens)

    def prefill(self, max_len, use_flash, tokens=None):
        tokens = self.tokens if tokens is None else tokens
        return prefill(self.cfg, self.lm, torch.from_numpy(tokens),
                       max_len=max_len, use_flash=use_flash)


@pytest.fixture(scope="module")
def pairs():
    cache = {}

    def get(name, window=0, dropless=False):
        key = (name, window, dropless)
        if key not in cache:
            cache[key] = _Pair(name, window, dropless)
        return cache[key]

    return get


def _close(got: torch.Tensor, want, what=""):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=TOL,
                               rtol=TOL, err_msg=what)


def _flat(tree, prefix=""):
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(_flat(val, f"{prefix}{key}."))
        else:
            out[f"{prefix}{key}"] = val
    return out


def _close_cache(cache, ref_cache, cfg):
    """Every leaf of every layer's cache, and ``pos``, against the
    reference's stacked cache; the layer lists split as the reference's
    ``layers_dense`` / ``layers``."""
    assert set(cache) == set(ref_cache)
    for key in ("layers_dense", "layers"):
        if key not in ref_cache:
            continue
        want = _flat(ref_cache[key])
        assert len(cache[key]) == len(next(iter(want.values())))
        for i, layer in enumerate(cache[key]):
            got = _flat(layer)
            assert set(got) == set(want), (key, i)
            for leaf, t in got.items():
                assert t.dtype == (torch.float32 if leaf in ("h", "ssm.h")
                                   else getattr(torch, cfg.dtype)), leaf
                _close(t, want[leaf][i], f"{key}[{i}].{leaf}")
    np.testing.assert_array_equal(cache["pos"].numpy(),
                                  np.asarray(ref_cache["pos"]))


# ---------------------------------------------------------------------------
# whole models
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", FAMILIES)
def test_forward_and_aux_match_reference(pairs, name):
    p = pairs(name)
    want, want_aux = ref_forward(p.ref_cfg, p.ref_params, p.tokens)
    got, aux = forward(p.cfg, p.lm, torch.from_numpy(p.tokens))
    assert got.shape == (B, S, p.cfg.vocab_size)
    _close(got, want)
    assert aux.dtype == torch.float32 and aux.shape == ()
    _close(aux, want_aux, "aux")
    assert (float(aux) > 0) == (p.cfg.mlp_type == "moe")


@pytest.mark.parametrize("use_flash", [True, False])
@pytest.mark.parametrize("name", FAMILIES)
def test_prefill_matches_reference(pairs, name, use_flash):
    """Last logits and every cache leaf (the ring of Hymba's window, the
    SSM's state and conv tail, MLA's latents, both layer lists of
    DeepSeek-V3), max_len > S."""
    p = pairs(name)
    want, ref_cache = p.ref_prefill(S + 4, use_flash)
    got, cache = p.prefill(S + 4, use_flash)
    assert got.shape == (B, p.cfg.vocab_size)
    _close(got, want)
    _close_cache(cache, ref_cache, p.cfg)


def _prompt(p, s):
    return p.tokens if s == S else np.random.default_rng(2).integers(
        0, p.cfg.vocab_size, (B, s)).astype(np.int32)


def _greedy(p, steps, use_flash=True, s=S):
    """Prefill, then ``steps`` greedy decode steps in both packages, both
    fed the reference's tokens; checks logits, tokens and the caches."""
    tokens = _prompt(p, s)
    want, ref_cache = p.ref_prefill(s + steps, use_flash, tokens)
    got, cache = p.prefill(s + steps, use_flash, tokens)
    _close(got, want)
    _close_cache(cache, ref_cache, p.cfg)
    for step in range(steps):
        tok = np.asarray(jnp.argmax(want, -1)).astype(np.int32)
        assert np.array_equal(got.argmax(-1).numpy(), tok), step
        want, ref_cache = p.ref_decode(p.ref_params, tok, ref_cache)
        got, cache = decode_step(p.cfg, p.lm, torch.from_numpy(tok), cache)
        _close(got, want, f"decode step {step}")
    _close_cache(cache, ref_cache, p.cfg)


@pytest.mark.parametrize("name", FAMILIES)
def test_greedy_decode_continues_like_reference(pairs, name):
    _greedy(pairs(name), 8)


def test_hymba_window_and_ring_buffer_wrap(pairs):
    """Window 64 < S = 128: K7's window on prefill (and the dense mask),
    a ring-buffer cache of 64 slots holding the prompt's tail, and 8
    decode steps that wrap it, beside the SSM state."""
    p = pairs(HYMBA, window=64)
    assert p.cfg.sliding_window == 64
    _greedy(p, 8, use_flash=True, s=128)
    want, ref_cache = p.ref_prefill(136, False, _prompt(p, 128))
    got, cache = p.prefill(136, False, _prompt(p, 128))
    _close(got, want)
    _close_cache(cache, ref_cache, p.cfg)
    assert cache["layers"][0]["kv"]["k"].shape[1] == 64


@pytest.mark.parametrize("name", FAMILIES)
def test_decode_matches_forward(pairs, name):
    """Token-by-token decode from ``init_cache`` reproduces the
    teacher-forced forward logits (the reference's
    ``test_decode_matches_forward``, at its 2e-3), MoE configs dropless
    as there: capacity drops legitimately differ between a (B S) batch
    and a (B 1) one."""
    p = pairs(name, dropless=True)
    s = 10
    tokens = torch.from_numpy(p.tokens[:, :s])
    full, _ = forward(p.cfg, p.lm, tokens)
    cache = init_cache(p.cfg, B, max_len=s, device="cpu")
    assert ("layers_dense" in cache) == (name == DSV3)
    got = []
    for t in range(s):
        lg, cache = decode_step(p.cfg, p.lm, tokens[:, t], cache)
        got.append(lg)
    np.testing.assert_allclose(torch.stack(got, 1).numpy(), full.numpy(),
                               rtol=2e-3, atol=2e-3)


def test_deepseek_v3_long_prompt_takes_mla_chunked_path(pairs):
    """B = 1, S = 4,096: both packages' MLA takes its chunked online
    softmax (4 chunks of 1,024; the reference pairs them); every position's
    logits, the aux loss, and the prefill's latent caches agree."""
    p = pairs(DSV3)
    tokens = np.random.default_rng(3).integers(
        0, p.cfg.vocab_size, (1, 4096)).astype(np.int32)
    want, want_aux = jax.jit(functools.partial(ref_forward, p.ref_cfg))(
        p.ref_params, tokens)
    got, aux = forward(p.cfg, p.lm, torch.from_numpy(tokens))
    _close(got, want)
    _close(aux, want_aux, "aux")
    want, ref_cache = p.ref_prefill(4096, False, tokens)
    got, cache = prefill(p.cfg, p.lm, torch.from_numpy(tokens),
                         max_len=4096)
    _close(got, want)
    _close_cache(cache, ref_cache, p.cfg)


# ---------------------------------------------------------------------------
# the new functions alone
# ---------------------------------------------------------------------------
# (B, S, T, H, KV, hd, hd_v, causal, window, q_chunk, kv_chunk), named by
# the reference's schedule: paired (S = T, even chunk count, no window),
# the padded block table (odd chunk count; windows cutting blocks; cross
# attention S != T).  The port walks each row's live blocks for all.
CHUNKED_CASES = [
    ("paired-nq4-hdv48", 2, 128, 128, 4, 2, 32, 48, True, 0, 32, 32),
    ("paired-nq2-mha", 1, 128, 128, 3, 3, 16, 16, True, 0, 64, 64),
    ("table-nq3-causal", 2, 96, 96, 4, 1, 32, 32, True, 0, 32, 32),
    ("table-window40-c16", 2, 128, 128, 4, 2, 32, 24, True, 40, 16, 16),
    ("table-window64-c64", 1, 256, 256, 2, 1, 16, 16, True, 64, 64, 64),
    ("table-window20-qc32-kc16", 1, 128, 128, 2, 2, 16, 16, True, 20, 32,
     16),
    ("table-cross-s64-t128", 2, 64, 128, 4, 2, 32, 32, False, 0, 32, 64),
    ("table-cross-window", 1, 64, 128, 2, 1, 16, 40, False, 48, 16, 32),
]


@pytest.mark.parametrize("case", CHUNKED_CASES, ids=lambda c: c[0])
def test_chunked_attention_matches_reference(case):
    _, b, s, t, h, kv, hd, hd_v, causal, window, qc, kc = case
    rng = np.random.default_rng(5)
    q = rng.standard_normal((b, s, h, hd)).astype(np.float32)
    k = rng.standard_normal((b, t, kv, hd)).astype(np.float32)
    v = rng.standard_normal((b, t, kv, hd_v)).astype(np.float32)
    kw = dict(causal=causal, window=window, q_chunk=qc, kv_chunk=kc)
    want = ref_chunked(q, k, v, **kw)
    got = chunked_attention(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), **kw)
    assert got.shape == (b, s, h, hd_v) and got.dtype == torch.float32
    assert bool(torch.isfinite(got).all())
    _close(got, want)


@pytest.mark.parametrize("name", ["qwen3-4b", HYMBA])
def test_dense_attention_at_8192_takes_the_chunked_path(name):
    """Full-sequence GQA without flash at S = 8,192 (it raised before):
    the reference's chunked call, paired without a window (qwen3-4b's
    smoke heads) and the block table with Hymba's window of 64."""
    cfg = get_config(name).smoke()
    ref_cfg = ref_get_config(name).smoke()
    rng = np.random.default_rng(6)
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    q = rng.standard_normal((1, 8192, h, hd)).astype(np.float32)
    k = rng.standard_normal((1, 8192, kv, hd)).astype(np.float32)
    v = rng.standard_normal((1, 8192, kv, hd)).astype(np.float32)
    want = ref_attend_full(q, k, v, ref_cfg, False)
    got = _attend_full(torch.from_numpy(q), torch.from_numpy(k),
                       torch.from_numpy(v), cfg, False)
    _close(got, want)


@pytest.mark.parametrize("s", [48, 37, 1])
def test_selective_scan_matches_reference(s):
    """S a multiple of 16 (the reference's chunked scan), not (its plain
    scan), and one step (decode), from a non-zero state."""
    rng = np.random.default_rng(7)
    b, di, st = 2, 24, 8
    u = rng.standard_normal((b, s, di)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, di)))).astype(np.float32)
    bm = rng.standard_normal((b, s, st)).astype(np.float32)
    cm = rng.standard_normal((b, s, st)).astype(np.float32)
    a = -np.exp(0.5 * rng.standard_normal((di, st))).astype(np.float32)
    d_skip = rng.standard_normal(di).astype(np.float32)
    h0 = rng.standard_normal((b, di, st)).astype(np.float32)
    y_want, h_want = ref_selective_scan(u, dt, bm, cm, a, d_skip, h0)
    y, h = selective_scan(*(torch.from_numpy(x) for x in
                            (u, dt, bm, cm, a, d_skip, h0)))
    assert y.dtype == h.dtype == torch.float32
    _close(y, y_want, "y")
    _close(h, h_want, "h")


def _ref_keep(cfg, params, x):
    """The reference's routing lines (``_moe_apply_dense``, top-k through
    the token-major position count) on its own arrays: (flat_ids, keep)."""
    n = x.shape[0] * x.shape[1]
    e, k = cfg.n_experts, cfg.top_k
    xf = x.reshape(n, -1)
    probs = jax.nn.softmax(xf.astype(jnp.float32) @ params["router"], -1)
    _, top_ids = jax.lax.top_k(probs, k)
    capacity = max(int(n * k / e * cfg.capacity_factor), 1)
    flat_ids = top_ids.reshape(n * k)
    oh = jax.nn.one_hot(flat_ids, e, dtype=jnp.int32)
    pos = jnp.cumsum(oh, axis=0) - oh
    flat_pos = jnp.take_along_axis(pos, flat_ids[:, None], 1)[:, 0]
    return np.asarray(flat_ids), np.asarray(flat_pos < capacity)


@pytest.mark.parametrize("name", [GRANITE, DSV3])
def test_moe_dispatch_drops_the_same_assignments(pairs, name):
    """capacity_factor 0.5, so assignments overflow: the dropped (token,
    slot) set is the reference's, and so are the output (the shared
    expert included for DeepSeek-V3) and the aux loss."""
    p = pairs(name)
    ref_cfg = dataclasses.replace(p.ref_cfg, capacity_factor=0.5)
    cfg = dataclasses.replace(p.cfg, capacity_factor=0.5)
    rng = np.random.default_rng(8)
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    ref_p = jax.tree.map(lambda a: a[-1], p.ref_params["layers"]["mlp"])
    mod = p.lm.layers[-1].mlp
    want_ids, want_keep = _ref_keep(ref_cfg, ref_p, x)
    ids, _, keep, _, _, capacity = port_moe._route(
        mod, cfg, torch.from_numpy(x).reshape(B * S, -1))
    np.testing.assert_array_equal(ids.numpy(), want_ids)
    np.testing.assert_array_equal(keep.numpy(), want_keep)
    assert 0 < int((~keep).sum()) < keep.numel()
    assert int(keep.sum()) <= capacity * cfg.n_experts
    want, want_aux = ref_moe_dense(ref_p, ref_cfg, x)
    got, aux = port_moe._moe_apply_dense(mod, cfg, torch.from_numpy(x))
    _close(got, want)
    _close(aux, want_aux, "aux")


# ---------------------------------------------------------------------------
# parameters, init and the driver
# ---------------------------------------------------------------------------
# (family, dotted path of a leaf in the reference's numpy tree)
LEAVES = [
    (HYMBA, "layers.ssm.a_log"),
    (HYMBA, "layers.branch_beta"),
    (HYMBA, "layers.norm_ssm_out"),
    (GRANITE, "layers.mlp.router"),
    (GRANITE, "layers.mlp.w2"),
    (DSV3, "layers.mlp.shared.w1"),
    (DSV3, "layers.attn.w_uk"),
    (DSV3, "layers_dense.mlp.w1"),
    (DSV3, "layers_dense.attn.kv_norm"),
    (DSV3, "mtp.proj"),
    (DSV3, "mtp.block.attn.w_kr"),
]


def _edit(tree, path, how):
    *parents, leaf = path.split(".")
    node = tree
    for key in parents:
        node = node[key]
    if how == "missing":
        del node[leaf]
    elif how == "extra":
        node[leaf + "_extra"] = node[leaf]
    else:  # misshapen: one more row along the last axis
        a = node[leaf]
        node[leaf] = np.concatenate([a, a[..., :1]], -1)


@pytest.mark.parametrize("how", ["missing", "extra", "misshapen"])
@pytest.mark.parametrize("name,path", LEAVES)
def test_params_from_arrays_refuse_a_bad_leaf(pairs, name, path, how):
    p = pairs(name)
    arrays = jax.tree.map(lambda a: a, p.arrays)  # a new tree, same arrays
    _edit(arrays, path, how)
    with pytest.raises(ValueError, match="leaves" if how != "misshapen"
                       else "shape"):
        lm_params_from_arrays(p.cfg, arrays, device="cpu")


@pytest.mark.parametrize("name", FAMILIES)
def test_params_from_arrays_refuse_a_bad_top_level_key(pairs, name):
    p = pairs(name)
    extra = dict(p.arrays, layers_extra=p.arrays["layers"])
    with pytest.raises(ValueError, match="top-level"):
        lm_params_from_arrays(p.cfg, extra, device="cpu")
    missing = {k: v for k, v in p.arrays.items() if k != "final_norm"}
    with pytest.raises(ValueError, match="top-level"):
        lm_params_from_arrays(p.cfg, missing, device="cpu")


@pytest.mark.parametrize("name", FAMILIES)
def test_init_params_scales_and_seed(pairs, name):
    cfg = get_config(name).smoke()
    a = init_params(cfg, seed=3, device="cpu")
    b = init_params(cfg, seed=3, device="cpu")
    for (n, x), (_, y) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(x, y), n
        assert not x.requires_grad
    assert not torch.equal(a.embed, init_params(cfg, seed=4,
                                                device="cpu").embed)
    # the same parameter tree as the reference's
    want = {f"{k}": v.shape for k, v in _flat(pairs(name).arrays).items()}
    n_dense = len(a.layers_dense)
    got = {}
    for n, x in a.named_parameters():
        top, _, rest = n.partition(".")
        if top in ("layers", "layers_dense"):
            i, _, leaf = rest.partition(".")
            if i == "0":
                count = n_dense if top == "layers_dense" else len(a.layers)
                got[f"{top}.{leaf}"] = (count, *x.shape)
        else:
            got[n] = tuple(x.shape)
    assert got == want
    d = cfg.d_model
    blk = a.layers[0]
    if name == HYMBA:
        ssm = blk.ssm
        di = cfg.d_inner_
        assert abs(float(ssm.w_in.std()) - d**-0.5) < 0.1 * d**-0.5
        assert abs(float(ssm.w_dt.std()) - di**-0.5) < 0.1 * di**-0.5
        assert abs(float(ssm.conv_w.std()) - 0.5) < 0.1
        assert torch.equal(ssm.a_log, torch.zeros_like(ssm.a_log))
        assert torch.equal(ssm.d_skip, torch.ones_like(ssm.d_skip))
        assert torch.equal(blk.branch_beta, torch.ones(2))
    else:
        moe = blk.mlp
        assert moe.router.dtype == torch.float32
        assert abs(float(moe.w1.std()) - d**-0.5) < 0.1 * d**-0.5
        f = cfg.moe_d_ff
        assert abs(float(moe.w2.std()) - f**-0.5) < 0.1 * f**-0.5
    if name == DSV3:
        mla = blk.attn
        assert abs(float(mla.w_uk.std()) - cfg.kv_lora_rank**-0.5) < (
            0.1 * cfg.kv_lora_rank**-0.5)
        assert torch.equal(mla.kv_norm, torch.ones(cfg.kv_lora_rank))
        assert abs(float(a.mtp.proj.std()) - (2 * d) ** -0.5) < (
            0.1 * (2 * d) ** -0.5)
        assert a.mtp.block.mlp.w1.shape == (d, cfg.d_ff)


@pytest.mark.parametrize("name", FAMILIES)
def test_serve_driver_runs_in_process(capsys, name):
    from repro_torch.launch import serve

    argv = ["--arch", name, "--smoke", "--device", "cpu", "--temperature",
            "0", "--batch", "2", "--prompt-len", "16", "--gen", "4"]
    gen = serve.main(argv)
    out = capsys.readouterr().out
    assert f"arch={name} device=cpu prefill(2x16)" in out
    assert gen.shape == (2, 4)
    assert torch.equal(gen, serve.main(argv))
