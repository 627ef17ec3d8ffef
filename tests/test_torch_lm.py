"""LM serving in the port on the CPU: the dense-GQA and RWKV6 smoke
configs (the other families are in ``tests/test_torch_lm_families.py``) with the reference's own weights carried across by
``lm_params_from_arrays``, the same numpy tokens through both packages.

Smoke configs are float32.  Logits and caches are held to the reference
at atol = rtol = 1e-4: XLA's and torch's CPU matmuls sum in different
orders over 2 layers (the measured gap is ~5e-6).  Prefill with
``use_flash=True`` runs the reference's interpret-mode Pallas kernel and
the port's ``_flash_plain``; for RWKV6 it runs the port's K8 plain
version, held to the reference's own recurrence (its model never reaches
its Pallas kernel).  RWKV6's bonus ``u`` is 0 at init, so the RWKV6 cases
also run with ``u`` set from a seed in both packages.  The served
precision, bf16, is held to the reference's bf16 run by relative L2 error
against a witness the reference computes (see ``test_bf16_*`` and
``test_rwkv6_bf16_*``).
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
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_arrays
from repro_torch.models import (
    decode_step,
    forward,
    init_cache,
    init_params,
    prefill,
)

DENSE_GQA = ["qwen3-4b", "qwen2.5-3b", "starcoder2-3b", "deepseek-7b",
             "musicgen-large", "internvl2-76b"]
TOL = 1e-4
B, S = 2, 16
S_LONG = 64  # RWKV6: the reference's chunked recurrence from 64 steps
RWKV = "rwkv6-1.6b"


class _Pair:
    """One config in both packages: the reference's params and jitted
    steps, and the port's ``TransformerLM`` holding the same numbers."""

    def __init__(self, name, window=0, dtype="float32", u_seed=None):
        self.ref_cfg = ref_get_config(name).smoke()
        self.cfg = get_config(name).smoke()
        if window:
            self.ref_cfg = dataclasses.replace(self.ref_cfg,
                                               sliding_window=window)
            self.cfg = dataclasses.replace(self.cfg, sliding_window=window)
        self.ref_cfg = dataclasses.replace(self.ref_cfg, dtype=dtype)
        self.cfg = dataclasses.replace(self.cfg, dtype=dtype)
        self.ref_params = ref_init_params(self.ref_cfg, jax.random.PRNGKey(0))
        if u_seed is not None:  # RWKV6's bonus, 0 at init
            attn = self.ref_params["layers"]["attn"]
            u = np.random.default_rng(u_seed).standard_normal(attn["u"].shape)
            attn["u"] = jnp.asarray(0.1 * u, attn["u"].dtype)
        self.lm = lm_params_from_arrays(
            self.cfg, jax.tree.map(np.asarray, self.ref_params), device="cpu"
        )
        rng = np.random.default_rng(1)
        self.tokens = rng.integers(0, self.cfg.vocab_size, (B, S)).astype(
            np.int32
        )
        self.fe = None
        if self.cfg.frontend is not None and self.cfg.n_frontend_tokens:
            self.fe = rng.standard_normal(
                (B, self.cfg.n_frontend_tokens, self.cfg.d_model)
            ).astype(np.float32)
        self.tokens_long = rng.integers(
            0, self.cfg.vocab_size, (B, S_LONG)).astype(np.int32)
        self.ref_decode = jax.jit(functools.partial(ref_decode_step,
                                                    self.ref_cfg))

    def ref_prefill(self, max_len, use_flash, tokens=None):
        tokens = self.tokens if tokens is None else tokens
        return jax.jit(functools.partial(
            ref_prefill, self.ref_cfg, max_len=max_len, use_flash=use_flash
        ))(self.ref_params, tokens, self.fe)

    def prefill(self, max_len, use_flash, tokens=None):
        tokens = self.tokens if tokens is None else tokens
        fe = None if self.fe is None else torch.from_numpy(self.fe)
        return prefill(self.cfg, self.lm, torch.from_numpy(tokens), fe,
                       max_len=max_len, use_flash=use_flash)


@pytest.fixture(scope="module")
def pairs():
    cache = {}

    def get(name, window=0, dtype="float32", u_seed=None):
        key = (name, window, dtype, u_seed)
        if key not in cache:
            cache[key] = _Pair(name, window, dtype, u_seed)
        return cache[key]

    return get


def _close(got: torch.Tensor, want, what=""):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=TOL,
                               rtol=TOL, err_msg=what)


def _close_cache(cache, ref_cache, n_layers):
    assert len(cache["layers"]) == n_layers
    for i, layer in enumerate(cache["layers"]):
        for key in ("k", "v"):
            _close(layer[key], ref_cache["layers"][key][i], f"layer {i} {key}")
    np.testing.assert_array_equal(cache["pos"].numpy(),
                                  np.asarray(ref_cache["pos"]))
    assert cache["pos"].dtype == torch.int32


@pytest.mark.parametrize("name", DENSE_GQA)
def test_forward_matches_reference(pairs, name):
    p = pairs(name)
    want, _ = ref_forward(p.ref_cfg, p.ref_params, p.tokens, p.fe)
    fe = None if p.fe is None else torch.from_numpy(p.fe)
    got, aux = forward(p.cfg, p.lm, torch.from_numpy(p.tokens), fe)
    assert got.shape == (B, S, p.cfg.vocab_size) and float(aux) == 0.0
    _close(got, want)


@pytest.mark.parametrize("extra", [4, 0])
@pytest.mark.parametrize("use_flash", [True, False])
@pytest.mark.parametrize("name", DENSE_GQA)
def test_prefill_matches_reference(pairs, name, use_flash, extra):
    """Last logits and the decode cache, with max_len > S (zero-padded
    cache) and max_len = S."""
    p = pairs(name)
    want, ref_cache = p.ref_prefill(S + extra, use_flash)
    got, cache = p.prefill(S + extra, use_flash)
    assert got.shape == (B, p.cfg.vocab_size)
    _close(got, want)
    _close_cache(cache, ref_cache, p.cfg.n_layers)
    assert cache["layers"][0]["k"].shape == (
        B, S + extra, p.cfg.n_kv_heads, p.cfg.head_dim_
    )


def _greedy(p, steps, use_flash=True):
    """Prefill, then ``steps`` greedy decode steps in both packages, both
    fed the reference's tokens; checks logits, tokens and the caches."""
    want, ref_cache = p.ref_prefill(S + steps, use_flash)
    got, cache = p.prefill(S + steps, use_flash)
    for step in range(steps):
        tok = np.asarray(jnp.argmax(want, -1)).astype(np.int32)
        assert np.array_equal(got.argmax(-1).numpy(), tok), step
        want, ref_cache = p.ref_decode(p.ref_params, tok, ref_cache)
        got, cache = decode_step(p.cfg, p.lm, torch.from_numpy(tok), cache)
        _close(got, want, f"decode step {step}")
    _close_cache(cache, ref_cache, p.cfg.n_layers)


@pytest.mark.parametrize("name", DENSE_GQA)
def test_greedy_decode_continues_like_reference(pairs, name):
    _greedy(pairs(name), 6)


def test_sliding_window_flash_prefill_and_ring_decode(pairs):
    """window 8 < S = 16: K7's window on prefill (flash and dense), a
    ring-buffer cache of 8 slots, and decode steps that wrap it."""
    p = pairs("qwen3-4b", window=8)
    for use_flash in (True, False):
        want, ref_cache = p.ref_prefill(S + 4, use_flash)
        got, cache = p.prefill(S + 4, use_flash)
        _close(got, want)
        _close_cache(cache, ref_cache, p.cfg.n_layers)
        assert cache["layers"][0]["k"].shape[1] == 8
    _greedy(p, 10)


def _rel(got: torch.Tensor, want) -> float:
    """Relative L2 error of ``got`` against ``want``."""
    g = got.float().numpy()
    w = np.asarray(want, np.float32)
    return float(np.linalg.norm(g - w) / np.linalg.norm(w))


@pytest.mark.parametrize("name", DENSE_GQA)
def test_bf16_matches_reference_within_its_own_flash_dense_gap(pairs, name):
    """bf16, the precision the card serves, from the reference's own bf16
    weights.  The two packages round to bf16 at other points (XLA fuses an
    elementwise chain in float32 and rounds once, torch rounds after each
    op), so they cannot agree bit for bit.  The witness is the reference's
    own bf16 flash-against-dense gap on the same weights and tokens
    (1.0-1.3e-2 relative L2 over the six configs); the port's flash and
    dense prefill logits and caches, and 6 greedy decode steps fed the
    reference's tokens, stay within twice it of the reference's (the
    largest measured is 1.6x it, at a decode step), and every output keeps
    the reference's dtype."""
    p = pairs(name, dtype="bfloat16")
    steps = 6
    ref = {uf: p.ref_prefill(S + steps, uf) for uf in (True, False)}
    witness = _rel(torch.from_numpy(np.asarray(ref[True][0], np.float32)),
                   ref[False][0])
    assert 0.0 < witness < 3e-2, witness
    bound = 2 * witness
    for use_flash, (want, ref_cache) in ref.items():
        got, cache = p.prefill(S + steps, use_flash)
        assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
        assert _rel(got, want) <= bound, (use_flash, _rel(got, want), bound)
        for i, layer in enumerate(cache["layers"]):
            for key in ("k", "v"):
                assert layer[key].dtype == torch.bfloat16
                err = _rel(layer[key], ref_cache["layers"][key][i])
                assert err <= bound, (use_flash, i, key, err, bound)
    want, ref_cache = ref[True]
    got, cache = p.prefill(S + steps, True)
    for step in range(steps):
        tok = np.asarray(jnp.argmax(want, -1)).astype(np.int32)
        want, ref_cache = p.ref_decode(p.ref_params, tok, ref_cache)
        got, cache = decode_step(p.cfg, p.lm, torch.from_numpy(tok), cache)
        assert got.dtype == torch.bfloat16
        assert _rel(got, want) <= bound, (step, _rel(got, want), bound)


@pytest.mark.parametrize("name", DENSE_GQA)
def test_decode_matches_forward(pairs, name):
    """Token-by-token decode from an empty cache reproduces the
    teacher-forced forward logits (the reference's
    ``test_decode_matches_forward``, at its 2e-3)."""
    p = pairs(name)
    s = 10
    tokens = torch.from_numpy(p.tokens[:, :s])
    full, _ = forward(p.cfg, p.lm, tokens)
    cache = init_cache(p.cfg, B, max_len=s, device="cpu")
    got = []
    for t in range(s):
        lg, cache = decode_step(p.cfg, p.lm, tokens[:, t], cache)
        got.append(lg)
    np.testing.assert_allclose(torch.stack(got, 1).numpy(), full.numpy(),
                               rtol=2e-3, atol=2e-3)


def test_init_params_scales_and_seed():
    cfg = get_config("qwen3-4b").smoke()
    a = init_params(cfg, seed=3, device="cpu")
    b = init_params(cfg, seed=3, device="cpu")
    for (n, x), (_, y) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(x, y), n
        assert not x.requires_grad
    blk = a.layers[0]
    d = cfg.d_model
    assert abs(float(blk.attn.wq.std()) - d**-0.5) < 0.1 * d**-0.5
    assert abs(float(a.embed.std()) - 0.02) < 0.002
    assert torch.equal(blk.attn.q_norm, torch.ones(cfg.head_dim_))
    c = init_params(cfg, seed=4, device="cpu")
    assert not torch.equal(a.embed, c.embed)


def test_serve_driver_runs_in_process(capsys):
    from repro_torch.launch import serve

    gen = serve.main(["--arch", "qwen3-4b", "--smoke", "--device", "cpu",
                      "--temperature", "0", "--batch", "2",
                      "--prompt-len", "16", "--gen", "4"])
    out = capsys.readouterr().out
    assert "arch=qwen3-4b device=cpu prefill(2x16)" in out
    assert "sample token ids:" in out
    assert gen.shape == (2, 4)
    again = serve.main(["--arch", "qwen3-4b", "--smoke", "--device", "cpu",
                        "--temperature", "0", "--batch", "2",
                        "--prompt-len", "16", "--gen", "4"])
    assert torch.equal(gen, again)


# ---------------------------------------------------------------------------
# RWKV6 (rwkv6-1.6b's smoke config: 2 layers, d_model 128, 4 heads of 32)
# ---------------------------------------------------------------------------
U_SEEDS = [None, 3]  # u as initialised (0), and u ~ 0.1 N(0, 1) from seed 3


def _close_rwkv_cache(cache, ref_cache, n_layers):
    assert len(cache["layers"]) == n_layers
    for i, layer in enumerate(cache["layers"]):
        assert set(layer) == {"state", "x_prev_tm", "x_prev_cm"}
        assert layer["state"].dtype == torch.float32
        for key in ("state", "x_prev_tm", "x_prev_cm"):
            _close(layer[key], ref_cache["layers"][key][i], f"layer {i} {key}")
    np.testing.assert_array_equal(cache["pos"].numpy(),
                                  np.asarray(ref_cache["pos"]))


@pytest.mark.parametrize("u_seed", U_SEEDS)
def test_rwkv6_forward_matches_reference(pairs, u_seed):
    p = pairs(RWKV, u_seed=u_seed)
    for tokens in (p.tokens, p.tokens_long):
        want, _ = ref_forward(p.ref_cfg, p.ref_params, tokens)
        got, aux = forward(p.cfg, p.lm, torch.from_numpy(tokens))
        assert got.shape == (B, tokens.shape[1], p.cfg.vocab_size)
        _close(got, want)
        got, _ = forward(p.cfg, p.lm, torch.from_numpy(tokens),
                         use_flash=True)
        _close(got, want)


@pytest.mark.parametrize("u_seed", U_SEEDS)
@pytest.mark.parametrize("use_flash", [False, True])
@pytest.mark.parametrize("s", [S, S_LONG])
def test_rwkv6_prefill_matches_reference(pairs, s, use_flash, u_seed):
    """Last logits and the per-layer caches.  S = 16 is the reference's
    ``wkv_scan`` branch, S = 64 its ``wkv_chunked`` one; ``use_flash``
    sends the port's recurrence through K8's plain version instead."""
    p = pairs(RWKV, u_seed=u_seed)
    tokens = p.tokens if s == S else p.tokens_long
    want, ref_cache = p.ref_prefill(s + 4, False, tokens)
    got, cache = p.prefill(s + 4, use_flash, tokens)
    assert got.shape == (B, p.cfg.vocab_size)
    _close(got, want)
    _close_rwkv_cache(cache, ref_cache, p.cfg.n_layers)
    assert cache["layers"][0]["state"].shape == (
        B, p.cfg.n_heads, p.cfg.head_dim_, p.cfg.head_dim_)


@pytest.mark.parametrize("use_flash", [False, True])
def test_rwkv6_greedy_decode_continues_like_reference(pairs, use_flash):
    """Prefill, then 6 greedy decode steps fed the reference's tokens,
    with a non-zero ``u``; the states carried by decode match."""
    p = pairs(RWKV, u_seed=3)
    steps = 6
    want, ref_cache = p.ref_prefill(S + steps, False)
    got, cache = p.prefill(S + steps, use_flash)
    for step in range(steps):
        tok = np.asarray(jnp.argmax(want, -1)).astype(np.int32)
        assert np.array_equal(got.argmax(-1).numpy(), tok), step
        want, ref_cache = p.ref_decode(p.ref_params, tok, ref_cache)
        got, cache = decode_step(p.cfg, p.lm, torch.from_numpy(tok), cache)
        _close(got, want, f"decode step {step}")
    _close_rwkv_cache(cache, ref_cache, p.cfg.n_layers)


def test_rwkv6_decode_matches_forward(pairs):
    """Token-by-token decode from ``init_cache`` reproduces the
    teacher-forced forward logits (the reference's 2e-3)."""
    p = pairs(RWKV, u_seed=3)
    s = 10
    tokens = torch.from_numpy(p.tokens[:, :s])
    full, _ = forward(p.cfg, p.lm, tokens)
    cache = init_cache(p.cfg, B, max_len=s, device="cpu")
    assert cache["layers"][0]["x_prev_tm"].shape == (B, p.cfg.d_model)
    got = []
    for t in range(s):
        lg, cache = decode_step(p.cfg, p.lm, tokens[:, t], cache)
        got.append(lg)
    np.testing.assert_allclose(torch.stack(got, 1).numpy(), full.numpy(),
                               rtol=2e-3, atol=2e-3)


def test_rwkv6_bf16_within_twice_the_references_bf16_floor(pairs):
    """bf16, the served precision, from the reference's own bf16 weights
    with a non-zero ``u``.  The reference runs RWKV6 through one
    recurrence whatever ``use_flash`` says, so it has no flash-against-
    dense gap to serve as the witness; the witness is the reference's own
    bf16-against-float32 gap (the same bf16 weights upcast) on the last
    logits, bf16's rounding floor on this config (measured 1.6e-2).  The
    port's prefill logits and caches on both recurrences (scan at S = 16,
    K8's plain version), and 6 greedy decode steps fed the reference's
    tokens, stay within twice it of the reference's bf16 run (measured:
    logits 1.2e-2, caches at most 1.2e-2, decode at most 1.8e-2)."""
    p = pairs(RWKV, dtype="bfloat16", u_seed=3)
    steps = 6
    want, ref_cache = p.ref_prefill(S + steps, False)
    ref_cfg32 = dataclasses.replace(p.ref_cfg, dtype="float32")
    params32 = jax.tree.map(lambda a: a.astype(jnp.float32), p.ref_params)
    want32, _ = jax.jit(functools.partial(ref_prefill, ref_cfg32,
                                          max_len=S + steps))(params32,
                                                              p.tokens)
    witness = _rel(torch.from_numpy(np.asarray(want, np.float32)), want32)
    assert 0.0 < witness < 3e-2, witness
    bound = 2 * witness
    for use_flash in (False, True):
        got, cache = p.prefill(S + steps, use_flash)
        assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
        assert _rel(got, want) <= bound, (use_flash, _rel(got, want), bound)
        for i, layer in enumerate(cache["layers"]):
            for key in ("state", "x_prev_tm", "x_prev_cm"):
                err = _rel(layer[key], ref_cache["layers"][key][i])
                assert err <= bound, (use_flash, i, key, err, bound)
            assert layer["x_prev_tm"].dtype == torch.bfloat16
    got, cache = p.prefill(S + steps, True)
    for step in range(steps):
        tok = np.asarray(jnp.argmax(want, -1)).astype(np.int32)
        want, ref_cache = p.ref_decode(p.ref_params, tok, ref_cache)
        got, cache = decode_step(p.cfg, p.lm, torch.from_numpy(tok), cache)
        assert got.dtype == torch.bfloat16
        assert _rel(got, want) <= bound, (step, _rel(got, want), bound)


def test_rwkv6_init_params_scales_and_seed():
    cfg = get_config(RWKV).smoke()
    a = init_params(cfg, seed=3, device="cpu")
    b = init_params(cfg, seed=3, device="cpu")
    for (n, x), (_, y) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(x, y), n
    tm, cm = a.layers[0].attn, a.layers[0].mlp
    d, f = cfg.d_model, cfg.d_ff
    assert abs(float(tm.w_r.std()) - d**-0.5) < 0.1 * d**-0.5
    assert abs(float(tm.w_lora_a.std()) - 0.01) < 0.001
    assert abs(float(cm.w_v.std()) - f**-0.5) < 0.1 * f**-0.5
    assert torch.equal(tm.mu, torch.full((5, d), 0.5))
    assert torch.equal(cm.mu, torch.full((2, d), 0.5))
    assert torch.equal(tm.w0, torch.full((d,), -5.0))
    assert torch.equal(tm.u, torch.zeros(cfg.n_heads, cfg.head_dim_))
    assert torch.equal(tm.head_norm, torch.ones(cfg.head_dim_))


def test_rwkv6_params_carry_across_by_leaf_name(pairs):
    """The time-mix and channel-mix modules' parameter names are the
    reference's leaves; a missing leaf raises."""
    p = pairs(RWKV)
    layers = p.ref_params["layers"]
    assert {n for n, _ in p.lm.layers[0].attn.named_parameters()} == set(
        layers["attn"])
    assert {n for n, _ in p.lm.layers[0].mlp.named_parameters()} == set(
        layers["mlp"])
    arrays = jax.tree.map(np.asarray, p.ref_params)
    del arrays["layers"]["attn"]["u"]
    with pytest.raises(ValueError, match="leaves"):
        lm_params_from_arrays(p.cfg, arrays, device="cpu")


def test_rwkv6_serve_driver_runs_in_process(capsys):
    from repro_torch.launch import serve

    argv = ["--arch", RWKV, "--smoke", "--device", "cpu", "--temperature",
            "0", "--batch", "2", "--prompt-len", "64", "--gen", "4"]
    gen = serve.main(argv)
    out = capsys.readouterr().out
    assert "arch=rwkv6-1.6b device=cpu prefill(2x64)" in out
    assert gen.shape == (2, 4)
    assert torch.equal(gen, serve.main(argv))
