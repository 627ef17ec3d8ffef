"""LM training in the port on the CPU, held against the reference: the
kernels' refusal to be differentiated (F3), the losses, ``loss_fn`` and
its gradient for every family, ``mtp_loss``, remat, AdamW, gradient
compression with error feedback, the token pipeline, and a short
training run.  Checkpoints and the restartable loop are in
``tests/test_torch_checkpoint.py``.

The same numbers enter both packages: the reference's parameters carried
across by ``lm_params_from_arrays``, numpy-seeded tokens and gradients.
Smoke configs are float32; gradients are held at a relative L2 error of
1e-4 per leaf (XLA's and torch's CPU matmuls sum in different orders),
losses at 1e-5.  AdamW and the compression run the reference's
arithmetic: see each test for what is bit-equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import ARCHITECTURES
from repro.configs import get_config as ref_get_config
from repro.core.tensor_codec import flatten_pytree as ref_flatten
from repro.data.tokens import Prefetcher as RefPrefetcher
from repro.data.tokens import TokenDataConfig as RefTokenDataConfig
from repro.data.tokens import synth_batch as ref_synth_batch
from repro.models import init_params as ref_init_params
from repro.models import loss_fn as ref_loss_fn
from repro.models import mtp_loss as ref_mtp_loss
from repro.models.layers import chunked_ce_loss as ref_chunked_ce
from repro.models.layers import cross_entropy_loss as ref_ce
from repro.optim import adamw as ref_adamw
from repro.optim import compression as ref_comp
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_arrays
from repro_torch.core.tensor_codec import flatten_pytree
from repro_torch.data.tokens import Prefetcher, TokenDataConfig, synth_batch
from repro_torch.kernels import KernelGradientError
from repro_torch.launch.steps import make_train_step
from repro_torch.launch.train import build_state
from repro_torch.models import decode_step, init_cache, loss_fn, mtp_loss
from repro_torch.models import model as port_model
from repro_torch.models import prefill
from repro_torch.models.layers import (
    chunked_ce_loss,
    cross_entropy_loss,
    init_linear,
)
from repro_torch.models.model import reference_path
from repro_torch.optim import adamw
from repro_torch.optim import compression as comp
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.optim.compression import GradCompressionConfig

ARCHS = sorted(ARCHITECTURES)
B, S = 2, 16
GRAD_TOL = 1e-4
LOSS_TOL = 1e-5


def to_np(t: torch.Tensor) -> np.ndarray:
    """A CPU tensor as numpy, bfloat16 as ``ml_dtypes`` through its bits."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def rel_l2(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    den = np.linalg.norm(want)
    return float(np.linalg.norm(got - want) / den) if den else float(
        np.linalg.norm(got))


def port_grads(lm, loss) -> dict:
    names, plist = zip(*lm.named_parameters())
    grads = torch.autograd.grad(loss, plist, allow_unused=True,
                                materialize_grads=True)
    return dict(zip(names, grads))


def assert_grads_close(port: dict, ref_tree, tol=GRAD_TOL):
    """Every leaf of the reference's gradient pytree against the port's
    gradients stacked into its layout."""
    want = ref_flatten(jax.tree.map(np.asarray, ref_tree))
    got = {k: v.numpy() for k, v in flatten_pytree(port).items()}
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert rel_l2(got[k], want[k]) <= tol, (k, rel_l2(got[k], want[k]))


class _Pair:
    """One smoke config in both packages, the reference's weights in the
    port, and seeded tokens and labels."""

    def __init__(self, name, dtype="float32", seq=S):
        self.ref_cfg = dataclasses.replace(ref_get_config(name).smoke(),
                                           dtype=dtype)
        self.cfg = dataclasses.replace(get_config(name).smoke(), dtype=dtype)
        self.ref_params = ref_init_params(self.ref_cfg, jax.random.PRNGKey(0))
        self.lm = lm_params_from_arrays(
            self.cfg, jax.tree.map(np.asarray, self.ref_params), device="cpu")
        rng = np.random.default_rng(1)
        v = self.cfg.vocab_size
        self.tokens = rng.integers(0, v, (B, seq)).astype(np.int32)
        self.labels = rng.integers(0, v, (B, seq)).astype(np.int32)
        self.fe = None
        if self.cfg.frontend is not None and self.cfg.n_frontend_tokens:
            self.fe = rng.standard_normal(
                (B, self.cfg.n_frontend_tokens, self.cfg.d_model)
            ).astype(np.float32)


@pytest.fixture(scope="module")
def pairs():
    cache = {}

    def get(name, **kw):
        key = (name, tuple(sorted(kw.items())))
        if key not in cache:
            cache[key] = _Pair(name, **kw)
        return cache[key]

    return get


# ---------------------------------------------------------------------------
# F3: the kernels refuse autograd, as the reference's Pallas kernels do
# ---------------------------------------------------------------------------
def _flash_inputs(rng):
    q = rng.standard_normal((1, 64, 2, 32)).astype(np.float32)
    return (q,)


def _wkv_inputs(rng):
    r = rng.standard_normal((1, 64, 2, 16)).astype(np.float32)
    w = np.full((1, 64, 2, 16), 0.9, np.float32)
    u = np.zeros((2, 16), np.float32)
    st = np.zeros((1, 2, 16, 16), np.float32)
    return r, w, u, st


@pytest.mark.parametrize("kernel", ["flash", "wkv6"])
def test_kernel_routes_refuse_autograd(kernel):
    """``jax.grad`` through the reference's interpret-mode kernel raises;
    the port's entry raises ``KernelGradientError`` where autograd would
    differentiate it, on the CPU route and before any device dispatch
    (a ``meta`` tensor stands for the card's), and runs under
    ``torch.no_grad()``."""
    rng = np.random.default_rng(0)
    if kernel == "flash":
        from repro.kernels.flash_attention.ops import flash_attention as ref
        from repro_torch.kernels.flash_attention import flash_attention as fa
        from repro_torch.kernels.flash_attention.ops import flash_attention

        (q,) = _flash_inputs(rng)
        with pytest.raises(AssertionError):
            jax.grad(lambda x: ref(x, x, x, interpret=True).sum())(
                jnp.asarray(q))

        def port(x):
            return flash_attention(x, x, x)

        def bh(x):
            y = x.reshape(-1, *x.shape[-2:])
            return fa.flash_attention_bh(y, y, y)
    else:
        from repro.kernels.rwkv6_scan.ops import wkv6 as ref
        from repro_torch.kernels.rwkv6_scan import rwkv6_scan as ws
        from repro_torch.kernels.rwkv6_scan.ops import wkv6

        r, w, u, st = _wkv_inputs(rng)
        with pytest.raises(AssertionError):
            jax.grad(lambda x: ref(x, x, x, w, u, st, interpret=True)[0]
                     .sum())(jnp.asarray(r))

        def port(x):
            dev = x.device
            return wkv6(x, x, x, torch.from_numpy(w).to(dev),
                        torch.from_numpy(u).to(dev),
                        torch.from_numpy(st).to(dev))[0]

        def bh(x):
            dev = x.device
            y = x.reshape(-1, *x.shape[-2:])
            bhn, hd = y.shape[0], y.shape[-1]
            return ws.wkv6_bh(y, y, y, torch.full_like(y, 0.9),
                              torch.zeros((bhn, hd), device=dev),
                              torch.zeros((bhn, hd, hd), device=dev))[0]
        q = r

    x = torch.from_numpy(q).requires_grad_(True)
    for entry in (port, bh):
        with pytest.raises(KernelGradientError, match="no backward pass"):
            entry(x)
        with pytest.raises(KernelGradientError):
            entry(torch.empty(q.shape, device="meta", requires_grad=True))
        with torch.no_grad():
            assert torch.isfinite(entry(x)).all()
        assert torch.isfinite(entry(x.detach())).all()


def test_train_step_with_flash_refuses(pairs):
    """``use_flash=True`` in training reaches K7 and raises: the train
    path keeps ``use_flash=False``, as the reference's does."""
    p = pairs("qwen3-4b")
    opt_cfg = AdamWConfig(warmup_steps=1, total_steps=4)
    state = build_state(p.cfg, opt_cfg, 0, device="cpu")
    step = make_train_step(p.cfg, opt_cfg, remat=None, use_flash=True)
    batch = {"tokens": p.tokens, "labels": p.labels}
    with pytest.raises(KernelGradientError):
        step(state["params"], state["opt"], batch)
    assert not any(t.requires_grad for t in state["params"].parameters())


def test_serving_keeps_no_autograd_graph(pairs):
    """Prefill and decode run under ``no_grad``: parameters that require
    grad leave no graph behind, and the numbers do not move."""
    p = pairs("qwen3-4b")
    tokens = torch.from_numpy(p.tokens)
    want, cache = prefill(p.cfg, p.lm, tokens, max_len=S + 2)
    want_d, _ = decode_step(p.cfg, p.lm, tokens[:, -1], cache)
    p.lm.requires_grad_(True)
    try:
        got, cache = prefill(p.cfg, p.lm, tokens, max_len=S + 2)
        got_d, cache = decode_step(p.cfg, p.lm, tokens[:, -1], cache)
    finally:
        p.lm.requires_grad_(False)
    for t in (got, got_d, *cache["layers"][0].values()):
        assert not t.requires_grad and t.grad_fn is None
    assert torch.equal(got, want) and torch.equal(got_d, want_d)
    assert init_cache(p.cfg, B, 4, device="cpu")["pos"].grad_fn is None


# ---------------------------------------------------------------------------
# the losses
# ---------------------------------------------------------------------------
def test_cross_entropy_and_chunked_ce_match_reference():
    """Dense and chunked cross entropy, their values and their gradients
    (the head's and the hidden states'), against the reference's; the
    masked mean too (``test_system.py::test_chunked_ce_matches_dense``'s
    shapes)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 64, 16)).astype(np.float32)
    head = rng.standard_normal((16, 40)).astype(np.float32)
    labels = rng.integers(0, 40, (2, 64)).astype(np.int32)
    mask = (rng.random((2, 64)) > 0.3).astype(np.float32)

    def ref_dense(x, h):
        return ref_ce(jnp.einsum("bsd,dv->bsv", x, h), labels)

    def ref_chunk(x, h):
        return ref_chunked_ce(x, h, labels, chunk=16)

    xt = torch.from_numpy(x).requires_grad_(True)
    ht = torch.from_numpy(head).requires_grad_(True)
    lt = torch.from_numpy(labels)
    for ref_fn, port_fn in (
            (ref_dense, lambda: cross_entropy_loss(xt @ ht, lt)),
            (ref_chunk, lambda: chunked_ce_loss(xt, ht, lt, chunk=16))):
        want, (gx, gh) = jax.value_and_grad(ref_fn, argnums=(0, 1))(x, head)
        got = port_fn()
        got_gx, got_gh = torch.autograd.grad(got, (xt, ht))
        np.testing.assert_allclose(float(got.detach()), float(want),
                                   rtol=LOSS_TOL)
        assert rel_l2(got_gx, gx) <= GRAD_TOL
        assert rel_l2(got_gh, gh) <= GRAD_TOL
    want = ref_ce(jnp.einsum("bsd,dv->bsv", x, head), labels, mask)
    got = cross_entropy_loss(torch.from_numpy(x @ head), lt,
                             torch.from_numpy(mask))
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_TOL)


def test_init_linear_scale_and_generator():
    gen = torch.Generator().manual_seed(0)
    w = init_linear(gen, 256, 64, torch.bfloat16)
    assert w.shape == (256, 64) and w.dtype == torch.bfloat16
    assert abs(float(w.float().std()) - 256**-0.5) < 0.05 * 256**-0.5
    w2 = init_linear(torch.Generator().manual_seed(0), 256, 64,
                     torch.float32, scale=0.02)
    assert abs(float(w2.std()) - 0.02) < 0.002


@pytest.mark.parametrize("name", ARCHS)
def test_loss_fn_and_gradient_match_reference(pairs, name):
    """``loss_fn`` (dense cross entropy at S = 16, plus the MoE aux loss)
    and its gradient on every leaf, for every family's smoke config."""
    p = pairs(name)

    def ref_lf(params):
        return ref_loss_fn(p.ref_cfg, params, p.tokens, p.labels, p.fe)

    want, ref_g = jax.value_and_grad(ref_lf)(p.ref_params)
    p.lm.requires_grad_(True)
    try:
        fe = None if p.fe is None else torch.from_numpy(p.fe)
        got = loss_fn(p.cfg, p.lm, torch.from_numpy(p.tokens),
                      torch.from_numpy(p.labels), fe)
        grads = port_grads(p.lm, got)
    finally:
        p.lm.requires_grad_(False)
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_TOL)
    assert_grads_close(grads, ref_g)


@pytest.mark.parametrize("name", ["qwen3-4b", "granite-moe-3b-a800m",
                                  "hymba-1.5b", "rwkv6-1.6b",
                                  "deepseek-v3-671b"])
def test_remat_policies_give_equal_gradients(pairs, name):
    """``remat`` None, "full" and "dots" give the same loss and gradients
    bit for bit (the recompute is the forward's arithmetic), and "full"
    matches the reference's gradient under its own remat."""
    p = pairs(name)
    tokens, labels = torch.from_numpy(p.tokens), torch.from_numpy(p.labels)
    out = {}
    p.lm.requires_grad_(True)
    try:
        for remat in (None, "full", "dots"):
            loss = loss_fn(p.cfg, p.lm, tokens, labels, remat=remat)
            out[remat] = (loss.detach(), port_grads(p.lm, loss))
    finally:
        p.lm.requires_grad_(False)
    for remat in ("full", "dots"):
        assert torch.equal(out[remat][0], out[None][0])
        for n, g in out[None][1].items():
            assert torch.equal(out[remat][1][n], g), (remat, n)
    _, ref_g = jax.value_and_grad(lambda q: ref_loss_fn(
        p.ref_cfg, q, p.tokens, p.labels, remat="full"))(p.ref_params)
    assert_grads_close(out["full"][1], ref_g)


def test_loss_fn_chunks_from_2048_tokens(pairs, monkeypatch):
    """At S = 2,048 ``loss_fn`` takes ``chunked_ce_loss`` (4 chunks of
    512), and matches the reference's chunked loss and gradient."""
    p = pairs("qwen3-4b", seq=2048)
    calls = []
    real = port_model.chunked_ce_loss

    def spy(*a, **kw):
        calls.append(a[-1])
        return real(*a, **kw)

    monkeypatch.setattr(port_model, "chunked_ce_loss", spy)
    tokens, labels = p.tokens[:1], p.labels[:1]
    want, ref_g = jax.value_and_grad(lambda q: ref_loss_fn(
        p.ref_cfg, q, tokens, labels))(p.ref_params)
    p.lm.requires_grad_(True)
    try:
        got = loss_fn(p.cfg, p.lm, torch.from_numpy(tokens),
                      torch.from_numpy(labels), remat="full")
        grads = port_grads(p.lm, got)
    finally:
        p.lm.requires_grad_(False)
    assert calls == [512]
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_TOL)
    assert_grads_close(grads, ref_g)


def test_mtp_loss_matches_reference(pairs):
    """DeepSeek-V3's depth-1 MTP loss and its gradient (the MTP head's
    leaves included) against the reference's."""
    p = pairs("deepseek-v3-671b")
    l1 = np.roll(p.tokens, -1, 1)
    l2 = np.roll(p.tokens, -2, 1)
    want, ref_g = jax.value_and_grad(lambda q: ref_mtp_loss(
        p.ref_cfg, q, p.tokens, l1, l2))(p.ref_params)
    p.lm.requires_grad_(True)
    try:
        got = mtp_loss(p.cfg, p.lm, *(torch.from_numpy(a)
                                      for a in (p.tokens, l1, l2)))
        grads = port_grads(p.lm, got)
    finally:
        p.lm.requires_grad_(False)
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_TOL)
    assert_grads_close(grads, ref_g)
    assert float(grads["mtp.proj"].abs().sum()) > 0


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------
def _grad_trees(ref_params, seed: int, n: int):
    """``n`` seeded gradient pytrees shaped and typed like the params."""
    rng = np.random.default_rng(seed)
    return [jax.tree.map(
        lambda a: (rng.standard_normal(a.shape) * 0.05).astype(a.dtype),
        jax.tree.map(np.asarray, ref_params)) for _ in range(n)]


def _by_name(lm, tree) -> dict:
    """{port name: its slice of the reference-layout numpy ``tree``}."""
    out = {}
    for name, _ in lm.named_parameters():
        path, index = reference_path(name)
        leaf = tree
        for part in path.split("/"):
            leaf = leaf[part]
        leaf = np.asarray(leaf if index is None else leaf[index])
        t = (torch.from_numpy(leaf.view(np.int16).copy()).view(torch.bfloat16)
             if leaf.dtype == ml_dtypes.bfloat16 else torch.from_numpy(
                 leaf.copy()))
        out[name] = t
    return out


def _flat_np(tree) -> dict:
    return {k: to_np(v) for k, v in flatten_pytree(tree).items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_reference(pairs, dtype):
    """Three AdamW steps (warm-up, clipping active) on identical
    gradients: parameters and float32 moments against the reference's
    at rtol 1e-6 and the parameters bit for bit; step and lr equal; the
    global norm the correctly rounded one, which the reference's float32
    sum meets within 2e-6."""
    p = pairs("qwen3-4b", dtype=dtype)
    cfg = AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=6, clip_norm=0.5)
    ref_cfg = ref_adamw.AdamWConfig(**dataclasses.asdict(cfg))
    lm = lm_params_from_arrays(p.cfg, jax.tree.map(np.asarray, p.ref_params),
                               device="cpu")
    ref_params = p.ref_params
    ref_state = ref_adamw.init_opt_state(ref_params)
    state = adamw.init_opt_state(lm)
    assert state["m"]["embed"].dtype == lm.embed.dtype
    for g in _grad_trees(p.ref_params, 5, 3):
        ref_params, ref_state, ref_m = ref_adamw.adamw_update(
            ref_cfg, ref_params, g, ref_state)
        lm, state, m = adamw.adamw_update(cfg, lm, _by_name(lm, g), state)
        assert int(state["step"]) == int(ref_state["step"])
        assert float(m["lr"]) == float(ref_m["lr"])
        # the port's norm is the float64 sum rounded once; the reference's
        # float32 sum of the squares carries its own rounding (1.4e-6 at
        # the bfloat16 case), so the norm is held to that sum's error
        exact = np.sqrt(sum(np.sum(np.square(a.astype(np.float32)),
                                   dtype=np.float64)
                            for a in ref_flatten(g).values()))
        assert float(m["grad_norm"]) == float(np.float32(exact))
        np.testing.assert_allclose(float(ref_m["grad_norm"]), exact,
                                   rtol=2e-6)
        for got, want in ((lm, ref_params), (state["m"], ref_state["m"]),
                          (state["v"], ref_state["v"])):
            got, want = _flat_np(got), ref_flatten(
                jax.tree.map(np.asarray, want))
            for k in want:
                assert got[k].dtype == want[k].dtype, k
                np.testing.assert_allclose(
                    got[k].astype(np.float64), want[k].astype(np.float64),
                    rtol=1e-6, atol=0, err_msg=k)
        got, want = _flat_np(lm), ref_flatten(jax.tree.map(np.asarray,
                                                           ref_params))
        for k in want:
            assert np.array_equal(got[k].view(np.uint8),
                                  want[k].view(np.uint8)), k


def test_schedule_and_clip_match_reference():
    """The warm-up + cosine schedule at every step (bit-equal float32),
    and ``clip_by_global_norm``'s norm and scaled gradients."""
    cfg = AdamWConfig(lr=3e-4, warmup_steps=5, total_steps=40)
    ref_cfg = ref_adamw.AdamWConfig(**dataclasses.asdict(cfg))
    for step in range(0, 50):
        want = np.float32(ref_adamw.schedule(ref_cfg, jnp.int32(step)))
        got = adamw.schedule(cfg, torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    rng = np.random.default_rng(3)
    g = {"a": rng.standard_normal((32, 8)).astype(np.float32),
         "b": rng.standard_normal(100).astype(np.float32)}
    for max_norm in (0.1, 1e6, float("inf")):
        want, want_n = ref_adamw.clip_by_global_norm(g, max_norm)
        got, got_n = adamw.clip_by_global_norm(
            {k: torch.from_numpy(v) for k, v in g.items()}, max_norm)
        np.testing.assert_allclose(float(got_n), float(want_n), rtol=1e-6)
        for k in g:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=1e-6)


# ---------------------------------------------------------------------------
# gradient compression (§7 quantizer + error feedback)
# ---------------------------------------------------------------------------
def _within_one_fma(got, eager) -> bool:
    """The reconstruction ``lo + (q + 0.5) * step`` as one FMA (jitted, and
    the port) against the same rounded twice (eager): they differ by at
    most one rounding of the product, whose magnitude is at most ``hi -
    lo`` <= 2 max |x|."""
    bound = np.spacing(np.float32(2 * np.abs(eager).max()))
    return float(np.abs(got - eager).max()) <= bound


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_compress_gradients_matches_reference(pairs, bits):
    """Five steps with error feedback over qwen3-4b's smoke gradients
    (the stacked blocks of the reference share one (lo, step) a leaf):
    decoded gradients and error feedback bit-equal to the reference's
    function jitted, as its train step runs it (XLA divides, R5 does not
    apply, and fuses the reconstruction into one FMA).  Called eagerly
    the reference rounds the product too, at most one rounding of it
    away."""
    p = pairs("qwen3-4b")
    cfg = GradCompressionConfig(bits=bits)
    ref_cfg = ref_comp.GradCompressionConfig(bits=bits)
    ref_ef = ref_comp.init_error_feedback(p.ref_params)
    ef = comp.init_error_feedback(p.lm)
    jitted = jax.jit(lambda g, e: ref_comp.compress_gradients(ref_cfg, g, e))
    for g in _grad_trees(p.ref_params, bits, 5):
        eager, _ = ref_comp.compress_gradients(ref_cfg, g, ref_ef)
        want, want_ef = jitted(g, ref_ef)
        got, ef = comp.compress_gradients(cfg, _by_name(p.lm, g), ef)
        got_f, ef_f = _flat_np(got), _flat_np(ef)
        for k, w in ref_flatten(jax.tree.map(np.asarray, want)).items():
            assert np.array_equal(got_f[k], w), k
        for k, w in ref_flatten(jax.tree.map(np.asarray, want_ef)).items():
            assert np.array_equal(ef_f[k], w), k
        for k, w in ref_flatten(jax.tree.map(np.asarray, eager)).items():
            assert _within_one_fma(got_f[k], w), k
        ref_ef = want_ef
    assert comp.payload_bytes(p.lm, bits) == ref_comp.payload_bytes(
        p.ref_params, bits)
    off = GradCompressionConfig(bits=bits, enabled=False)
    g = _by_name(p.lm, _grad_trees(p.ref_params, 0, 1)[0])
    assert comp.compress_gradients(off, g, ef) == (g, ef)


def test_quantize_leaf_bin_edges_match_reference():
    """200,000 values with 5,000 on bin edges, at 2, 4 and 8 bits: the
    port's codes (a true division) and reconstruction are the reference's
    jitted, bit for bit, and within one rounding of the product of its
    eager ones."""
    rng = np.random.default_rng(4)
    for bits in (2, 4, 8):
        g = (rng.standard_normal(200_000) * 10 ** rng.uniform(-4, 1)
             ).astype(np.float32)
        n = 1 << bits
        step = np.float32(g.max() - g.min()) / np.float32(n)
        g[:5000] = g.min() + rng.integers(0, n, 5000).astype(np.float32) * step
        got = comp._quantize_leaf(torch.from_numpy(g), bits).numpy()
        jit_want = np.asarray(jax.jit(ref_comp._quantize_leaf,
                                      static_argnums=1)(jnp.asarray(g), bits))
        assert np.array_equal(got, jit_want), bits
        eager = np.asarray(ref_comp._quantize_leaf(jnp.asarray(g), bits))
        assert _within_one_fma(got, eager)


def test_error_feedback_preserves_signal():
    """The reference's ``test_error_feedback_preserves_signal`` on the
    port: the long-run sum of decoded gradients tracks the true sum."""
    cfg = GradCompressionConfig(bits=4)
    rng = np.random.default_rng(0)
    g_true = [{"w": torch.from_numpy(rng.normal(size=(32,)).astype(
        np.float32))} for _ in range(50)]
    ef = comp.init_error_feedback(g_true[0])
    total_dec = torch.zeros(32)
    total_true = torch.zeros(32)
    for g in g_true:
        dec, ef = comp.compress_gradients(cfg, g, ef)
        total_dec += dec["w"]
        total_true += g["w"]
    resid = (total_dec - total_true).abs().max()
    step_bound = torch.stack([g["w"] for g in g_true]).abs().max() / 4
    assert resid < step_bound


# ---------------------------------------------------------------------------
# token data
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("vocab,seq,batch,seed,hosts", [
    (512, 32, 4, 0, 1), (151936, 64, 2, 3, 1), (1024, 16, 8, 1, 2)])
def test_synth_batch_and_prefetcher_bit_equal(vocab, seq, batch, seed, hosts):
    """``synth_batch`` for several steps and hosts, and the first batches
    of a ``Prefetcher`` started mid-stream, equal the reference's."""
    for host in range(hosts):
        kw = dict(vocab_size=vocab, seq_len=seq, global_batch=batch,
                  seed=seed, n_hosts=hosts, host_id=host)
        cfg, ref_cfg = TokenDataConfig(**kw), RefTokenDataConfig(**kw)
        for step in (0, 1, 7, 1000):
            got, want = synth_batch(cfg, step), ref_synth_batch(ref_cfg, step)
            for k in ("tokens", "labels"):
                assert got[k].dtype == want[k].dtype
                assert np.array_equal(got[k], want[k])
        pf, ref_pf = Prefetcher(cfg, start_step=5), RefPrefetcher(
            ref_cfg, start_step=5)
        try:
            for _ in range(3):
                (s, got), (t, want) = pf.get(), ref_pf.get()
                assert s == t
                assert np.array_equal(got["tokens"], want["tokens"])
        finally:
            pf.close()
            ref_pf.close()
        assert not pf._thread.is_alive()


# ---------------------------------------------------------------------------
# the train step and a short run
# ---------------------------------------------------------------------------
def test_train_step_matches_reference_step(pairs):
    """One ``make_train_step`` step (remat "full") from the reference's
    weights on the same batch: loss, gradient norm, lr and the updated
    parameters against the reference's jitted step.  (Compression is held
    bit for bit on its own; here an 8-bit code that flips at a bin edge,
    where the gradients differ at 1e-4, would move its element by ~lr.)"""
    from repro.launch.steps import make_train_step as ref_make

    p = pairs("granite-moe-3b-a800m")
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=4)
    ref_opt = ref_adamw.AdamWConfig(**dataclasses.asdict(opt_cfg))
    batch = {"tokens": p.tokens, "labels": p.labels}
    ref_p, _, ref_m = jax.jit(ref_make(p.cfg, ref_opt, remat="full"))(
        p.ref_params, ref_adamw.init_opt_state(p.ref_params), batch)
    lm = lm_params_from_arrays(p.cfg, jax.tree.map(np.asarray, p.ref_params),
                               device="cpu")
    lm, state, m = make_train_step(p.cfg, opt_cfg, remat="full")(
        lm, adamw.init_opt_state(lm), batch)
    assert set(m) == set(ref_m) == {"loss", "grad_norm", "lr"}
    assert set(state) == {"m", "v", "step"}
    np.testing.assert_allclose(float(m["loss"]), float(ref_m["loss"]),
                               rtol=LOSS_TOL)
    np.testing.assert_allclose(float(m["grad_norm"]),
                               float(ref_m["grad_norm"]), rtol=GRAD_TOL)
    got = _flat_np(lm)
    for k, w in ref_flatten(jax.tree.map(np.asarray, ref_p)).items():
        # the parameters differ only through the gradients (1e-4); Adam's
        # first step moves each by ~lr whatever the gradient's size
        assert rel_l2(got[k], w) <= 1e-5, k
    assert not any(t.requires_grad for t in lm.parameters())


def test_training_with_compression_converges():
    """The reference's ``test_training_with_compression_converges`` on the
    port: qwen2.5-3b's smoke config cut to one layer, 8-bit gradient
    compression, 30 steps; the loss drops by more than 0.5."""
    cfg = dataclasses.replace(get_config("qwen2.5-3b").smoke(), n_layers=1,
                              dtype="float32")
    opt_cfg = AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=30)
    gc = GradCompressionConfig(bits=8)
    data = TokenDataConfig(cfg.vocab_size, 32, 4, seed=0)
    step = make_train_step(cfg, opt_cfg, remat=None, grad_comp=gc)
    state = build_state(cfg, opt_cfg, 0, gc, device="cpu")
    losses = []
    for i in range(30):
        p, o, m = step(state["params"], state["opt"], synth_batch(data, i))
        state = {"params": p, "opt": o}
        losses.append(float(m["loss"]))
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0] - 0.5
