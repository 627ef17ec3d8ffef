"""The port's mesh on process groups, held against the reference on a
forced 4-device CPU mesh: the expert-parallel MoE dispatch, §7's
quantizer on the wire, the FSDP wire train step, the head padding and
checkpoints loaded onto a mesh.

Both sides run once per module.  The reference runs in a process of its
own (``torch_mesh_reference.py``, JAX with
``--xla_force_host_platform_device_count=4``: the pytest process's JAX
has one CPU device).  The port runs as 4 CPU ranks spawned together
(``torch_mesh_ranks.py``; gloo through a ``file://`` rendezvous, no TCP
port).  Inputs are made with numpy from seeds (``mesh_cases.py``); every
rank writes what it got and the tests below assert.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch.multiprocessing as mp

import mesh_cases as mc

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")
RANKS = 4


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the reference's outputs, each rank's outputs, the reference's
    checkpoint directory, the port's)."""
    root = tmp_path_factory.mktemp("mesh_spmd")
    ref_path = str(root / "ref.npz")
    ckpt = str(root / "ref_ckpt")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.pathsep.join([SRC, HERE]))
    subprocess.run([sys.executable, os.path.join(HERE,
                                                 "torch_mesh_reference.py"),
                    ref_path, ckpt], env=env, check=True, timeout=600,
                   capture_output=True)
    import torch_mesh_ranks

    mp.spawn(torch_mesh_ranks.run,
             args=(str(root / "rendezvous"), ref_path, str(root), ckpt),
             nprocs=RANKS, join=True)
    ranks = [dict(np.load(root / f"rank{r}.npz")) for r in range(RANKS)]
    return dict(np.load(ref_path)), ranks, ckpt, str(root / "port_ckpt")


@pytest.mark.parametrize("case", sorted(mc.MOE_CASES))
def test_moe_ep_matches_the_references_ep(runs, case):
    """``_moe_apply_ep`` at (1, 4), (2, 2) and 6 experts padded to 8 on a
    4-way model axis: on every rank the whole output within rtol = atol =
    1e-5 of the reference's EP and aux within 1e-6; the assignments the
    ranks drop, together, are the reference's dropped set."""
    ref, ranks, _, _ = runs
    want = ref[f"moe/{case}/out"]
    for out in ranks:
        np.testing.assert_allclose(out[f"moe/{case}/out"], want, rtol=1e-5,
                                   atol=1e-5)
        assert abs(float(out[f"moe/{case}/aux"])
                   - float(ref[f"moe/{case}/aux"])) <= 1e-6
    dropped = np.sort(np.concatenate([o[f"moe/{case}/dropped"]
                                      for o in ranks]))
    np.testing.assert_array_equal(dropped, ref[f"moe/{case}/dropped"])
    assert dropped.size > 0  # the capacity binds in every case


@pytest.mark.parametrize("case", sorted(mc.MOE_CASES))
def test_moe_whole_activation_matches_the_references_ep(runs, case):
    """``moe_apply`` under a mesh, the MoE of a model run with whole
    activations and whole experts: each rank dispatches its data shard's
    rows, the outputs are gathered back, and every rank's whole output is
    within rtol = atol = 1e-5 of the reference's EP (aux within 1e-6)."""
    ref, ranks, _, _ = runs
    for out in ranks:
        np.testing.assert_allclose(out[f"moe/{case}/whole"],
                                   ref[f"moe/{case}/out"], rtol=1e-5,
                                   atol=1e-5)
        assert abs(float(out[f"moe/{case}/whole_aux"])
                   - float(ref[f"moe/{case}/aux"])) <= 1e-6


@pytest.mark.parametrize("bits", mc.WIRE_BITS)
@pytest.mark.parametrize("keyed", ["none", "key"])
def test_wire_quantized_psum_bit_equal(runs, bits, keyed):
    """Without a key, and with the reference's own dither draws passed in:
    each rank's codes and the decoded sums bit-equal to the reference's
    (the int16 carrier of 8 bits on 4 ranks crosses gloo as int32).  The
    reference's decode is not ``total * scale / qmax / n`` divided in
    float32: XLA multiplies by the reciprocals (ROADMAP R11)."""
    ref, ranks, _, _ = runs
    tag = f"wire/{bits}/{keyed}"
    qmax = (1 << (bits - 1)) - 1
    for n, g in mc.wire_grads().items():
        total = ref[f"{tag}/codes/{n}"].sum(0).astype(np.float32)
        scale = np.abs(g).max()
        divided = total * scale / np.float32(qmax) / np.float32(RANKS)
        assert (divided != ref[f"{tag}/dec/{n}"][0]).any(), n
    for r, out in enumerate(ranks):
        for n in mc.wire_grads():
            np.testing.assert_array_equal(out[f"{tag}/codes/{n}"],
                                          ref[f"{tag}/codes/{n}"][r])
            got, want = out[f"{tag}/dec/{n}"], ref[f"{tag}/dec/{n}"][r]
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("bits", mc.WIRE_BITS)
def test_wire_quantized_psum_generator_dither_is_unbiased(runs, bits):
    """With a ``torch.Generator`` dither the mean of the decoded sum over
    200 draws is the true mean gradient: summed over a tensor's elements
    within 3 standard errors, and each element within 5.  A rank's code
    has mean g / scale * qmax (|.| <= qmax - 1/2 here) and variance
    f (1 - f), f its fractional part."""
    _, ranks, _, _ = runs
    grads = mc.wire_grads()
    qmax = (1 << (bits - 1)) - 1
    for n, g in grads.items():
        g64 = g.astype(np.float64)
        scale = float(np.abs(g).max())
        t = g64 / scale * qmax
        assert np.abs(t).max() <= qmax
        f = t - np.floor(t)
        unit = scale / qmax / RANKS
        var = (f * (1 - f)).sum(0) * unit ** 2 / mc.WIRE_GEN_DRAWS
        err = ranks[0][f"wire/{bits}/gen_mean/{n}"] - g64.mean(0)
        for out in ranks[1:]:
            np.testing.assert_array_equal(out[f"wire/{bits}/gen_mean/{n}"],
                                          ranks[0][f"wire/{bits}/gen_mean/{n}"])
        assert abs(err.sum()) <= 3 * np.sqrt(var.sum()), n
        se = np.sqrt(np.maximum(var, (unit / 2) ** 2 / mc.WIRE_GEN_DRAWS))
        assert np.all(np.abs(err) <= 5 * se), n


def _full_params(ranks) -> dict:
    """{port name: the whole final parameter}: rank 0's copy of a
    replicated leaf, the ranks' shards concatenated along their data dim
    otherwise."""
    out = {}
    for k in ranks[0]:
        if not k.startswith("step/shard/"):
            continue
        n = k.removeprefix("step/shard/")
        dim = int(ranks[0][f"step/dim/{n}"])
        parts = [o[k] for o in ranks]
        out[n] = parts[0] if dim < 0 else np.concatenate(parts, dim)
    return out


def test_wire_train_step_matches_the_reference(runs):
    """``make_wire_train_step`` on (4, 1), qwen3-4b smoke float32, remat
    None, 8-bit codes, 3 steps, the reference's dither draws injected:
    losses and grad norms within 1e-5 relative, the parameters per leaf
    within the relative L2 of 1e-5 that
    ``test_train_step_matches_reference_step`` holds.

    A gradient that differs from the reference's in its last bits (the
    matmuls sum in other orders) flips a code only where g / scale * qmax
    + dither lies that close to a rounding boundary.  The ranks count the
    codes of non-zero gradients within 1e-5 * qmax of one (a gradient gap
    of up to 1e-5 of the scale, ~100x float32's); that count bounds the
    flips, and so the parameter elements off by more than 1e-6 relative.
    At 4 bits a flip at a small gradient changes its sign, which Adam's
    first step turns into a whole lr: the third step's grad norm then
    moved 1.8e-4 from the reference's, so the steps run 8-bit codes (the
    4-bit codes are held bit-equal on their own above)."""
    ref, ranks, _, _ = runs
    for i in range(mc.STEP_STEPS):
        for out in ranks:
            np.testing.assert_allclose(out[f"step/loss/{i}"],
                                       ref[f"step/loss/{i}"], rtol=1e-5)
            np.testing.assert_allclose(out[f"step/grad_norm/{i}"],
                                       ref[f"step/grad_norm/{i}"], rtol=1e-5)
    near = int(sum(o["step/margins"].sum() for o in ranks))
    from repro_torch.models.model import reference_path

    got = _full_params(ranks)
    off = 0
    for n, w in got.items():
        path, index = reference_path(n)
        want = ref[f"step/final/{path}"]
        want = want if index is None else want[index]
        assert w.shape == want.shape, n
        diff = np.linalg.norm(w - want) / np.linalg.norm(want)
        assert diff <= 1e-5, (n, diff)
        off += int((np.abs(w - want) > 1e-6 * np.abs(want) + 1e-7).sum())
    assert off <= near, (off, near)


def test_wire_train_step_keeps_replicated_leaves_equal(runs):
    """Every rank's copy of a leaf no spec shards over ``data`` is
    bit-equal after the steps (the decoded gradients are rank-identical),
    and the sharded leaves are really cut."""
    _, ranks, _, _ = runs
    n_rep = n_cut = 0
    for k in ranks[0]:
        if not k.startswith("step/shard/"):
            continue
        n = k.removeprefix("step/shard/")
        if int(ranks[0][f"step/dim/{n}"]) < 0:
            n_rep += 1
            for out in ranks[1:]:
                np.testing.assert_array_equal(out[k], ranks[0][k])
        else:
            n_cut += 1
            assert not np.array_equal(ranks[0][k], ranks[1][k])
    assert n_rep and n_cut


def test_head_padding_under_a_mesh(runs):
    """Hymba-like attention (25 query heads over 5 KV heads) under a
    (1, 4) mesh pads its heads to 6 x 6; its output equals the unpadded
    one within 1e-5 and the reference's padded output within 1e-5."""
    ref, ranks, _, _ = runs
    for out in ranks:
        assert tuple(out["attn/pads"]) == (6, 6)
        np.testing.assert_allclose(out["attn/padded"], out["attn/plain"],
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(out["attn/padded"], ref["attn/padded"],
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(out["attn/plain"], ref["attn/plain"],
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_load_checkpoint_onto_a_mesh(runs, writer):
    """A train state's checkpoint, written by either package, loaded onto
    (4, 1) with ``shardings``: every leaf's full tensor bit-equal to the
    saved one, each rank holding its shard (a quarter of the sharded
    dimension)."""
    _, ranks, ref_ckpt, port_ckpt = runs
    d = port_ckpt if writer == "port" else ref_ckpt
    step = 2 if writer == "port" else 3
    saved = np.load(os.path.join(d, f"step_{step:08d}", "state.npz"))
    assert int(ranks[0][f"ckpt/{writer}/step"]) == step
    n_cut = 0
    for k in saved.files:
        want = saved[k]
        for out in ranks:
            got = out[f"ckpt/{writer}/full/{k}"]
            assert got.tobytes() == want.tobytes(), k
            local = tuple(out[f"ckpt/{writer}/local/{k}"])
            if local != want.shape:
                n_cut += 1
                (dim,) = [i for i, (a, b) in enumerate(zip(local, want.shape))
                          if a != b]
                assert local[dim] * RANKS == want.shape[dim], k
    assert n_cut > 0


# ---------------------------------------------------------------------------
# tensor-parallel serving against the reference's sharded jit
# ---------------------------------------------------------------------------
TP_KEYS = [(case, f"{d}x{m}") for case in mc.TP_CASES
           for d, m in mc.TP_MESHES]


def _rel_l2(got, want) -> float:
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def check_tp_logits(ref, ranks, case, mesh):
    """Every rank's prefill and decode logits of a TP case against the
    reference's (the logits test's body, shared with
    ``test_torch_mesh_mla.py``)."""
    tag = f"tp/{case}/{mesh}"
    steps_ = ["prefill"] + [f"decode{i}" for i in range(mc.TP_DECODE_STEPS)]
    for out in ranks:
        for step in steps_:
            got, want = out[f"{tag}/logits/{step}"], ref[f"{tag}/logits/{step}"]
            assert got.shape == want.shape, (step, got.shape, want.shape)
            assert _rel_l2(got, want) <= 1e-5, (step, _rel_l2(got, want))


@pytest.mark.parametrize("case,mesh", TP_KEYS)
def test_tp_logits_match_the_references_sharded_jit(runs, case, mesh):
    """``make_prefill_step`` and ``make_decode_step`` on sharded parameters
    under ``logical_sharding`` (each rank its heads, FF columns, vocab
    slice, batch rows and sequence slice; the decode cache its KV heads
    or its time slice): the prefill's logits and each decode step's,
    gathered whole on every rank, within float32 1e-5 relative L2 of the
    reference's ``prefill`` / ``decode_step`` jitted with
    ``in_shardings`` on 4 CPU devices."""
    ref, ranks, _, _ = runs
    check_tp_logits(ref, ranks, case, mesh)


def check_tp_shards(ref, ranks, case, mesh):
    """Every rank's parameter and prefill-cache shards of a TP case against
    the reference's (the shards test's body, shared with
    ``test_torch_mesh_mla.py``): the cache of ``layers`` and of
    ``layers_dense``."""
    from repro_torch.models.model import reference_path

    tag = f"tp/{case}/{mesh}"
    for out in ranks:
        di, mi = (int(i) for i in out[f"{tag}/coord"])
        cut = 0
        for k in out:
            if not k.startswith(f"{tag}/local/"):
                continue
            path, index = reference_path(k.removeprefix(f"{tag}/local/"))
            want = ref[f"{tag}/pshard/{path}/{di}{mi}"]
            want = want if index is None else want[index]
            got = out[k]
            assert got.shape == want.shape, (k, got.shape, want.shape)
            np.testing.assert_array_equal(got, want, err_msg=k)
            whole = ref[f"tp/{case}/p/{path}"]
            cut += got.size < (whole.size if index is None else whole[0].size)
        assert cut > 0
        np.testing.assert_array_equal(out[f"{tag}/cache/pos"],
                                      ref[f"{tag}/cshard/pos/{di}{mi}"])
        leaves = [k.removeprefix(f"{tag}/cache/") for k in out
                  if k.startswith((f"{tag}/cache/layers/",
                                   f"{tag}/cache/layers_dense/"))]
        assert leaves
        for key in leaves:
            stack, i, leaf = key.split("/", 2)
            got = out[f"{tag}/cache/{key}"]
            want = ref[f"{tag}/cshard/{stack}/{leaf}/{di}{mi}"][int(i)]
            assert got.shape == want.shape, (key, got.shape, want.shape)
            assert tuple(out[f"{tag}/zeros/{key}"]) == want.shape
            if leaf == "state":
                # RWKV6's WKV state sums k v^T over the prompt (entries up
                # to ~27 at rwkv6's layer 1): held within 1e-5 of its
                # largest entry; the one-process port's own prefill
                # differs from the reference's there by 1.6e-5 absolute
                err = np.abs(got - want).max()
                assert err <= 1e-5 * np.abs(want).max(), (key, err)
            else:
                np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5,
                                           err_msg=key)
        assert tuple(out[f"{tag}/zeros/pos"]) == out[f"{tag}/cache/pos"].shape


@pytest.mark.parametrize("case,mesh", TP_KEYS)
def test_tp_shards_equal_the_references_addressable_shards(runs, case, mesh):
    """Every rank's parameter leaves (``lm_shards_from_arrays``) equal, in
    shape and bit for bit, the reference's ``addressable_shards`` at the
    same (data, model) coordinate under ``param_pspecs``; its prefill
    cache's leaves (k / v, RWKV6's state and token-shift slices, the
    SSM's h and conv) have the shapes of the reference's shards under
    ``cache_pspecs`` and their values within 1e-5 (RWKV6's state within
    1e-5 of its largest entry); ``pos`` is equal;
    ``init_cache_shards`` allocates those shapes.  Some leaves of each are
    really cut."""
    ref, ranks, _, _ = runs
    check_tp_shards(ref, ranks, case, mesh)


@pytest.mark.parametrize("mode", ["weights", "products"])
@pytest.mark.parametrize("mesh", [f"{d}x{m}" for d, m in mc.TP_MESHES])
def test_tp_straddling_heads_equal_the_one_process_heads(runs, mesh, mode):
    """hymba_padded's attention (25 / 5 heads padded to 6 x 6) on the
    plain route: each rank's padded heads, which straddle KV groups (9 a
    rank in groups of 6 on (1, 4), 15 on (2, 2)) and so read one KV head
    each (n_rep 1), equal the one-process padded attention's slice of
    those heads under the same mesh within 1e-5, and their partials of
    the output, summed over ``model``, its output; ``wq`` / ``wo``
    redistributed as the weights (a prefill's way) and as the products
    (a decode step's)."""
    _, ranks, _, _ = runs
    tag = f"straddle/{mesh}"
    for out in ranks:
        assert tuple(out[f"{tag}/pads"]) == ((6, 6) if mesh == "1x4"
                                             else (5, 6))
        assert int(out[f"{tag}/{mode}/n_rep"]) == 1
        np.testing.assert_allclose(out[f"{tag}/{mode}/heads"],
                                   out[f"{tag}/one/heads"], rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(out[f"{tag}/{mode}/out"],
                                   out[f"{tag}/one/out"], rtol=1e-5,
                                   atol=1e-5)


def test_tp_prefill_collectives_are_timed_per_kind(runs):
    """``collective_timing`` around the kv4 prefill on (1, 4) (heads, FF
    columns, vocab and sequence all cut over ``model``) counts on every
    rank the Megatron schedule: the embedding's and each block's two
    row-parallel sums as ``reduce_scatter`` of the float32 (B, S, d)
    partial, each block's two column-parallel ``all_gather`` of the
    (B, S / 4, d) slice and the last position's (B, 1, d) gather; no
    ``all_reduce``; every kind took time."""
    from repro_torch.configs import get_config

    cfg = mc.tp_config(get_config, "kv4")
    _, _, b, s, _ = mc.TP_CASES["kv4"]
    d, n = cfg.d_model, cfg.n_layers
    tag = "tp/kv4/1x4/coll/"
    want = {"reduce_scatter sum": [2 * n + 1, (2 * n + 1) * b * s * d * 4],
            "all_gather": [2 * n + 1, (2 * n * s // 4 + 1) * b * d * 4]}
    _, ranks, _, _ = runs
    for out in ranks:
        got = {k.removeprefix(tag): out[k] for k in out if k.startswith(tag)}
        assert set(got) == set(want), sorted(got)
        for kind, (calls, nbytes) in want.items():
            assert list(got[kind]) == [calls, nbytes, 1], (kind, got[kind])
