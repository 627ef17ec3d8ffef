"""The port's mesh without devices, held against the reference: the rules
tables, ``spec_for``, the head padding, every partition spec of every
architecture on the 1 x 1, 16 x 16 and 2 x 16 x 16 meshes, the abstract
inputs of every dry-run cell, the per-arch configs, ``hlo_stats`` and the
dry-run's per-device argument bytes.

None of it needs a device: both packages describe a mesh by its axes
(the reference's ``jax.sharding.AbstractMesh``, the port's
``launch.mesh.AbstractMesh``), so the reference runs in this process.
The port keeps one tensor a block where the reference stacks the blocks
of ``layers`` on a leading L axis: a block's spec is the reference's
stacked spec without its leading ``None``, a block's shape the stacked
shape without L.
"""
import dataclasses
import importlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh as RefAbstractMesh

from repro.configs import ARCHITECTURES, SHAPES
from repro.configs import get_config as ref_get_config
from repro.launch import shardings as ref_sh
from repro.launch import specs as ref_specs
from repro.launch.hlo_stats import hlo_stats as ref_hlo_stats
from repro.models import attention as ref_attention
from repro.models import sharding as ref_sharding
from repro_torch.configs import get_config
from repro_torch.launch import dryrun, specs
from repro_torch.launch import shardings as sh
from repro_torch.launch.hlo_stats import hlo_stats
from repro_torch.launch.mesh import AbstractMesh, MeshError, make_host_mesh
from repro_torch.models import attention
from repro_torch.models import sharding
from repro_torch.models.model import reference_path

ARCHS = sorted(ARCHITECTURES)
MESHES = {
    "1x1": ((1, 1), ("data", "model")),
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
}
# the 32 cells of tests/test_system.py's input_specs test
CELLS = [(a, s) for a in ARCHS for s in sorted(SHAPES)
         if not (s == "long_500k" and not ARCHITECTURES[a].sub_quadratic)]


def meshes(name):
    shape, axes = MESHES[name]
    return RefAbstractMesh(shape, axes), AbstractMesh(shape, axes)


def rules_for(name):
    return ((ref_sharding.multi_pod_rules(), sharding.multi_pod_rules())
            if name == "2x16x16" else
            (ref_sharding.single_pod_rules(), sharding.single_pod_rules()))


def flat_ref(tree) -> dict:
    """{"/"-joined path: leaf} of a reference pytree."""
    leaves, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): leaf for path, leaf in leaves}


def by_reference(port: dict, stacked_tail) -> dict:
    """{reference path: [per-block values in order]} of a {port name:
    value} dict (unstacked leaves as one-element lists)."""
    out: dict = {}
    for name, v in port.items():
        path, index = reference_path(name)
        out.setdefault(path, []).append((index, stacked_tail(v)))
    return {k: [v for _, v in sorted(vs, key=lambda iv: iv[0] or 0)]
            for k, vs in out.items()}


def assert_specs_equal(port: dict, ref_tree):
    """Every port spec equals the reference's (a block's without the L
    entry), and the two cover the same leaves."""
    ref = flat_ref(ref_tree)
    grouped = by_reference(port, lambda s: s)
    assert set(grouped) == set(ref)
    for path, specs_ in grouped.items():
        want = tuple(ref[path])
        for s in specs_:
            got = tuple(s)
            if len(specs_) > 1 or len(got) < len(want):
                assert want[0] is None, path
                assert got == want[1:], path
            else:
                assert got == want, path


# ---------------------------------------------------------------------------
# rules, spec_for, head padding
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("which", ["single", "multi", "multi_pipeline"])
def test_rules_tables_equal(which):
    if which == "single":
        got, want = sharding.single_pod_rules(), ref_sharding.single_pod_rules()
    else:
        pipe = which == "multi_pipeline"
        got = sharding.multi_pod_rules(pipeline=pipe)
        want = ref_sharding.multi_pod_rules(pipeline=pipe)
    assert got == want


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_spec_for_and_batch_axes_equal(mesh_name):
    ref_mesh, mesh = meshes(mesh_name)
    ref_rules, rules = rules_for(mesh_name)
    names = [("batch", None, "heads", None), ("batch", "seq_sp", None),
             ("experts", None, None), ("layers", "vocab"), ("unknown",)]
    with ref_sharding.logical_sharding(ref_mesh, ref_rules):
        want = [tuple(ref_sharding.spec_for(*n)) for n in names]
        want_batch = ref_sharding.batch_axes_in()
    with sharding.logical_sharding(mesh, rules):
        got = [tuple(sharding.spec_for(*n)) for n in names]
        assert sharding.batch_axes_in() == want_batch
        assert sharding.current_mesh() is mesh
    assert sharding.current_mesh() is None and sharding.current_rules() is None
    assert got == want
    assert sh.batch_axes(mesh) == ref_sh.batch_axes(ref_mesh)


@pytest.mark.parametrize("arch", ARCHS)
def test_head_padding_equal(arch):
    """``_head_padding`` for model axes 1, 4 and 16; without a mesh the
    identity."""
    cfg, ref_cfg = get_config(arch), ref_get_config(arch)
    got_none = attention._head_padding(cfg)
    assert got_none == ref_attention._head_padding(ref_cfg) == (
        cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads)
    for model in (1, 4, 16):
        shape, axes = (1, model), ("data", "model")
        with ref_sharding.logical_sharding(RefAbstractMesh(shape, axes),
                                           ref_sharding.single_pod_rules()):
            want = ref_attention._head_padding(ref_cfg)
        with sharding.logical_sharding(AbstractMesh(shape, axes),
                                       sharding.single_pod_rules()):
            got = attention._head_padding(cfg)
        assert got == want, (arch, model)
    if arch == "hymba-1.5b":  # the card's 36 / 6 launch
        with sharding.logical_sharding(AbstractMesh((1, 4), axes),
                                       sharding.single_pod_rules()):
            assert attention._head_padding(cfg) == (6, 6)


def test_ax_is_a_layout_statement():
    """Without a tensor-parallel call's sizes installed (whole activations
    on every rank), ``ax`` returns a plain tensor unchanged under a mesh
    and checks the names against the rank; ``PartitionSpec`` compares as
    a tuple."""
    x = torch.zeros((4, 6, 8))
    with sharding.logical_sharding(AbstractMesh((1, 4), ("data", "model")),
                                   sharding.single_pod_rules()):
        assert sharding.ax(x, "batch", None, "heads") is x
        with pytest.raises(ValueError):
            sharding.ax(x, "batch")
    spec = sharding.PartitionSpec(None, ("pod", "data"))
    assert spec == (None, ("pod", "data"))
    import pickle

    assert pickle.loads(pickle.dumps(spec)) == spec
    assert sh.placements(("data", "model"), sharding.PartitionSpec(
        None, "data"))[0].dim == 1


def test_ax_checks_the_local_shape_under_logical_sizes():
    """While a tensor-parallel call's global sizes are installed, ``ax``
    holds each named dim to its shard under the rules: cut where the axis
    divides it (batch 4 over data 2, 8 heads over model 4), whole where
    it does not (2 KV heads, a vocab of 509 over model 4); a dim named
    ``None`` is not checked.  A whole tensor where a shard is due, a
    shard where the whole is due, or a name with no size raises
    ``LayoutError``."""
    mesh = AbstractMesh((2, 4), ("data", "model"))
    sizes = {"batch": 4, "heads": 8, "kv_heads": 2, "vocab": 509}
    with sharding.logical_sharding(mesh, sharding.single_pod_rules()), \
            sharding.logical_sizes(sizes):
        q = torch.zeros((2, 6, 2, 16))
        assert sharding.ax(q, "batch", None, "heads", None) is q
        k = torch.zeros((2, 6, 2, 16))
        assert sharding.ax(k, "batch", None, "kv_heads", None) is k
        logits = torch.zeros((2, 509))
        assert sharding.ax(logits, "batch", "vocab") is logits
        for bad, names in (
                (torch.zeros((4, 6, 2, 16)), ("batch", None, "heads", None)),
                (torch.zeros((2, 6, 8, 16)), ("batch", None, "heads", None)),
                (torch.zeros((2, 6, 1, 16)),
                 ("batch", None, "kv_heads", None)),
                (torch.zeros((2, 127)), ("batch", "vocab")),
                (torch.zeros((2, 6, 16)), ("batch", "seq_sp", None))):
            with pytest.raises(sharding.LayoutError):
                sharding.ax(bad, *names)
    with sharding.logical_sharding(mesh, sharding.single_pod_rules()):
        whole = torch.zeros((4, 6, 8, 16))  # no sizes: a whole activation
        assert sharding.ax(whole, "batch", None, "heads", None) is whole


@pytest.mark.parametrize("arch", ["qwen3-4b", "granite-moe-3b-a800m",
                                  "deepseek-v3-671b", "hymba-1.5b"])
def test_init_leaves_draws_init_params(arch):
    """``init_leaves`` hands over every parameter of ``init_params`` in
    ``named_parameters`` order with the same numbers (one Generator, one
    block at a time), so a rank can cut a seeded model leaf by leaf."""
    from repro_torch.models import init_leaves, init_params

    cfg = get_config(arch).smoke()
    want = list(init_params(cfg, 3, "cpu").named_parameters())
    got = list(init_leaves(cfg, 3, "cpu"))
    assert [n for n, _ in got] == [n for n, _ in want]
    for (n, a), (_, b) in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b), n


def test_host_mesh_raises_without_a_process_group():
    with pytest.raises(MeshError, match="process group"):
        make_host_mesh(1, 1, device="cpu")


# ---------------------------------------------------------------------------
# partition specs of every architecture
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_opt_cache_batch_specs_equal(arch, mesh_name):
    ref_mesh, mesh = meshes(mesh_name)
    cfg, ref_cfg = get_config(arch), ref_get_config(arch)
    pspecs = sh.param_pspecs(cfg, mesh)
    assert_specs_equal(pspecs, ref_sh.param_pspecs(ref_cfg, ref_mesh))
    opt, ref_opt = sh.opt_pspecs(cfg, mesh), ref_sh.opt_pspecs(ref_cfg,
                                                               ref_mesh)
    assert tuple(opt["step"]) == tuple(ref_opt["step"]) == ()
    for k in ("m", "v"):
        assert_specs_equal(opt[k], ref_opt[k])
    for batch, max_len in ((128, 4096), (3, 100)):
        got = sh.cache_pspecs(cfg, mesh, batch, max_len)
        want = flat_ref(ref_sh.cache_pspecs(ref_cfg, ref_mesh, batch,
                                            max_len))
        assert tuple(got["pos"]) == tuple(want["pos"])
        for key in ("layers", "layers_dense"):
            assert (key in got) == any(p.startswith(key + "/") for p in want)
            for layer in got.get(key, []):
                for path, spec in flat_ref(layer).items():
                    w = tuple(want[f"{key}/{path}"])
                    assert w[0] is None and tuple(spec) == w[1:], path
    for b in (256, 32, 48, 1):
        for rank in (1, 2, 3):
            assert tuple(sh.batch_spec(mesh, b, rank)) == tuple(
                ref_sh.batch_spec(ref_mesh, b, rank))


def test_reference_pspecs_and_named_shardings():
    """``reference_pspecs`` restacks the port's specs into the reference's
    tree; ``to_named`` keeps the tree and gives each spec its placements
    and shard shape."""
    ref_mesh, mesh = meshes("16x16")
    cfg = get_config("granite-moe-3b-a800m")
    pspecs = sh.param_pspecs(cfg, mesh)
    want = flat_ref(ref_sh.param_pspecs(ref_get_config(cfg.name), ref_mesh))
    got = flat_ref(sh.reference_pspecs(pspecs))
    assert {k: tuple(v) for k, v in got.items()} == {
        k: tuple(v) for k, v in want.items()}
    assert pspecs["layers.0.mlp.w1"] == (None, "data", None)  # 40 % 16
    mesh = AbstractMesh((2, 4), ("data", "model"))
    named = sh.to_named(mesh, {"a": sh.param_pspecs(cfg, mesh)[
        "layers.0.mlp.w1"], "b": [sharding.PartitionSpec()]})
    assert named["a"].spec == ("model", "data", None)
    assert named["a"].shard_shape((40, 1536, 512)) == (10, 768, 512)
    assert named["b"][0].placements[0].is_replicate()
    assert [type(p).__name__ for p in named["a"].placements] == [
        "Shard", "Shard"]
    assert [p.dim for p in named["a"].placements] == [1, 0]


# ---------------------------------------------------------------------------
# input_specs over the 32 cells
# ---------------------------------------------------------------------------
def _port_arg_tree(arg):
    if isinstance(arg, torch.nn.Module):
        return dict(arg.named_parameters())
    return arg


def _port_flat(tree, prefix=""):
    """{name: tensor} of the port's args (dicts, lists, modules)."""
    tree = _port_arg_tree(tree)
    if isinstance(tree, torch.Tensor):
        return {prefix.rstrip("/"): tree}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        out.update(_port_flat(v, f"{prefix}{k}/"))
    return out


_TORCH_DTYPE = {"int32": torch.int32, "float32": torch.float32,
                "bfloat16": torch.bfloat16}


def _compare_arg(port, ref, kind):
    """One argument of a cell: parameters / moments by name (blocks
    restacked), cache layers by index, everything else by path."""
    ref_flat = flat_ref(ref)
    if kind == "named":
        grouped = by_reference(_port_arg_tree(port), lambda t: t)
        assert set(grouped) == set(ref_flat)
        for path, ts in grouped.items():
            w = ref_flat[path]
            shape = tuple(w.shape)
            if len(ts) > 1 or len(ts[0].shape) < len(shape):
                shape = shape[1:]
                assert w.shape[0] == len(ts), path
            for t in ts:
                assert t.device.type == "meta"
                assert tuple(t.shape) == shape, path
                assert t.dtype == _TORCH_DTYPE[str(w.dtype)], path
        return
    got = _port_flat(port)
    for path, t in got.items():
        parts = path.split("/")
        if parts[0] in ("layers", "layers_dense"):  # cache: (L, B, ...)
            w = ref_flat["/".join([parts[0], *parts[2:]])]
            want_shape = tuple(w.shape)[1:]
        else:
            w = ref_flat[path]
            want_shape = tuple(w.shape)
        assert tuple(t.shape) == want_shape, path
        assert t.dtype == _TORCH_DTYPE[str(w.dtype)], path


@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_specs_equal_every_cell(arch, shape):
    """The abstract arguments of each dry-run cell: every shape and dtype
    equal the reference's ``ShapeDtypeStruct``s (a block's without L),
    on ``meta``; the spec trees cover the same leaves."""
    assert len(CELLS) == 32
    ref_mesh, mesh = meshes("16x16")
    cfg, ref_cfg = get_config(arch), ref_get_config(arch)
    args, pspecs = specs.input_specs(cfg, SHAPES[shape], mesh)
    ref_args, ref_pspecs = ref_specs.input_specs(ref_cfg, SHAPES[shape],
                                                 ref_mesh)
    assert len(args) == len(ref_args) == len(pspecs) == len(ref_pspecs)
    _compare_arg(args[0], ref_args[0], "named")
    assert_specs_equal(pspecs[0], ref_pspecs[0])
    kind = SHAPES[shape].kind
    if kind == "train":
        for k in ("m", "v"):
            _compare_arg(args[1][k], ref_args[1][k], "named")
        assert args[1]["step"].shape == () and args[1]["step"].dtype == (
            torch.int32)
        _compare_arg(args[2], ref_args[2], "tree")
        assert {k: tuple(v) for k, v in pspecs[2].items()} == {
            k: tuple(v) for k, v in ref_pspecs[2].items()}
    else:
        for a, r in zip(args[1:], ref_args[1:]):
            _compare_arg(a, r, "tree")
    for t in _port_flat(list(args)).values():
        assert t.device.type == "meta"


# ---------------------------------------------------------------------------
# configs, hlo_stats, the dry-run
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_per_arch_config_modules_equal(arch):
    mod = arch.replace("-", "_").replace(".", "_")
    port = importlib.import_module(f"repro_torch.configs.{mod}")
    ref = importlib.import_module(f"repro.configs.{mod}")
    for key in ("CONFIG", "SMOKE"):
        assert dataclasses.asdict(getattr(port, key)) == dataclasses.asdict(
            getattr(ref, key)), key
    assert port.CONFIG == get_config(arch)


def test_hlo_stats_copy_parses_the_references_hlo():
    """On the HLO of the reference's compiled ``loss_fn`` (qwen2.5-3b
    smoke), the port's copy gives the reference's dict."""
    from repro.models import init_params, loss_fn

    cfg = ref_get_config("qwen2.5-3b").smoke()
    params = jax.eval_shape(lambda: init_params(cfg, jax.random.PRNGKey(0)))
    toks = jax.ShapeDtypeStruct((2, 64), jnp.int32)
    text = jax.jit(lambda p, t: loss_fn(cfg, p, t, t)).lower(
        params, toks).compile().as_text()
    got, want = hlo_stats(text), ref_hlo_stats(text)
    assert got == want
    assert got["flops"] > 0


def test_dryrun_cli_and_argument_bytes(tmp_path):
    """``python -m repro_torch.launch.dryrun --arch qwen3-4b --shape
    train_4k`` writes a cell whose XLA-only fields are null, and whose
    per-device argument bytes equal the sum, over the reference's
    abstract arguments, of each leaf's shard under the reference's specs
    (plain arithmetic, no compile)."""
    dryrun.main(["--arch", "qwen3-4b", "--shape", "train_4k", "--out",
                 str(tmp_path)])
    rec = json.loads((tmp_path / "qwen3-4b__train_4k__pod1.json").read_text())
    assert rec["status"] == "ok" and rec["estimator"] == "torch-meta"
    for k in ("temp_bytes", "output_bytes", "alias_bytes", "peak_bytes"):
        assert rec["memory"][k] is None
    for k in ("hlo_flops", "hlo_bytes", "collective_bytes"):
        assert rec["per_device"][k] is None
    assert rec["collectives"] is None and rec["cost_analysis_naive"] is None
    assert rec["n_devices"] == 256

    ref_mesh = RefAbstractMesh((16, 16), ("data", "model"))
    args, pspecs = ref_specs.input_specs(ref_get_config("qwen3-4b"),
                                         SHAPES["train_4k"], ref_mesh)
    want = 0
    leaves = jax.tree.leaves(args)
    spec_leaves = jax.tree.leaves(
        pspecs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    assert len(leaves) == len(spec_leaves)
    for leaf, spec in zip(leaves, spec_leaves):
        n = int(np.prod(leaf.shape)) * leaf.dtype.itemsize
        for axis in spec:
            for a in (axis if isinstance(axis, tuple) else (axis,)):
                if a is not None:
                    n //= ref_mesh.shape[a]
        want += n
    assert rec["memory"]["argument_bytes"] == want
    assert rec["per_device"]["flops"] > rec["model_flops_per_device"] > 0
