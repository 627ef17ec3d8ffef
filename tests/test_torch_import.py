"""The port's package boundary: ``repro_torch`` and ``chip_smoke.py`` never
touch JAX or the reference package, the device is explicit, and a CUDA
entry never falls back to the CPU."""
import ast
import os
import pkgutil
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.device import resolve_device
from repro_torch.kernels.tree_predict import tree_predict as tp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
PORT = os.path.join(SRC, "repro_torch")

FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)", re.M)


def _port_modules() -> list[str]:
    return sorted(
        m.name
        for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")
    )


def test_port_modules_exist():
    mods = _port_modules()
    for name in (
        "repro_torch.device",
        "repro_torch.convert",
        "repro_torch.core.bregman",
        "repro_torch.core.compressed_predict",
        "repro_torch.kernels.build",
        "repro_torch.kernels.tree_predict.tree_predict",
        "repro_torch.kernels.tree_predict.ref",
        "repro_torch.store.arena",
        "repro_torch.store.runtime",
        "repro_torch.serving.server",
        "repro_torch.serving.engines",
        "repro_torch.data.tabular",
        "repro_torch.forest.binning",
        "repro_torch.forest.cart",
        "repro_torch.forest.forest",
        "repro_torch.forest.baselines",
        "repro_torch.forest.compare",
        "repro_torch.core.lossy",
        "repro_torch.kernels.tree_predict.ops",
        "repro_torch.configs",
        "repro_torch.configs.base",
        "repro_torch.configs.registry",
        "repro_torch.models",
        "repro_torch.models.layers",
        "repro_torch.models.attention",
        "repro_torch.models.model",
        "repro_torch.kernels.flash_attention.ref",
        "repro_torch.kernels.flash_attention.flash_attention",
        "repro_torch.kernels.flash_attention.ops",
        "repro_torch.launch.steps",
        "repro_torch.launch.serve",
        "repro_torch.models.rwkv6",
        "repro_torch.models.blockwise",
        "repro_torch.models.ssm",
        "repro_torch.models.moe",
        "repro_torch.models.mla",
        "repro_torch.kernels.rwkv6_scan.ref",
        "repro_torch.kernels.rwkv6_scan.rwkv6_scan",
        "repro_torch.kernels.rwkv6_scan.ops",
        "repro_torch.kernels.quantize.ref",
        "repro_torch.kernels.quantize.quantize",
        "repro_torch.kernels.quantize.ops",
        "repro_torch.store.codebook",
        "repro_torch.store.delta",
        "repro_torch.store.lifecycle",
        "repro_torch.store.durable",
        "repro_torch.store.residency",
        "repro_torch.store.streaming",
        "repro_torch.launch.serve_store",
        "repro_torch.launch.serve_forest",
        "repro_torch.sched",
        "repro_torch.sched.clock",
        "repro_torch.sched.queue",
        "repro_torch.sched.batcher",
        "repro_torch.sched.executor",
        "repro_torch.sched.driver",
        "repro_torch.sched.scheduler",
        "repro_torch.optim",
        "repro_torch.optim.adamw",
        "repro_torch.optim.compression",
        "repro_torch.data.tokens",
        "repro_torch.core.tensor_codec",
        "repro_torch.checkpoint",
        "repro_torch.checkpoint.manager",
        "repro_torch.runtime.fault_tolerance",
        "repro_torch.launch.train",
        "repro_torch.models.sharding",
        "repro_torch.models.tensor_parallel",
        "repro_torch.launch.mesh",
        "repro_torch.launch.shardings",
        "repro_torch.launch.specs",
        "repro_torch.launch.dryrun",
        "repro_torch.launch.hlo_stats",
        *(f"repro_torch.configs.{m}" for m in (
            "deepseek_7b", "deepseek_v3_671b", "granite_moe_3b_a800m",
            "hymba_1_5b", "internvl2_76b", "musicgen_large", "qwen2_5_3b",
            "qwen3_4b", "rwkv6_1_6b", "starcoder2_3b")),
    ):
        assert name in mods


def test_importing_every_module_leaves_jax_and_repro_out():
    code = (
        "import importlib, sys\n"
        f"for m in {_port_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "print(repr(bad))\n"
    )
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        env=env, check=True, timeout=300,
    )
    assert out.stdout.strip() == "[]", out.stdout


@pytest.mark.parametrize("where", ["package", "chip_smoke"])
def test_no_jax_or_reference_import_in_source(where):
    if where == "chip_smoke":
        paths = [os.path.join(ROOT, "chip_smoke.py")]
    else:
        paths = [
            os.path.join(d, f)
            for d, _, files in os.walk(PORT) for f in files
            if f.endswith((".py", ".cu"))
        ]
    assert paths
    for path in paths:
        with open(path) as fh:
            text = fh.read()
        assert not FORBIDDEN.search(text), path


def test_chip_smoke_fails_without_the_repo(tmp_path):
    """A directory holding only ``chip_smoke.py`` has no port to import:
    the script exits non-zero and prints no result."""
    lone = tmp_path / "chip_smoke.py"
    with open(os.path.join(ROOT, "chip_smoke.py")) as fh:
        lone.write_text(fh.read())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, str(lone)], capture_output=True, text=True,
        cwd=tmp_path, env=env, timeout=300,
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


# ---------------------------------------------------------------------------
# the public surface, by ``ast`` (no import of jax)
# ---------------------------------------------------------------------------

REFERENCE = os.path.join(SRC, "repro")

#: Where the port's public surface differs from the reference beyond the
#: documented rule (``interpret`` dropped, ``device`` / ``devices``
#: added), and why.  Each entry must still be observed, so a repaired
#: difference leaves this table with it.
KNOWN_DIFFERENCES = {
    # a JAX PRNG key or dtype becomes a torch seed / Generator and the
    # parameter dict being filled
    ("forest/cart.py", "grow_tree"): "PRNG key -> per-node scores",
    ("models/attention.py", "init_attention"): "PRNG key -> Generator",
    ("models/model.py", "init_params"): "PRNG key -> seed",
    ("models/rwkv6.py", "init_rwkv6"): "PRNG key -> Generator",
    ("models/rwkv6.py", "init_channel_mix"): "PRNG key -> Generator",
    ("models/ssm.py", "init_ssm"): "PRNG key -> Generator",
    ("models/mla.py", "init_mla"): "PRNG key -> Generator",
    ("models/moe.py", "init_moe"): "PRNG key -> Generator",
    ("models/layers.py", "init_linear"): "PRNG key -> Generator",
    # Pallas tile sizes: the Hopper kernel picks its own tiling
    ("kernels/flash_attention/flash_attention.py", "flash_attention_bh"):
        "TPU tile sizes",
    ("kernels/flash_attention/ops.py", "flash_attention"): "TPU tile sizes",
    # arguments the port adds: the K8 route switch, the sharded engine's
    # device count (the reference reads jax.device_count()), and the
    # drivers' argv
    ("models/rwkv6.py", "rwkv6_train"): "use_flash added",
    ("models/rwkv6.py", "rwkv6_prefill"): "use_flash added",
    ("serving/plan.py", "choose_engine"): "n_devices added",
    ("serving/plan.py", "build_plan"): "n_devices added",
    ("launch/serve.py", "main"): "argv added",
    ("launch/serve_forest.py", "main"): "argv added",
    ("launch/serve_store.py", "main"): "argv added",
    ("launch/train.py", "main"): "argv added",
    ("launch/dryrun.py", "main"): "argv added",
    # JAX's threefry dither cannot be drawn by a torch.Generator: ``key``
    # is a Generator or a seed, and the draws can be given instead; the
    # collective takes its DeviceMesh (the reference's is implicit in
    # shard_map)
    ("optim/compression.py", "wire_quantized_psum"): "dither= and mesh= added",
    ("launch/steps.py", "make_wire_train_step"): "dither= added",
    # the vocab-parallel cross entropy of tensor-parallel training: a
    # rank's vocab rows of the logits and the global token count (the
    # reference's GSPMD cuts the whole-array loss itself)
    ("models/layers.py", "cross_entropy_loss"): "vocab= and count= added",
    ("models/layers.py", "chunked_ce_loss"): "vocab= and count= added",
}


def _surface(path: str) -> dict:
    """Public functions, classes and their public methods (and
    ``__init__``) of one module, by name; ``__all__`` names count too."""
    with open(path) as fh:
        tree = ast.parse(fh.read())
    out: dict = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "__all__"
                for t in node.targets):
            for name in ast.literal_eval(node.value):
                out.setdefault(name, None)
        if not isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            continue
        if node.name.startswith("_"):
            continue
        out[node.name] = node
        if isinstance(node, ast.ClassDef):
            for sub in node.body:
                if isinstance(sub, ast.FunctionDef) and (
                        not sub.name.startswith("_")
                        or sub.name == "__init__"):
                    out[f"{node.name}.{sub.name}"] = sub
    return out


def _surface_differences() -> dict:
    """{(module, name): what differs} over every module in both packages."""
    found = {}
    for d, _, files in os.walk(REFERENCE):
        for f in files:
            ref_path = os.path.join(d, f)
            rel = os.path.relpath(ref_path, REFERENCE)
            port_path = os.path.join(PORT, rel)
            if not f.endswith(".py") or not os.path.exists(port_path):
                continue
            ref, port = _surface(ref_path), _surface(port_path)
            for name, node in ref.items():
                key = (rel.replace(os.sep, "/"), name.split(".")[0]
                       if name.endswith(".__init__") else name)
                if name not in port:
                    found[key] = "missing"
                    continue
                if not isinstance(node, ast.FunctionDef):
                    continue
                a, b = node.args, port[name].args
                r_pos = [x.arg for x in a.posonlyargs + a.args]
                p_pos = [x.arg for x in b.posonlyargs + b.args]
                r_all = [x for x in r_pos + [x.arg for x in a.kwonlyargs]
                         if x != "interpret"]
                p_all = [x for x in p_pos + [x.arg for x in b.kwonlyargs]
                         if x not in ("device", "devices")]
                if r_all != p_all:
                    found[key] = f"parameters {r_all} -> {p_all}"
                elif "interpret" in r_pos:
                    after = r_pos[r_pos.index("interpret") + 1:]
                    if set(after) & set(p_pos):
                        found[key] = (f"{after} stay positional after the "
                                      f"dropped interpret")
    return found


def test_public_surface_matches_the_reference():
    """Every public name of every module present in both packages exists
    in the port with the same parameter names, ``interpret`` dropped and
    ``device`` / ``devices`` added; the parameters that followed a
    dropped ``interpret`` are keyword-only.  ``KNOWN_DIFFERENCES`` lists
    the rest, each with its reason."""
    found = _surface_differences()
    unexpected = {k: v for k, v in found.items()
                  if k not in KNOWN_DIFFERENCES}
    assert unexpected == {}
    stale = sorted(set(KNOWN_DIFFERENCES) - set(found))
    assert stale == []


def test_positional_interpret_raises_type_error():
    """A call written for the reference that passes ``interpret`` by
    position raises, instead of binding to the next parameter."""
    from repro_torch.serving import ForestServer
    from repro_torch.store import build_store, make_synthetic_fleet

    store = build_store(make_synthetic_fleet(2, n_trees=(2, 3), max_depth=2),
                        device="cpu")
    with pytest.raises(TypeError):
        ForestServer(store, 64, True, device="cpu")
    assert ForestServer(store, 64, device="cpu").max_retries == 3
    xb = torch.zeros((4, 2), dtype=torch.int32)
    seg = np.zeros(4, np.int32)
    heap = np.zeros((1, 3), np.int32)
    args = (xb, seg, np.zeros(1, np.int32), heap, heap,
            heap.astype(np.float32), heap.astype(bool), 1, 0, 8, 256)
    with pytest.raises(TypeError):
        tp.forest_predict_agg_segmented(*args, True)
    with pytest.raises(TypeError):
        tp.forest_predict_agg_segmented(*args, "simple")
    out = tp.forest_predict_agg_segmented(*args, engine="simple")
    assert out.shape == (4,)


def test_heap_children_matches_the_reference():
    """The reference's function, compiled alone from its source (the
    module imports jax), against the port's copy."""
    from repro_torch.forest.cart import heap_children

    with open(os.path.join(REFERENCE, "forest", "cart.py")) as fh:
        tree = ast.parse(fh.read())
    (fn,) = [n for n in tree.body
             if isinstance(n, ast.FunctionDef) and n.name == "heap_children"]
    scope = {"np": np}
    exec(compile(ast.Module([fn], []), "cart.py", "exec"), scope)
    for h in (1, 2, 7, 15, 31, 100):
        for got, want in zip(heap_children(h), scope["heap_children"](h)):
            np.testing.assert_array_equal(got, want)


def test_resolve_device_cpu_and_unknown():
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_resolve_device_cuda_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError):
        resolve_device()


def test_from_forest_default_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    from conftest import random_forest

    from repro_torch.convert import forest_from_arrays
    from repro_torch.serving import ForestServer

    f = random_forest(seed=1, n_trees=3, max_depth=3)
    forest = forest_from_arrays(f.trees, f.meta, f.fit_values)
    with pytest.raises(RuntimeError, match="CUDA"):
        ForestServer.from_forest(forest)


def test_forest_entries_default_to_cuda_and_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    from repro_torch.data.tabular import TabularSpec, make_dataset
    from repro_torch.forest import (
        fit_binner,
        per_tree_predictions,
        predict_forest,
        train_forest,
    )
    from repro_torch.kernels.tree_predict import ops

    x, y, cat = make_dataset(TabularSpec("t", 60, 3, "classification"))
    binner = fit_binner(x, n_bins=8, categorical=cat)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_forest(x, y, binner, n_trees=2, max_depth=2)
    model = train_forest(x, y, binner, n_trees=2, max_depth=2, device="cpu")
    for fn in (predict_forest, per_tree_predictions,
               ops.predict_forest_kernel, ops.predict_forest_kernel_per_tree):
        with pytest.raises(RuntimeError, match="CUDA"):
            fn(model, x)


@pytest.mark.parametrize("driver", ["serve_store", "serve_forest"])
def test_serving_drivers_default_to_cuda_and_raise_without_a_card(driver):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    import importlib

    mod = importlib.import_module(f"repro_torch.launch.{driver}")
    with pytest.raises(RuntimeError, match="CUDA"):
        mod.main([])


def test_kernel_launches_refuse_cpu_tensors():
    """The CUDA launch functions never run a CPU tensor (no silent plain
    fallback), and count nothing when they refuse."""
    xb = torch.zeros((4, 2), dtype=torch.int32)
    seg = torch.zeros(4, dtype=torch.int32)
    code = torch.zeros((8, 3), dtype=torch.float32)
    tseg = torch.zeros(8, dtype=torch.int32)
    rng_ = torch.zeros(1, dtype=torch.int32)
    tp.reset_launches()
    with pytest.raises(ValueError, match="CUDA"):
        tp._launch_seg_packed(
            xb, seg, code, code, tseg, rng_, rng_, 1, 2, 0, 8, 4
        )
    with pytest.raises(ValueError, match="CUDA"):
        tp._launch_seg_simple(
            xb, seg, tseg, code.int(), code.int(), code,
            code.bool(), 1, 0, 8, 4,
        )
    heap = code.int()
    for launch in (tp._launch_agg, tp._launch_per_tree):
        with pytest.raises(ValueError, match="CUDA"):
            launch(xb, heap, heap, code, code.bool(), 1)
    with pytest.raises(ValueError, match="CUDA"):
        tp._launch_seg_sharded(
            [xb], [seg], [code[None]], [code[None]], [tseg[None]],
            [rng_[None]], [rng_[None]], 1, 2, 0, 8, 4,
        )
    assert tp.LAUNCHES == {
        "seg_packed": 0, "seg_simple": 0, "agg": 0, "per_tree": 0,
        "seg_sharded": 0,
    }


def test_entries_need_a_tensor_to_pick_the_device():
    xb = np.zeros((4, 2), np.int32)
    heap = np.zeros((2, 3), np.int32)
    with pytest.raises(TypeError, match="torch.Tensor"):
        tp.forest_predict_agg_segmented(
            xb, np.zeros(4, np.int32), np.zeros(2, np.int32), heap, heap,
            heap.astype(np.float32), heap.astype(bool), max_depth=1,
        )


def test_build_library_path_tracks_source_and_flags():
    from repro_torch.kernels import build

    path = build.library_path("tree_predict")
    assert path.parent == build.BUILD_DIR
    assert path.name.startswith("libtree_predict-") and path.suffix == ".so"
    assert build.library_path("tree_predict") == path  # deterministic
    assert build.BUILD_DIR.parts[-2:] == ("build", "kernels")


def test_every_c_entry_is_declared_and_every_launch_is_counted():
    """The ctypes declarations name exactly the ``extern "C"`` functions of
    the CUDA source (``tp_forest_config`` among them), each declares as
    many ctypes arguments as its C prototype has parameters, and each
    launch function bumps its own counter."""
    import inspect

    src = os.path.join(
        PORT, "kernels", "tree_predict", "csrc", "tree_predict.cu"
    )
    with open(src) as fh:
        text = fh.read()
    c_entries = set(re.findall(r"^(?:int|const char\*) (tp_\w+)\(", text, re.M))
    assert c_entries == set(tp._SIGNATURES)
    assert {"tp_agg", "tp_per_tree", "tp_forest_config"} <= c_entries
    for name in c_entries:
        params = re.search(rf"^(?:int|const char\*) {name}\(([^)]*)\)",
                           text, re.M).group(1)
        assert len(tp._SIGNATURES[name][0]) == len(params.split(",")), name
    for fn, key in ((tp._launch_seg_packed, "seg_packed"),
                    (tp._launch_seg_simple, "seg_simple"),
                    (tp._launch_agg, "agg"),
                    (tp._launch_per_tree, "per_tree"),
                    (tp._launch_seg_sharded, "seg_sharded")):
        body = inspect.getsource(fn)
        assert body.count("LAUNCHES[") == 1
        assert f'LAUNCHES["{key}"] += 1' in body


def test_flash_c_entries_are_declared_and_its_launch_is_counted():
    """``flash_attention.cu``'s ``extern "C"`` functions are exactly the
    ctypes declarations, each (``fa_forward`` among them) declares as many
    ctypes arguments as its C prototype has parameters, and
    ``_launch_flash`` bumps its counter once."""
    import inspect

    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import flash_attention as fa

    src = os.path.join(
        PORT, "kernels", "flash_attention", "csrc", "flash_attention.cu"
    )
    assert build.SOURCES["flash_attention"] == build.Path(src)
    with open(src) as fh:
        text = fh.read()
    c_entries = set(re.findall(r"^(?:int|const char\*) (fa_\w+)\(", text, re.M))
    assert c_entries == set(fa._SIGNATURES) == {
        "fa_forward", "fa_tc_config", "fa_error_string"}
    for name in c_entries:
        params = re.search(rf"^(?:int|const char\*) {name}\(([^)]*)\)",
                           text, re.M).group(1)
        assert len(fa._SIGNATURES[name][0]) == len(params.split(",")), name
    body = inspect.getsource(fa._launch_flash)
    assert body.count("LAUNCHES[") == 1
    assert 'LAUNCHES["flash"] += 1' in body


@pytest.mark.parametrize("name,prefix,key,extra", [
    ("rwkv6_scan", "wkv6", "wkv6", {"wkv6_config"}),
    ("quantize", "quantize", "quantize", set()),
])
def test_wkv6_and_quantize_c_entries_are_declared_and_launches_counted(
        name, prefix, key, extra):
    """``rwkv6_scan.cu`` (K8) and ``quantize.cu`` (K6): the ``extern "C"``
    functions are exactly the ctypes declarations (K8 also reports its
    configuration, ``wkv6_config``), each declares as many ctypes
    arguments as its C prototype has parameters, the source is in
    ``build.SOURCES``, and the launch function bumps its counter once."""
    import importlib
    import inspect

    from repro_torch.kernels import build

    mod = importlib.import_module(f"repro_torch.kernels.{name}.{name}")
    src = os.path.join(PORT, "kernels", name, "csrc", f"{name}.cu")
    assert build.SOURCES[name] == build.Path(src)
    with open(src) as fh:
        text = fh.read()
    c_entries = set(re.findall(
        rf"^(?:int|const char\*) ({prefix}_\w+)\(", text, re.M))
    assert c_entries == set(mod._SIGNATURES) == {
        f"{prefix}_forward", f"{prefix}_error_string"} | extra
    for fn in c_entries:
        params = re.search(rf"^(?:int|const char\*) {fn}\(([^)]*)\)",
                           text, re.M).group(1)
        assert len(mod._SIGNATURES[fn][0]) == len(params.split(",")), fn
    launch = getattr(mod, f"_launch_{prefix}")
    body = inspect.getsource(launch)
    assert body.count("LAUNCHES[") == 1
    assert f'LAUNCHES["{key}"] += 1' in body
    assert set(mod.LAUNCHES) == {key}


def test_flash_launch_refuses_cpu_tensors():
    from repro_torch.kernels.flash_attention import flash_attention as fa

    q = torch.zeros((2, 16, 32))
    fa.reset_launches()
    with pytest.raises(ValueError, match="CUDA"):
        fa._launch_flash(q, q, q)
    assert fa.LAUNCHES == {"flash": 0}


def test_lm_entries_default_to_cuda_and_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    import inspect

    from repro_torch.configs import get_config
    from repro_torch.convert import lm_params_from_arrays
    from repro_torch.launch import serve
    from repro_torch.models import init_cache, init_params

    cfg = get_config("qwen3-4b").smoke()
    assert inspect.signature(init_params).parameters["device"].default == "cuda"
    assert inspect.signature(init_cache).parameters["device"].default == "cuda"
    assert inspect.signature(
        lm_params_from_arrays).parameters["device"].default == "cuda"
    with pytest.raises(RuntimeError, match="CUDA"):
        init_params(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--arch", "qwen3-4b", "--smoke"])
    with pytest.raises(RuntimeError, match="CUDA"):
        lm_params_from_arrays(cfg, {}, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        lm_params_from_arrays(cfg, {})
