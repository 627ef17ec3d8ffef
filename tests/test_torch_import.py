"""The port's package boundary: ``repro_torch`` and ``chip_smoke.py`` never
touch JAX or the reference package, the device is explicit, and a CUDA
entry never falls back to the CPU."""
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
        "repro_torch.kernels.rwkv6_scan.ref",
        "repro_torch.kernels.rwkv6_scan.rwkv6_scan",
        "repro_torch.kernels.rwkv6_scan.ops",
        "repro_torch.kernels.quantize.ref",
        "repro_torch.kernels.quantize.quantize",
        "repro_torch.kernels.quantize.ops",
        "repro_torch.store.codebook",
        "repro_torch.store.delta",
        "repro_torch.store.lifecycle",
        "repro_torch.launch.serve_store",
        "repro_torch.launch.serve_forest",
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
            [xb] * 2, [seg] * 2, [code] * 2, [code] * 2, [tseg] * 2,
            [rng_] * 2, [rng_] * 2, 1, 2, 0, 8, 4,
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
