"""Dry-run estimator: every (architecture x input shape) cell on the
production meshes, with NO allocation (``meta`` tensors only), recording
per-device memory and FLOP estimates — the port of
``repro.launch.dryrun``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-4b \\
        --shape train_4k --multi-pod

The reference lowers and compiles each cell through XLA on 512 forced
host devices and reads the compiled module.  The port has no XLA to
lower through, so it estimates (``"estimator": "torch-meta"``):

  * per-device argument bytes from the specs: each leaf's bytes over the
    product of the sizes of the mesh axes that shard it
    (``launch.specs.input_specs`` on a ``launch.mesh.AbstractMesh``);
  * the step's FLOPs, counted by ``torch.utils.flop_counter
    .FlopCounterMode`` while the step runs on the ``meta`` arguments
    (the whole global step, without a mesh: no head padding, the dense
    MoE dispatch), over the device count;
  * the roofline terms from those, with the H100's peak rates.

The fields that only a compiled XLA module gives (``temp_bytes``,
``hlo_bytes``, the collectives and their top sites,
``cost_analysis_naive``) are ``null``.  A cell whose step FlopCounterMode
cannot trace on ``meta`` tensors is recorded as ``failed`` with the
error, as the reference records a failing cell.
"""
from __future__ import annotations

import argparse
import json
import time
import traceback
from pathlib import Path

import torch

from ..configs.base import SHAPES, ShapeConfig
from ..configs.registry import ARCHITECTURES, get_config
from ..optim.adamw import AdamWConfig
from . import specs as specs_mod
from .mesh import AbstractMesh, production_shape
from .shardings import to_named
from .steps import make_decode_step, make_prefill_step, make_train_step

__all__ = ["applicable", "cell_name", "main", "model_flops", "run_cell"]

# H100 SXM5 hardware model for the roofline terms (NVIDIA's H100 data
# sheet): dense bf16 tensor-core FLOP/s, HBM3 bytes/s, and NVLink 4's
# 900 GB/s per card counted one direction
PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
LINK_BW = 450e9

DEFAULT_OUT = Path("experiments/dryrun")


def applicable(cfg, shape: ShapeConfig) -> bool:
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False  # quadratic attention at 500k is exactly what we skip
    return True


def model_flops(cfg, shape: ShapeConfig) -> float:
    """Analytic useful FLOPs for the cell (6ND train / 2ND inference)."""
    n = cfg.n_active_params()
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch  # decode: one token per sequence


def cell_name(arch: str, shape: str, multi_pod: bool) -> str:
    return f"{arch}__{shape}__{'pod2' if multi_pod else 'pod1'}"


def _leaves(args, specs):
    """(tensor, NamedSharding) pairs of matching arg / sharding trees; a
    module stands for its ``{name: parameter}``."""
    if isinstance(args, torch.nn.Module):
        args = dict(args.named_parameters())
    if isinstance(args, torch.Tensor):
        yield args, specs
    elif isinstance(args, dict):
        for k, v in args.items():
            yield from _leaves(v, specs[k])
    elif isinstance(args, (list, tuple)):
        for v, s in zip(args, specs, strict=True):
            yield from _leaves(v, s)


def argument_bytes(args, shardings) -> int:
    """Per-device bytes of the step's arguments: each leaf's shard."""
    total = 0
    for t, sh in _leaves(args, shardings):
        n = 1
        for d in sh.shard_shape(tuple(t.shape)):
            n *= d
        total += n * t.element_size()
    return total


def _step_flops(cfg, shape: ShapeConfig, args, remat) -> float:
    """FLOPs of one global step on the ``meta`` arguments."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with counter:
        if shape.kind == "train":
            make_train_step(cfg, AdamWConfig(), remat=remat)(*args)
        elif shape.kind == "prefill":
            make_prefill_step(cfg)(*args)
        else:
            make_decode_step(cfg)(*args)
    return float(counter.get_total_flops())


def run_cell(
    arch: str,
    shape_name: str,
    multi_pod: bool,
    out_dir: Path,
    *,
    remat: str | None = "full",
    label: str | None = None,
) -> dict:
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    name = label or cell_name(arch, shape_name, multi_pod)
    if not applicable(cfg, shape):
        return {"cell": name, "status": "skipped",
                "reason": "full attention at 500k context (see DESIGN.md)"}

    t0 = time.time()
    mesh = AbstractMesh(*production_shape(multi_pod))
    args, in_pspecs = specs_mod.input_specs(cfg, shape, mesh)
    arg_bytes = argument_bytes(args, to_named(mesh, in_pspecs))
    flops = _step_flops(cfg, shape, args, remat)
    n_dev = mesh.size
    flops_dev = flops / n_dev
    mf = model_flops(cfg, shape)

    rec = {
        "cell": name,
        "arch": arch,
        "shape": shape_name,
        "kind": shape.kind,
        "multi_pod": multi_pod,
        "n_devices": int(n_dev),
        "status": "ok",
        "estimator": "torch-meta",
        "compile_s": None,
        "trace_s": round(time.time() - t0, 1),
        "memory": {
            "argument_bytes": arg_bytes,
            "output_bytes": None,
            "temp_bytes": None,
            "alias_bytes": None,
            "peak_bytes": None,
        },
        "per_device": {
            "hlo_flops": None,
            "hlo_bytes": None,
            "collective_bytes": None,
            "flops": flops_dev,
            "flops_basis": "global step / n_devices (no head padding, "
                           "dense MoE dispatch)",
        },
        "collectives": None,
        "top_collective_sites": None,
        "cost_analysis_naive": None,
        "roofline_s": {
            "compute": flops_dev / PEAK_FLOPS,
            "memory": arg_bytes / HBM_BW,  # the arguments read once
            "collective": None,
        },
        "hardware": {"peak_flops": PEAK_FLOPS, "hbm_bw": HBM_BW,
                     "link_bw": LINK_BW, "source": "H100 SXM5 data sheet"},
        "model_flops_global": mf,
        "model_flops_per_device": mf / n_dev,
        "useful_flop_fraction": (mf / n_dev) / flops_dev if flops_dev else 0.0,
        "remat": remat,
    }
    terms = {k: v for k, v in rec["roofline_s"].items() if v is not None}
    rec["bottleneck"] = max(terms, key=terms.get)
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", choices=sorted(ARCHITECTURES), default=None)
    ap.add_argument("--shape", choices=sorted(SHAPES), default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true",
                    help="run each cell on the 16x16 AND 2x16x16 meshes")
    ap.add_argument("--all", action="store_true", help="every cell")
    ap.add_argument("--remat", default="full", choices=["full", "dots", "none"])
    ap.add_argument("--out", type=Path, default=DEFAULT_OUT)
    args = ap.parse_args(argv)

    remat = None if args.remat == "none" else args.remat
    args.out.mkdir(parents=True, exist_ok=True)

    archs = [args.arch] if args.arch else sorted(ARCHITECTURES)
    shapes = [args.shape] if args.shape else sorted(SHAPES)
    meshes = [False, True] if (args.both_meshes or args.all) else [args.multi_pod]

    n_ok = n_skip = n_fail = 0
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                name = cell_name(arch, shape, mp)
                path = args.out / f"{name}.json"
                try:
                    rec = run_cell(arch, shape, mp, args.out, remat=remat)
                except Exception as e:  # a failing cell is a bug; record it
                    rec = {"cell": name, "status": "failed",
                           "estimator": "torch-meta",
                           "error": f"{type(e).__name__}: {e}",
                           "traceback": traceback.format_exc()}
                path.write_text(json.dumps(rec, indent=1))
                st = rec["status"]
                n_ok += st == "ok"
                n_skip += st == "skipped"
                n_fail += st == "failed"
                if st == "ok":
                    m = rec["memory"]["argument_bytes"] / 2**30
                    r = rec["roofline_s"]
                    print(
                        f"[ok]   {name:55s} {rec['trace_s']:7.1f}s "
                        f"args {m:6.2f} GiB/dev  "
                        f"c={r['compute']:.3e} m={r['memory']:.3e} "
                        f"-> {rec['bottleneck']}",
                        flush=True,
                    )
                else:
                    print(f"[{st[:4]}] {name:55s} "
                          f"{rec.get('reason', rec.get('error', ''))[:90]}",
                          flush=True)
    print(f"done: {n_ok} ok, {n_skip} skipped, {n_fail} failed", flush=True)
    if n_fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
