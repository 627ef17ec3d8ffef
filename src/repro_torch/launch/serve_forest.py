"""Single-forest serving driver — the port of ``repro.launch.serve_forest``.

Serving goes through the session API:

    from repro_torch.serving import ForestServer
    server = ForestServer.from_forest(comp, device="cuda")
    pred = server.predict(x_binned)

The heap packing helpers (``tree_to_heap`` / ``iter_heap_tiles``) live in
``repro_torch.serving.pack`` and are re-exported here.

    PYTHONPATH=src python -m repro_torch.launch.serve_forest --trees 100 \\
        --depth 8 --rows 5000 --batch 1024 --device cuda

``--device`` defaults to ``cuda`` and raises without a card; ``--device
cpu`` trains, compresses and serves on the CPU (the kernels' plain
versions).
"""
from __future__ import annotations

import argparse
import time
from typing import Sequence

import numpy as np

from ..core.compressed_predict import predict_compressed
from ..core.forest_codec import CompressedForest
from ..serving.pack import iter_heap_tiles, tree_to_heap  # noqa: F401

__all__ = ["iter_heap_tiles", "tree_to_heap"]


def main(argv: Sequence[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--trees", type=int, default=100)
    ap.add_argument("--depth", type=int, default=8)
    ap.add_argument("--rows", type=int, default=5000)
    ap.add_argument("--features", type=int, default=8)
    ap.add_argument("--task", choices=("classification", "regression"),
                    default="classification")
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--block-trees", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from ..core.forest_codec import compress_forest
    from ..data.tabular import TabularSpec, make_dataset
    from ..device import resolve_device
    from ..forest import fit_binner, to_compact_forest, train_forest
    from ..serving import ForestServer

    dev = resolve_device(args.device)
    spec = TabularSpec("serve", args.rows, args.features, args.task, 2, 2)
    x, y, cat = make_dataset(spec, seed=args.seed)
    binner = fit_binner(x, categorical=cat, n_bins=32)
    model = train_forest(
        x, y, binner, n_trees=args.trees, max_depth=args.depth,
        task=args.task, n_classes=2, seed=args.seed, device=dev,
    )
    forest = to_compact_forest(model)
    comp = CompressedForest.from_bytes(
        compress_forest(forest, device=dev).to_bytes()
    )
    blob_bytes = len(comp.to_bytes())
    xb = binner.transform(x)

    server = ForestServer.from_forest(comp, device=dev)
    # warm up (kernel build + arena admission) then measure session serving
    server.predict(xb[: args.batch], block_trees=args.block_trees)
    t0 = time.time()
    pred = server.predict(xb[: args.batch], block_trees=args.block_trees)
    t_serve = time.time() - t0
    ref = predict_compressed(comp, xb[: args.batch], device="cpu")
    agree = float((pred == ref).mean()) if args.task == "classification" \
        else float(np.max(np.abs(pred - ref)))
    print(
        f"forest: {args.trees} trees depth {args.depth} "
        f"({blob_bytes} compressed bytes)\n"
        f"serve {args.batch} rows: {t_serve * 1e3:.1f} ms "
        f"({args.batch / t_serve:.0f} rows/s), "
        f"agreement vs predict_compressed: {agree}\n"
        f"session: {server.stats()['plan_cache']}"
    )


if __name__ == "__main__":
    main()
