#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Phases, in order; any failure propagates and the exit code is non-zero:

1. environment: torch / CUDA versions, the card's name and power limit,
   ``resolve_device("cuda")`` (raises on a host without a card);
2. build: ``nvcc`` compiles the kernels from the checkout's sources into
   ``build/kernels/``;
3. kernel parity: K1 (``tp_seg_packed``) and K2 (``tp_seg_simple``) on the
   card against their plain PyTorch versions on the same CUDA inputs —
   classification (C = 2, 7) and regression, ragged segments, padding
   trees, out-of-range class ids, negative features and thresholds (K2),
   depths 8 and 12, 1,024 trees x 65,536 rows in one case, and blocks
   that need more than 48 KB of shared memory in another;
4. main path: ``ForestServer.from_forest(forest, device="cuda")`` serves a
   seeded synthetic forest (100 trees, depth 8, 8 features, 32 bins) for
   each task through ``predict`` / ``serve`` / ``serve_safe`` and
   ``engine="simple"``, held against ``predict_compressed(device="cpu")``;
   the kernels' launch counts are read around this phase and must be
   positive; then each kernel is held against its plain version at the
   shapes the main path gave it;
5. times: CUDA events, median of 25 after warm-up — each kernel and its
   plain version at the main path's shapes and at the large phase-3 shape;
   then, on the host clock, warm serving ms per 1,024-row batch and its
   stages (plan lookup, pack lookup, the K1 run with its upload and copy
   back, finalize), with K1's share of the batch.

Votes must be equal; regression sums are held at rtol = atol = 1e-5 (the
reference's own serving tolerance).  The line before the last is one JSON
object ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# H100 SXM peaks (NVIDIA's data sheet): HBM3 bytes/s, and float32 outside
# the tensor cores, the rate integer traversal work is counted at.
HBM_BYTES_PER_S = 3.35e12
CUDA_CORE_OPS_PER_S = 67e12
RTOL = ATOL = 1e-5
REPS = 25

K1 = {
    "name": "seg_packed",
    "route": "cuda",
    "source": "src/repro_torch/kernels/tree_predict/csrc/tree_predict.cu",
    "replaces": "src/repro/kernels/tree_predict/tree_predict.py:439",
}
K2 = {
    "name": "seg_simple",
    "route": "cuda",
    "source": "src/repro_torch/kernels/tree_predict/csrc/tree_predict.cu",
    "replaces": "src/repro/kernels/tree_predict/tree_predict.py:268",
}


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

def random_heaps(rng, t, depth, d, n_bins, n_classes, negative):
    """Random heap-form trees: internal nodes with probability 0.8 above
    the last level; negative features / thresholds when ``negative``;
    classification fits in [-1, C + 1] (out-of-range ids included)."""
    h = (1 << (depth + 1)) - 1
    lo_f, hi_f = (-2, d + 2) if negative else (0, d)
    feature = rng.integers(lo_f, hi_f, (t, h)).astype(np.int32)
    threshold = rng.integers(-3 if negative else 0, n_bins, (t, h))
    threshold = threshold.astype(np.int32)
    is_internal = rng.random((t, h)) < 0.8
    is_internal[:, (1 << depth) - 1:] = False
    if n_classes:
        fit = rng.integers(-1, n_classes + 2, (t, h)).astype(np.float32)
    else:
        fit = rng.normal(size=(t, h)).astype(np.float32)
    return feature, threshold, is_internal, fit


def ragged_segments(rng, n, n_segs, sort):
    seg = rng.integers(0, n_segs, n).astype(np.int32)
    return np.sort(seg) if sort else seg


def k1_inputs(dev, case, rng):
    from repro_torch.kernels.tree_predict import tree_predict as tp

    t, depth, d, nb, c, n = (
        case["trees"], case["depth"], 8, 32, case["classes"], case["rows"]
    )
    bt, bo = case.get("k1_blocks", (8, 128))
    feature, threshold, is_internal, fit = random_heaps(
        rng, t, depth, d, nb, c, negative=False
    )
    tb = tp.fused_threshold_base(nb - 1)
    code = tp.fuse_node_attrs(feature, threshold, is_internal, tb)
    t_pad = -(-t // bt) * bt
    tseg = ragged_segments(rng, t, case["segs"], sort=True)
    pad = t_pad - t
    code = np.pad(code, ((0, pad), (0, 0)))
    fit = np.pad(fit, ((0, pad), (0, 0)))
    tseg = np.pad(tseg, (0, pad), constant_values=-1)
    xb = rng.integers(0, nb, (n, d)).astype(np.int32)
    oseg = ragged_segments(rng, n, case["segs"], sort=case["sorted"])
    lo, hi = tp.segment_chunk_ranges(oseg, tseg, bt, bo)

    def T(a, dt):
        return torch.as_tensor(a, dtype=dt, device=dev)

    i32, f32 = torch.int32, torch.float32
    return (
        T(xb, i32), T(oseg, i32), T(code, f32), T(fit, f32), T(tseg, i32),
        T(lo, i32), T(hi, i32), depth, 2 * tb, c, bt, bo,
    )


def k2_inputs(dev, case, rng):
    t, depth, d, nb, c, n = (
        case["trees"], case["depth"], 8, 32, case["classes"], case["rows"]
    )
    feature, threshold, is_internal, fit = random_heaps(
        rng, t, depth, d, nb, c, negative=True
    )
    tseg = ragged_segments(rng, t, case["segs"], sort=True)
    xb = rng.integers(-2, nb, (n, d)).astype(np.int32)
    oseg = ragged_segments(rng, n, case["segs"], sort=case["sorted"])

    def T(a, dt):
        return torch.as_tensor(a, dtype=dt, device=dev)

    bt, bo = case.get("k2_blocks", (32, 256))
    return (
        T(xb, torch.int32), T(oseg, torch.int32), T(tseg, torch.int32),
        T(feature, torch.int32), T(threshold, torch.int32),
        T(fit, torch.float32), T(is_internal, torch.bool), depth, c, bt, bo,
    )


# ---------------------------------------------------------------------------
# checks, bounds, timing
# ---------------------------------------------------------------------------

def max_abs_err(got: torch.Tensor, want: torch.Tensor, n_classes: int) -> float:
    if got.shape != want.shape:
        raise AssertionError(f"shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not bool(torch.isfinite(got).all()):
        raise AssertionError("kernel output has non-finite values")
    err = float((got.double() - want.double()).abs().max()) if got.numel() else 0.0
    if n_classes > 0:
        if not torch.equal(got, want):
            raise AssertionError(f"votes differ from the plain version: {err}")
    elif not torch.allclose(got, want, rtol=RTOL, atol=ATOL):
        raise AssertionError(f"sums differ from the plain version: {err}")
    return err


def k1_parts(args):
    from repro_torch.kernels.tree_predict.tree_predict import _unfuse

    xb, oseg, code, fit, tseg, lo, hi, depth, tb2, c, bt, bo = args
    feature, threshold, is_internal = _unfuse(code, tb2)
    extra = 4 * (lo.numel() + hi.numel())
    return (xb, oseg, tseg, feature, threshold, is_internal, depth, c,
            code.shape[0], 4, extra)


def k2_parts(args):
    xb, oseg, tseg, feature, threshold, fit, is_internal, depth, c, bt, bo = args
    return (xb, oseg, tseg, feature, threshold, is_internal, depth, c,
            feature.shape[0], 9, 0)


def bound(parts) -> tuple[float, str, dict]:
    """Least time for the work these inputs need: bytes of the nodes the
    valid (tree, row) pairs actually visit (read once), the rows they
    read, the segment ids and the output (written once), at HBM rate;
    integer operations (a compare and a child step per level walked, an
    add per pair folded) at the CUDA-core rate.  The larger wins."""
    (xb, oseg, tseg, feature, threshold, is_internal, depth, c, n_real,
     node_bytes, extra_bytes) = parts
    n, d = xb.shape
    t, h = feature.shape
    dev = xb.device
    seen = torch.zeros(t * h, dtype=torch.bool, device=dev)
    seen_leaf = torch.zeros(t * h, dtype=torch.bool, device=dev)
    rows_used = torch.zeros(n, dtype=torch.bool, device=dev)
    steps = pairs = 0
    xb_t = xb.T.contiguous().long()
    for lo in range(0, t, 64):
        hi = min(lo + 64, t)
        ids = torch.arange(lo, hi, device=dev)
        valid = (tseg[lo:hi, None] == oseg[None, :]) & (ids < n_real)[:, None]
        rows_used |= valid.any(0)
        pairs += int(valid.sum())
        idx = torch.zeros((hi - lo, n), dtype=torch.int64, device=dev)
        active = valid.clone()
        base = (ids * h)[:, None]
        for _ in range(depth):
            seen[(base + idx)[active]] = True
            inter = torch.gather(is_internal[lo:hi], 1, idx) & active
            steps += int(inter.sum())
            fe = torch.gather(feature[lo:hi], 1, idx).long().clamp(0, d - 1)
            left = torch.gather(xb_t, 0, fe) <= torch.gather(threshold[lo:hi], 1, idx)
            child = torch.where(left, 2 * idx + 1, 2 * idx + 2)
            idx = torch.where(inter, child, idx)
            active = inter
        seen_leaf[(base + idx)[valid]] = True
    c_out = max(c, 1)
    nbytes = (
        node_bytes * int(seen.sum()) + 4 * int(seen_leaf.sum())
        + 4 * d * int(rows_used.sum()) + 4 * (n + t) + 4 * n * c_out
        + extra_bytes
    )
    ops = 2 * steps + pairs
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / CUDA_CORE_OPS_PER_S
    work = {"bytes": nbytes, "ops": ops, "valid_pairs": pairs}
    if t_bytes >= t_ops:
        return t_bytes * 1e3, "bytes", work
    return t_ops * 1e3, "operations", work


def time_ms(fn, reps: int = REPS) -> float:
    """Median device ms of ``fn`` over ``reps`` CUDA-event-timed calls,
    after warm-up.  A spin kernel before each start event lets the host
    enqueue the call while the card is busy, so host-side wrapper work
    does not show as device time."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_environment():
    from repro_torch.device import resolve_device

    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    log(smi)
    dev = resolve_device("cuda")
    log(f"device {dev} {torch.cuda.get_device_name(dev)}")
    return dev


def phase_build():
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    built = build.build()
    log(f"build: {json.dumps(built)} total {time.perf_counter() - t0:.2f} s")
    for name, text in build.build_logs.items():
        regs = [ln.strip() for ln in text.splitlines() if "registers" in ln]
        log(f"build {name}: {regs}")


PARITY_CASES = [
    {"name": "cls2-d8-large", "classes": 2, "depth": 8, "trees": 1021,
     "rows": 65536, "segs": 37, "sorted": True},
    {"name": "cls7-d12", "classes": 7, "depth": 12, "trees": 203,
     "rows": 5003, "segs": 5, "sorted": False},
    {"name": "reg-d8-large", "classes": 0, "depth": 8, "trees": 1021,
     "rows": 65536, "segs": 37, "sorted": True},
    {"name": "reg-d12", "classes": 0, "depth": 12, "trees": 203,
     "rows": 5003, "segs": 5, "sorted": False},
    # blocks whose pair buffer exceeds the default 48 KB of shared memory
    # (64 KB for K1, 128 KB for K2): the opt-in launch path
    {"name": "cls7-d8-bigblocks", "classes": 7, "depth": 8, "trees": 301,
     "rows": 3001, "segs": 3, "sorted": True, "k1_blocks": (32, 512),
     "k2_blocks": (64, 512)},
]


def phase_parity(dev, results):
    from repro_torch.kernels.tree_predict import tree_predict as tp

    rng = np.random.default_rng(0)
    large = {}
    for case in PARITY_CASES:
        for kern, make, launch, plain in (
            (K1, k1_inputs, tp._launch_seg_packed, tp._seg_packed_plain),
            (K2, k2_inputs, tp._launch_seg_simple, tp._seg_simple_plain),
        ):
            args = make(dev, case, rng)
            got = launch(*args)
            torch.cuda.synchronize()
            want = plain(*args)
            err = max_abs_err(got, want, case["classes"])
            results[kern["name"]]["errs"].append(err)
            log(json.dumps({"parity": kern["name"], "case": case["name"],
                            "out": list(got.shape), "max_abs_err": err}))
            if case["name"] == "cls2-d8-large":
                large[kern["name"]] = args
    return large


def synthetic_forest(task):
    from repro_torch.store.fleet import make_synthetic_fleet

    fleet = make_synthetic_fleet(
        1, task, n_trees=(100, 100), d=8, n_bins=32, max_depth=8, seed=0
    )
    return next(iter(fleet.values()))


def phase_main_path(dev):
    from repro_torch.core.compressed_predict import predict_compressed
    from repro_torch.kernels.tree_predict import tree_predict as tp
    from repro_torch.serving import ForestServer

    rng = np.random.default_rng(1)
    servers = {}
    tp.reset_launches()
    for task in ("classification", "regression"):
        forest = synthetic_forest(task)
        t0 = time.perf_counter()
        server = ForestServer.from_forest(forest, device="cuda")
        comp = server.store.hydrate("forest")
        log(f"{task}: {comp.n_trees} trees depth {comp.max_depth}, "
            f"compressed in {time.perf_counter() - t0:.2f} s")
        x = rng.integers(0, 32, (5000, 8)).astype(np.int32)
        ref = predict_compressed(comp, x, device="cpu")
        on_card = predict_compressed(comp, x, device=dev)
        assert np.array_equal(on_card, ref), "predict_compressed cuda != cpu"

        def check(got, want, what):
            assert got.shape == want.shape and np.isfinite(got).all(), what
            if task == "classification":
                assert np.array_equal(got, want), what
            else:
                np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                                           err_msg=what)

        got = np.concatenate([
            server.predict(x[i:i + 1024]) for i in range(0, len(x), 1024)
        ])
        check(got, ref, f"{task}: predict batches")
        parts = np.array_split(np.arange(len(x)), 4)
        preds = server.serve([("forest", x[p]) for p in parts])
        for p, pred in zip(parts, preds):
            check(pred, ref[p], f"{task}: serve")
        statuses = server.serve_safe([("forest", x[:1024])])
        assert statuses[0].status == "ok" and not statuses[0].degraded
        check(statuses[0].prediction, ref[:1024], f"{task}: serve_safe")
        check(server.predict(x, engine="simple"), ref, f"{task}: simple")
        log(f"{task}: predict / serve / serve_safe / simple match "
            f"predict_compressed on {len(x)} rows; engines "
            f"{dict(server.engine_counts)}")
        servers[task] = (server, x)
    launches = dict(tp.LAUNCHES)
    log(f"main-path launches: {json.dumps(launches)}")
    for name, count in launches.items():
        assert count > 0, f"kernel {name} was not launched on the main path"
    return servers, launches


def main_path_args(server, x):
    """The inputs the main path gives each kernel for one 1,024-row batch:
    K1's from the server's gathered pack, K2's first tree chunk."""
    from repro_torch.serving.pack import pack_host_tiles
    from repro_torch.serving.plan import ENGINE_BLOCKS

    dev = server.device
    store = server.store
    c = store.shared.n_classes if store.shared.task == "classification" else 0
    xb = x[:1024]
    plan = server.plan([("forest", xb)])
    pack = server._gathered_pack(plan)

    def T(a, dt=torch.int32):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dt, device=dev)

    k1 = (T(xb[plan.order]), T(plan.oseg_s), pack.code, pack.fit,
          T(pack.tree_seg), T(pack.chunk_lo), T(pack.chunk_hi),
          pack.max_depth, store.arena.tb2, c, plan.engine.block_trees,
          pack.block_obs)
    bt, bo = ENGINE_BLOCKS["simple"]
    (feat, thr, fit, inter, tseg), depth, _ = pack_host_tiles(
        store, ["forest"], bt
    )
    k2 = (T(xb), T(np.zeros(len(xb))), T(tseg[:bt]), T(feat[:bt]),
          T(thr[:bt]), T(fit[:bt], torch.float32), T(inter[:bt], torch.bool),
          depth, c, bt, min(bo, len(xb)))
    return k1, k2


def main() -> None:
    dev = phase_environment()
    phase_build()
    from repro_torch.kernels.tree_predict import tree_predict as tp

    results = {K1["name"]: {"errs": []}, K2["name"]: {"errs": []}}
    large = phase_parity(dev, results)
    servers, launches = phase_main_path(dev)

    kinds = (
        (K1, tp._launch_seg_packed, tp._seg_packed_plain, k1_parts),
        (K2, tp._launch_seg_simple, tp._seg_simple_plain, k2_parts),
    )
    out = []
    for idx, (kern, launch, plain, parts) in enumerate(kinds):
        entry = dict(kern)
        entry["launches"] = launches[kern["name"]]
        per_task = {}
        for task, (server, x) in servers.items():
            args = main_path_args(server, x)[idx]
            got = launch(*args)
            torch.cuda.synchronize()
            err = max_abs_err(got, plain(*args), args[-3])
            results[kern["name"]]["errs"].append(err)
            bms, by, work = bound(parts(args))
            per_task[task] = {
                "shape": {"rows": args[0].shape[0],
                          "trees": int(args[2 if idx == 0 else 3].shape[0]),
                          "heap": int(args[2 if idx == 0 else 3].shape[1])},
                "ms": time_ms(lambda: launch(*args)),
                "plain_ms": time_ms(lambda: plain(*args)),
                "bound_ms": bms, "bound_by": by, "work": work,
            }
        main = per_task["classification"]
        entry.update({
            "max_abs_err": max(results[kern["name"]]["errs"]),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": None,
            "library_note": "no single PyTorch call computes a tree "
                            "traversal",
            "timed_at": "one 1,024-row main-path batch, classification",
            "main_path": per_task,
        })
        args = large[kern["name"]]
        bms, by, work = bound(parts(args))
        entry["large"] = {
            "case": "cls2-d8-large",
            "rows": args[0].shape[0],
            "trees": int(args[2 if idx == 0 else 3].shape[0]),
            "ms": time_ms(lambda: launch(*args)),
            "plain_ms": time_ms(lambda: plain(*args), reps=20),
            "bound_ms": bms, "bound_by": by, "work": work,
        }
        out.append(entry)

    from repro_torch.serving import engines

    for task, (server, x) in servers.items():
        batch = x[:1024]
        requests = [("forest", batch)]
        server.predict(batch)
        stages = {k: [] for k in ("plan", "pack", "run", "finalize", "total")}
        for _ in range(REPS):
            t0 = time.perf_counter()
            server.predict(batch)
            t1 = time.perf_counter()
            plan = server.plan(requests)
            t2 = time.perf_counter()
            pack = server._gathered_pack(plan)
            t3 = time.perf_counter()
            total = engines.run_pipelined(server.store, plan, pack, batch)
            t4 = time.perf_counter()
            server._finalize(plan, total)
            t5 = time.perf_counter()
            for k, dt in zip(stages, (t2 - t1, t3 - t2, t4 - t3, t5 - t4,
                                      t1 - t0)):
                stages[k].append(dt * 1e3)
        med = {k: float(np.median(v)) for k, v in stages.items()}
        kernel_ms = out[0]["main_path"][task]["ms"]
        log(json.dumps({
            "serving": task, "batch_rows": len(batch),
            "warm_ms_per_batch": med["total"],
            "rows_per_s": len(batch) / med["total"] * 1e3,
            "stage_ms": {k: med[k] for k in ("plan", "pack", "run",
                                             "finalize")},
            "k1_ms": kernel_ms,
            "k1_share_of_batch": kernel_ms / med["total"],
        }))
    log(json.dumps({"kernels": out}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)


if __name__ == "__main__":
    main()
