#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Phases, in order; any failure propagates and the exit code is non-zero:

1. environment: torch / CUDA versions, the card's name and power limit,
   ``resolve_device("cuda")`` (raises on a host without a card);
2. build: ``nvcc`` compiles the kernels from the checkout's sources into
   ``build/kernels/``;
3. kernel parity: K1 (``tp_seg_packed``), K2 (``tp_seg_simple``), K3
   (``tp_agg``) and K4 (``tp_per_tree``) on the card against their plain
   PyTorch versions on the same CUDA inputs — classification (C = 2, 3,
   7) and regression, ragged segments (K1, K2), padding trees,
   out-of-range class ids, negative features and thresholds (K2-K4),
   depths 8 and 12, 1,021 trees x 65,536 rows in one case, blocks that
   need more than 48 KB of shared memory in another, and ``max_depth``
   two levels past the heap in two more;
4. main path: ``ForestServer.from_forest(forest, device="cuda")`` serves a
   seeded synthetic forest (100 trees, depth 8, 8 features, 32 bins) for
   each task through ``predict`` / ``serve`` / ``serve_safe`` and
   ``engine="simple"``, held against ``predict_compressed(device="cpu")``;
   K1's and K2's launch counts are read around this phase and must be
   positive; then each is held against its plain version at the shapes
   the main path gave it;
5. training path (the paper's pipeline): for each task, the Liberty
   shape of Table 1 (``liberty_cls`` / ``liberty_reg``: 50,999 rows, 32
   variables of which 16 categorical, 64 bins, depth 12, heaps of 8,191
   nodes; 100 trees where the paper has 1,000) —
   ``train_forest(device="cuda")``; ``predict_forest`` against
   ``predict_forest_kernel`` (K3) and ``per_tree_predictions`` against
   ``predict_forest_kernel_per_tree`` (K4); ``to_compact_forest`` ->
   ``compress_forest`` on the card and on the CPU, bytes equal;
   ``predict_compressed`` against ``predict_forest``; exact
   decompression; on the regression forest the §7 knobs
   (``subsample_trees``, ``quantize_fits``) recompressed.  K3 / K4 launch
   counts are read around this phase and must be positive; then each is
   held against its plain version at the shapes the phase gave it;
6. training on the card against training on the CPU, same seed, a small
   forest at the Liberty width: classification trees equal; regression
   trees equal up to tie flips whose float64 gains differ by <= 1e-5
   relative (``forest.compare.first_divergence``);
7. times: CUDA events, median of 25 after warm-up — each kernel and its
   plain version at its main path's shapes and at the large phase-3 shape;
   then, on the host clock, warm serving ms per 1,024-row batch and its
   stages (plan lookup, pack lookup, the K1 run with its upload and copy
   back, finalize), with K1's share of the batch.

Votes must be equal; regression sums are held at rtol = atol = 1e-5 (the
reference's own serving tolerance); on the card every kernel equals its
plain version bit for bit.  The line before the last is one JSON object
``{"kernels": [...]}``; the last line is ``{"ok": true, "device": {...}}``.
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
K3 = {
    "name": "agg",
    "route": "cuda",
    "source": "src/repro_torch/kernels/tree_predict/csrc/tree_predict.cu",
    "replaces": "src/repro/kernels/tree_predict/tree_predict.py:173",
}
K4 = {
    "name": "per_tree",
    "route": "cuda",
    "source": "src/repro_torch/kernels/tree_predict/csrc/tree_predict.cu",
    "replaces": "src/repro/kernels/tree_predict/tree_predict.py:158",
}

# Table 1's Liberty configuration (benchmarks/table1_liberty.py, full
# mode), cut from 1,000 trees to TRAIN_TREES for the run's time limit.
LIBERTY = {"classification": "liberty_cls", "regression": "liberty_reg"}
TRAIN_TREES = 100
TRAIN_DEPTH = 12
TRAIN_BINS = 64
# card-vs-CPU training: a small forest at the Liberty width
SMALL = {"rows": 4000, "trees": 8, "depth": 8}
GAIN_RTOL = 1e-5


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

def random_heaps(rng, t, depth, d, n_bins, n_classes, negative,
                 past_heap=False):
    """Random heap-form trees: internal nodes with probability 0.8 above
    the last level (on it too when ``past_heap``, so walks deeper than the
    heap leave it); negative features / thresholds when ``negative``;
    classification fits in [-1, C + 1] (out-of-range ids included)."""
    h = (1 << (depth + 1)) - 1
    lo_f, hi_f = (-2, d + 2) if negative else (0, d)
    feature = rng.integers(lo_f, hi_f, (t, h)).astype(np.int32)
    threshold = rng.integers(-3 if negative else 0, n_bins, (t, h))
    threshold = threshold.astype(np.int32)
    is_internal = rng.random((t, h)) < 0.8
    if not past_heap:
        is_internal[:, (1 << depth) - 1:] = False
    if n_classes:
        fit = rng.integers(-1, n_classes + 2, (t, h)).astype(np.float32)
    else:
        fit = rng.normal(size=(t, h)).astype(np.float32)
    return feature, threshold, is_internal, fit


def ragged_segments(rng, n, n_segs, sort):
    seg = rng.integers(0, n_segs, n).astype(np.int32)
    return np.sort(seg) if sort else seg


def walk_depth(case):
    """``max_depth`` of a case: two levels past the heap when it asks."""
    return case["depth"] + (2 if case.get("past_heap") else 0)


def k1_inputs(dev, case, rng):
    from repro_torch.kernels.tree_predict import tree_predict as tp

    t, depth, d, nb, c, n = (
        case["trees"], case["depth"], 8, 32, case["classes"], case["rows"]
    )
    bt, bo = case.get("k1_blocks", (8, 128))
    feature, threshold, is_internal, fit = random_heaps(
        rng, t, depth, d, nb, c, negative=False,
        past_heap=case.get("past_heap", False),
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
        T(lo, i32), T(hi, i32), walk_depth(case), 2 * tb, c, bt, bo,
    )


def k2_inputs(dev, case, rng):
    t, depth, d, nb, c, n = (
        case["trees"], case["depth"], 8, 32, case["classes"], case["rows"]
    )
    feature, threshold, is_internal, fit = random_heaps(
        rng, t, depth, d, nb, c, negative=True,
        past_heap=case.get("past_heap", False),
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
        T(fit, torch.float32), T(is_internal, torch.bool), walk_depth(case),
        c, bt, bo,
    )


def forest_inputs(dev, case, rng):
    """K3 / K4 inputs: K2's random heaps (negative features and
    thresholds, out-of-range class ids) without segments."""
    t, depth, d, nb, c, n = (
        case["trees"], case["depth"], 8, 32, case["classes"], case["rows"]
    )
    feature, threshold, is_internal, fit = random_heaps(
        rng, t, depth, d, nb, c, negative=True,
        past_heap=case.get("past_heap", False),
    )
    xb = rng.integers(-2, nb, (n, d)).astype(np.int32)

    def T(a, dt):
        return torch.as_tensor(a, dtype=dt, device=dev)

    return (
        T(xb, torch.int32), T(feature, torch.int32), T(threshold, torch.int32),
        T(fit, torch.float32), T(is_internal, torch.bool), walk_depth(case),
    )


def k3_inputs(dev, case, rng):
    return (*forest_inputs(dev, case, rng), case["classes"], 8, 256)


def k4_inputs(dev, case, rng):
    return (*forest_inputs(dev, case, rng), 8, 256)


# ---------------------------------------------------------------------------
# checks, bounds, timing
# ---------------------------------------------------------------------------

def max_abs_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """The kernel's output must equal its plain version's bit for bit
    (same summation order); returns the max abs difference (0.0)."""
    if got.shape != want.shape:
        raise AssertionError(f"shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not bool(torch.isfinite(got).all()):
        raise AssertionError("kernel output has non-finite values")
    err = float((got.double() - want.double()).abs().max()) if got.numel() else 0.0
    if not torch.equal(got, want):
        raise AssertionError(f"kernel differs from its plain version: {err}")
    return err


def k1_parts(args):
    from repro_torch.kernels.tree_predict.tree_predict import _unfuse

    xb, oseg, code, fit, tseg, lo, hi, depth, tb2, c, bt, bo = args
    feature, threshold, is_internal = _unfuse(code, tb2)
    return dict(
        xb=xb, oseg=oseg, tseg=tseg, feature=feature, threshold=threshold,
        is_internal=is_internal, depth=depth, n_real=code.shape[0],
        node_bytes=4,
        extra_bytes=4 * (oseg.numel() + tseg.numel() + lo.numel() + hi.numel()),
        out_elems=xb.shape[0] * max(c, 1),
    )


def k2_parts(args):
    xb, oseg, tseg, feature, threshold, fit, is_internal, depth, c, bt, bo = args
    return dict(
        xb=xb, oseg=oseg, tseg=tseg, feature=feature, threshold=threshold,
        is_internal=is_internal, depth=depth, n_real=feature.shape[0],
        node_bytes=9, extra_bytes=4 * (oseg.numel() + tseg.numel()),
        out_elems=xb.shape[0] * max(c, 1),
    )


def k3_parts(args):
    xb, feature, threshold, fit, is_internal, depth, c, bt, bo = args
    return dict(
        xb=xb, oseg=None, tseg=None, feature=feature, threshold=threshold,
        is_internal=is_internal, depth=depth, n_real=feature.shape[0],
        node_bytes=9, extra_bytes=0, out_elems=xb.shape[0] * max(c, 1),
    )


def k4_parts(args):
    xb, feature, threshold, fit, is_internal, depth, bt, bo = args
    return dict(
        xb=xb, oseg=None, tseg=None, feature=feature, threshold=threshold,
        is_internal=is_internal, depth=depth, n_real=feature.shape[0],
        node_bytes=9, extra_bytes=0,
        out_elems=feature.shape[0] * xb.shape[0],
    )


def bound(parts) -> tuple[float, str, dict]:
    """Least time for the work these inputs need: bytes of the nodes the
    valid (tree, row) pairs actually visit (read once), the rows they
    read, the segment ids and chunk ranges (``extra_bytes``) and the
    output (written once), at HBM rate; integer operations (a compare and
    a child step per level walked, an add per pair folded) at the
    CUDA-core rate.  The larger wins.  ``oseg = tseg = None``: every tree
    below ``n_real`` meets every row (K3, K4)."""
    xb, oseg, tseg = parts["xb"], parts["oseg"], parts["tseg"]
    feature, threshold = parts["feature"], parts["threshold"]
    is_internal, n_real = parts["is_internal"], parts["n_real"]
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
        valid = (ids < n_real)[:, None].expand(hi - lo, n)
        if tseg is not None:
            valid = valid & (tseg[lo:hi, None] == oseg[None, :])
        rows_used |= valid.any(0)
        pairs += int(valid.sum())
        idx = torch.zeros((hi - lo, n), dtype=torch.int64, device=dev)
        active = valid.clone()
        base = (ids * h)[:, None]
        for _ in range(parts["depth"]):
            seen[(base + idx)[active]] = True
            inter = torch.gather(is_internal[lo:hi], 1, idx) & active
            steps += int(inter.sum())
            fe = torch.gather(feature[lo:hi], 1, idx).long().clamp(0, d - 1)
            left = torch.gather(xb_t, 0, fe) <= torch.gather(threshold[lo:hi], 1, idx)
            child = torch.where(left, 2 * idx + 1, 2 * idx + 2)
            idx = torch.where(inter, child, idx)
            active = inter
        seen_leaf[(base + idx)[valid]] = True
    nbytes = (
        parts["node_bytes"] * int(seen.sum()) + 4 * int(seen_leaf.sum())
        + 4 * d * int(rows_used.sum()) + parts["extra_bytes"]
        + 4 * parts["out_elems"]
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
    # max_depth two levels past the heap, internal nodes on its last level:
    # walks leave the heap and read zero words
    {"name": "cls3-d8-past-heap", "classes": 3, "depth": 8, "trees": 99,
     "rows": 2001, "segs": 3, "sorted": False, "past_heap": True},
    {"name": "reg-d8-past-heap", "classes": 0, "depth": 8, "trees": 99,
     "rows": 2001, "segs": 3, "sorted": False, "past_heap": True},
]


def kernel_table():
    """(description, launch, plain version, parts) of K1-K4."""
    from repro_torch.kernels.tree_predict import tree_predict as tp

    return (
        (K1, tp._launch_seg_packed, tp._seg_packed_plain, k1_parts),
        (K2, tp._launch_seg_simple, tp._seg_simple_plain, k2_parts),
        (K3, tp._launch_agg, tp._agg_plain_unseg, k3_parts),
        (K4, tp._launch_per_tree, tp._per_tree_plain, k4_parts),
    )


def phase_parity(dev, errs):
    """Every kernel against its plain version on the same CUDA inputs, at
    every case of PARITY_CASES (errors appended to ``errs[name]``).
    Returns each kernel's inputs at the large classification case."""
    rng = np.random.default_rng(0)
    makers = {"seg_packed": k1_inputs, "seg_simple": k2_inputs,
              "agg": k3_inputs, "per_tree": k4_inputs}
    large = {}
    for case in PARITY_CASES:
        for kern, launch, plain, _ in kernel_table():
            args = makers[kern["name"]](dev, case, rng)
            got = launch(*args)
            torch.cuda.synchronize()
            err = max_abs_err(got, plain(*args))
            errs[kern["name"]].append(err)
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
    for name in (K1["name"], K2["name"]):
        assert launches[name] > 0, f"kernel {name} was not launched on the main path"
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
    return {K1["name"]: k1, K2["name"]: k2}


# ---------------------------------------------------------------------------
# the training path
# ---------------------------------------------------------------------------

def liberty(task, max_obs=None):
    """Table 1's Liberty data for ``task`` (seed 0), capped at ``max_obs``
    rows, with its 64-bin binner."""
    from repro_torch.data.tabular import make_dataset, scaled, spec_by_name
    from repro_torch.forest import fit_binner

    spec = spec_by_name(LIBERTY[task])
    if max_obs:
        spec = scaled(spec, max_obs)
    x, y, cat = make_dataset(spec, seed=0)
    return spec, x, y, fit_binner(x, n_bins=TRAIN_BINS, categorical=cat)


def check_pred(task, got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.isfinite(got.astype(np.float64)).all(), what
    if task == "classification":
        assert np.array_equal(got, want), what
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                                   err_msg=what)


def first_byte_difference(card, cpu) -> dict:
    """Where two compressions of one forest part: the first component whose
    cluster map or cluster count differs, and its first differing key."""
    comps = [("var_names", card.vars_comp, cpu.vars_comp)]
    comps += [(f"split_values[{v}]", card.splits_comp[v], cpu.splits_comp[v])
              for v in sorted(card.splits_comp)]
    comps.append(("fits", card.fits_comp, cpu.fits_comp))
    for name, a, b in comps:
        ka, kb = a.kid_to_cluster, b.kid_to_cluster
        if len(a.codebook_lengths) != len(b.codebook_lengths) or not (
            np.array_equal(ka, kb)
        ):
            keys = np.nonzero(ka != kb)[0]
            return {"component": name,
                    "clusters": [len(a.codebook_lengths),
                                 len(b.codebook_lengths)],
                    "first_key": int(keys[0]) if len(keys) else None}
    return {"component": None}


def compress_on_card_and_cpu(forest, dev, what):
    """``compress_forest`` on the card and on the CPU; the bytes must be
    equal (the CPU bytes equal the reference's)."""
    from repro_torch.core import compress_forest

    t0 = time.perf_counter()
    comp = compress_forest(forest, device=dev)
    t1 = time.perf_counter()
    cpu = compress_forest(forest, device="cpu")
    t2 = time.perf_counter()
    blob, cpu_blob = comp.to_bytes(), cpu.to_bytes()
    info = {"bytes": len(blob), "card_compress_s": t1 - t0,
            "cpu_compress_s": t2 - t1}
    if blob != cpu_blob:
        info.update(cpu_bytes=len(cpu_blob), **first_byte_difference(comp, cpu))
        log(json.dumps({"byte_mismatch": what, **info}))
        raise AssertionError(f"{what}: card and CPU compressed bytes differ")
    return comp, info


def phase_training(dev):
    """The paper's pipeline on the card for each task (module docstring,
    phase 5).  Returns {task: (model, x)} and the K3 / K4 launch counts of
    this phase."""
    from repro_torch.core import decompress_forest, predict_compressed
    from repro_torch.forest import (
        per_tree_predictions,
        predict_forest,
        to_compact_forest,
        train_forest,
    )
    from repro_torch.kernels.tree_predict import ops
    from repro_torch.kernels.tree_predict import tree_predict as tp

    models = {}
    tp.reset_launches()
    for task in LIBERTY:
        spec, x, y, binner = liberty(task)
        row = {"training": task, "rows": len(x), "vars": x.shape[1],
               "categorical": int(binner.categorical.sum()),
               "bins": TRAIN_BINS, "trees": TRAIN_TREES, "depth": TRAIN_DEPTH}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model = train_forest(
            x, y, binner, n_trees=TRAIN_TREES, max_depth=TRAIN_DEPTH,
            task=task, n_classes=spec.n_classes, seed=0, device=dev,
        )
        row["train_s"] = time.perf_counter() - t0
        assert model.feature.shape == (TRAIN_TREES, (1 << (TRAIN_DEPTH + 1)) - 1)
        row["nodes"] = int(model.is_internal.sum() * 2 + TRAIN_TREES)

        t0 = time.perf_counter()
        pred = predict_forest(model, x, device=dev)
        row["predict_forest_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        check_pred(task, ops.predict_forest_kernel(model, x, device=dev),
                   pred, f"{task}: K3 against predict_forest")
        row["predict_forest_kernel_s"] = time.perf_counter() - t0
        if task == "classification":
            row["train_accuracy"] = float((pred == y).mean())
        else:
            row["train_r2"] = 1.0 - float(((pred - y) ** 2).mean() / y.var())
        per_tree = per_tree_predictions(model, x, device=dev)
        k4 = ops.predict_forest_kernel_per_tree(model, x, device=dev)
        assert k4.shape == per_tree.shape
        assert np.array_equal(k4, per_tree.astype(np.float32)), (
            f"{task}: K4 against per_tree_predictions"
        )

        t0 = time.perf_counter()
        forest = to_compact_forest(model)
        row["compact_s"] = time.perf_counter() - t0
        comp, info = compress_on_card_and_cpu(forest, dev, task)
        row.update(info)
        xb = binner.transform(x)
        t0 = time.perf_counter()
        check_pred(task, predict_compressed(comp, xb, device=dev), pred,
                   f"{task}: predict_compressed against predict_forest")
        row["predict_compressed_s"] = time.perf_counter() - t0
        assert decompress_forest(comp).equals(forest), f"{task}: decompress"

        if task == "regression":
            row["lossy"] = lossy_knobs(forest, comp, xb, k4, dev)
        log(json.dumps(row))
        models[task] = (model, x)
    launches = dict(tp.LAUNCHES)
    log(f"training-path launches: {json.dumps(launches)}")
    for name in (K3["name"], K4["name"]):
        assert launches[name] > 0, f"kernel {name} was not launched on the training path"
    return models, launches


def lossy_knobs(forest, comp, xb, per_tree, dev):
    """§7 on the regression forest: 8-bit fits, then a quarter of the
    trees, each recompressed on the card and decoded exactly; the
    quantized predictions stay within the max quantization error and the
    quantized fits compress smaller; sigma^2 comes from K4's per-tree
    fits."""
    from repro_torch.core import (
        LossyTheory,
        compress_forest,
        decompress_forest,
        estimate_sigma2_per_obs,
        predict_compressed,
        quantize_fits,
        subsample_trees,
    )

    def recompress(f):
        t0 = time.perf_counter()
        c = compress_forest(f, device=dev)
        return c, {"bytes": len(c.to_bytes()),
                   "card_compress_s": time.perf_counter() - t0}

    bits, keep = 8, max(1, TRAIN_TREES // 4)
    span = float(forest.fit_values.max() - forest.fit_values.min())
    full = predict_compressed(comp, xb, device=dev)
    q, max_err = quantize_fits(forest, bits)
    assert max_err <= span / (1 << bits) / 2 + 1e-12, (max_err, span)
    q_comp, q_info = recompress(q)
    assert decompress_forest(q_comp).equals(q), "quantized round trip"
    q_pred = predict_compressed(q_comp, xb, device=dev)
    assert np.abs(q_pred - full).max() <= max_err + 1e-9
    size = comp.size_report()
    q_size = q_comp.size_report()
    assert (q_size["fits"] + q_size["dictionaries"]
            < size["fits"] + size["dictionaries"])
    sub = subsample_trees(q, keep, seed=1)
    s_comp, s_info = recompress(sub)
    assert decompress_forest(s_comp).equals(sub), "subsampled round trip"
    assert s_info["bytes"] < q_info["bytes"]
    s_pred = predict_compressed(s_comp, xb, device=dev)
    assert np.isfinite(s_pred).all()
    sigma2 = estimate_sigma2_per_obs(per_tree.astype(np.float64))
    theory = LossyTheory(sigma2, forest.n_trees, float(np.log2(max(span, 1e-30))))
    return {
        "bits": bits, "max_err": max_err, "quantized": q_info,
        "keep_trees": keep, "subsampled": s_info,
        "sigma2_per_obs": sigma2,
        "subsample_mse_vs_quantized": float(np.mean((s_pred - q_pred) ** 2)),
        "subsample_distortion_theory": theory.subsample_distortion(keep),
    }


def phase_train_card_vs_cpu(dev):
    """A small forest at the Liberty width grown on the card and on the
    CPU from one seed: classification equal; regression equal up to tie
    flips (module docstring, phase 6)."""
    from repro_torch.forest import train_forest
    from repro_torch.forest.compare import first_divergence
    from repro_torch.forest.forest import _tree_draws, encode_targets

    fields = ("feature", "threshold", "node_fit", "is_internal", "node_count")
    for task in LIBERTY:
        spec, x, y, binner = liberty(task, SMALL["rows"])
        kw = dict(n_trees=SMALL["trees"], max_depth=SMALL["depth"], task=task,
                  n_classes=spec.n_classes, seed=3)
        card = train_forest(x, y, binner, device=dev, **kw)
        cpu = train_forest(x, y, binner, device="cpu", **kw)
        row = {"card_vs_cpu": task, "rows": len(x), **kw}
        if task == "classification":
            for f in fields:
                assert np.array_equal(getattr(card, f), getattr(cpu, f)), f
            row["trees_equal"] = SMALL["trees"]
            log(json.dumps(row))
            continue
        gen = torch.Generator().manual_seed(kw["seed"])
        h = card.cfg.n_heap
        weights = [_tree_draws(gen, len(x), h, x.shape[1])[0].numpy()
                   for _ in range(SMALL["trees"])]
        xb = binner.transform(x)
        y_enc = encode_targets(y, task, 0, "cpu").numpy()
        flips = []
        for t in range(SMALL["trees"]):
            div = first_divergence(card, cpu, t, xb, y_enc, weights[t])
            agree = slice(None) if div is None else slice(0, div["node"])
            np.testing.assert_allclose(card.node_fit[t, agree],
                                       cpu.node_fit[t, agree],
                                       rtol=RTOL, atol=ATOL)
            if div is not None:
                assert div["rel_gap"] <= GAIN_RTOL, (t, div)
                flips.append({"tree": t, **div})
        row.update(trees_equal=SMALL["trees"] - len(flips), tie_flips=flips)
        log(json.dumps(row))


def forest_args(model, x, dev):
    """The inputs ``ops.predict_forest_kernel(_per_tree)`` give K3 / K4
    for one call on ``x``."""
    from repro_torch.kernels.tree_predict.ops import _heap_tensors

    xb = torch.as_tensor(model.binner.transform(x), dtype=torch.int32,
                         device=dev)
    heaps = _heap_tensors(model, dev)
    n, t = xb.shape[0], model.n_trees
    c = model.cfg.n_classes if model.cfg.task == "classification" else 0
    depth = model.cfg.max_depth
    k3 = (xb, *heaps, depth, c, min(8, t), min(256, n))
    k4 = (xb, *heaps, depth, min(8, t), min(256, n))
    return {K3["name"]: k3, K4["name"]: k4}


def kernel_entry(kern, launch, plain, parts, launches, per_task_args, errs,
                 timed_at, large_args):
    """One kernel's entry of the ``{"kernels": [...]}`` line: held against
    its plain version and timed at its main path's shapes (per task;
    classification is the headline) and at the large parity shape."""
    entry = dict(kern)
    entry["launches"] = launches[kern["name"]]
    per_task = {}
    for task, args in per_task_args.items():
        got = launch(*args)
        torch.cuda.synchronize()
        errs.append(max_abs_err(got, plain(*args)))
        pt = parts(args)
        bms, by, work = bound(pt)
        per_task[task] = {
            "shape": {"rows": pt["xb"].shape[0],
                      "trees": int(pt["feature"].shape[0]),
                      "heap": int(pt["feature"].shape[1])},
            "ms": time_ms(lambda: launch(*args)),
            "plain_ms": time_ms(lambda: plain(*args)),
            "bound_ms": bms, "bound_by": by, "work": work,
        }
    main = per_task["classification"]
    entry.update({
        "max_abs_err": max(errs),
        "ms": main["ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "library_ms": None,
        "library_note": "no single PyTorch call computes a tree traversal",
        "timed_at": timed_at,
        "main_path": per_task,
    })
    pt = parts(large_args)
    bms, by, work = bound(pt)
    entry["large"] = {
        "case": "cls2-d8-large",
        "rows": pt["xb"].shape[0],
        "trees": int(pt["feature"].shape[0]),
        "ms": time_ms(lambda: launch(*large_args)),
        "plain_ms": time_ms(lambda: plain(*large_args), reps=20),
        "bound_ms": bms, "bound_by": by, "work": work,
    }
    return entry


def main() -> None:
    dev = phase_environment()
    phase_build()

    table = kernel_table()
    errs = {kern["name"]: [] for kern, *_ in table}
    clock = {"start": time.perf_counter()}
    large = phase_parity(dev, errs)
    clock["parity"] = time.perf_counter()
    servers, serve_launches = phase_main_path(dev)
    clock["serving"] = time.perf_counter()
    models, train_launches = phase_training(dev)
    clock["training"] = time.perf_counter()
    phase_train_card_vs_cpu(dev)
    clock["card_vs_cpu"] = time.perf_counter()

    serve_args = {task: main_path_args(server, x)
                  for task, (server, x) in servers.items()}
    train_args = {task: forest_args(model, x, dev)
                  for task, (model, x) in models.items()}
    out = []
    for kern, launch, plain, parts in table:
        name = kern["name"]
        if name in (K1["name"], K2["name"]):
            launches, args = serve_launches, serve_args
            timed_at = "one 1,024-row main-path batch, classification"
        else:
            launches, args = train_launches, train_args
            timed_at = (f"one call on the {TRAIN_TREES}-tree Liberty forest, "
                        "classification, all rows")
        out.append(kernel_entry(
            kern, launch, plain, parts, launches,
            {task: a[name] for task, a in args.items()}, errs[name],
            timed_at, large[name],
        ))

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
    clock["times"] = time.perf_counter()
    marks = list(clock.items())
    log(json.dumps({"phase_s": {b[0]: b[1] - a[1]
                                for a, b in zip(marks, marks[1:])}}))
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
