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
   two levels past the heap in two more; then K3 and K4 alone on what
   their tiling introduces: depth 14 (trees partly staged), thresholds
   >= 2**15 and 40,000 features (the wide node words; x read from global
   memory), C = 40 (integer vote atomics), one tree, one row, groups of
   more than 128 trees, T not a multiple of the tree group, K3 chunks of
   5 trees, 67 features (the x tile's bytes taken from the trees' budget);
   then K1 and K2 alone on what their tiling introduces: a fleet batch
   (65,536 rows of 256 sorted requests, 222 users of 8-16 trees at depth
   6), 1,000 rows and one row, row blocks with empty chunk ranges, one
   user of 2,100 trees (ranges longer than a window of slices), a code
   word base that is no power of two (K1's division), 160 users whose
   chunks mostly meet none of a CTA's rows, and C = 300 (integer vote
   atomics); for every case the library's configuration is held equal to
   its plain twin;
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
   nodes; 50 trees where the paper has 1,000) —
   ``train_forest(device="cuda")``; ``predict_forest`` against
   ``predict_forest_kernel`` (K3) and ``per_tree_predictions`` against
   ``predict_forest_kernel_per_tree`` (K4); ``to_compact_forest`` ->
   ``compress_forest`` on the card and on the CPU, bytes equal;
   ``predict_compressed`` against ``predict_forest``; exact
   decompression; on the regression forest the §7 knobs
   (``subsample_trees``, ``quantize_fits``) recompressed.  K3 / K4 launch
   counts are read around this phase and must be positive; then each is
   held against its plain version at the shapes the phase gave it;
6. one seed, one forest: phase 5's Liberty regression forest trained
   again on the card from its seed has equal heap arrays and compresses
   to the same bytes (the regression histograms add in a fixed order);
   then training on the card against training on the CPU, same seed, a
   small forest at the Liberty width: classification trees equal;
   regression trees equal up to tie flips whose float64 gains differ by
   <= 1e-5 relative (``forest.compare.first_divergence``);
7. times: CUDA events, median of 25 after warm-up — each kernel and its
   plain version at its main path's shapes and at the large phase-3 shape
   (K3 and K4 with the configuration the library reports, checked
   against its plain twin, their record form and ``-Xptxas -v``
   report; K1 and K2 likewise, with the large regression shape too);
   then, on the host clock, warm serving ms per 1,024-row batch and its
   stages (plan lookup, pack lookup, the K1 run with its upload and copy
   back, finalize), with K1's share of the batch;
8. LM serving (``launch/serve.py``'s path): K7 (``fa_forward``; bf16 on
   the tensor cores, float32 on the CUDA cores) against its plain version
   ``_flash_plain`` in float32 and bf16, head_dim 32 / 64 / 128, windows
   of 64, 100 and 256, ragged S (200, 2,049) and T (1,500), S != T both
   ways (with a window, rows that keep no key), and grouped KV heads
   (n_rep 2 and 4); then
   qwen3-4b at full width and depth (36 layers, d_model 2,560, bf16,
   random weights from seed 0) — ``make_prefill_step(cfg,
   use_flash=True)`` over 4 seeded prompts of 2,048 tokens with
   ``max_len`` 2,080 (a warm-up prefill, then the timed one) and 32 greedy
   ``make_decode_step`` steps; K7's count is reset before and read after
   each prefill and must equal the 36 layers; the whole-model checks
   (flash against dense prefill, decode after prefill(S) against
   prefill(S + 1)) in float32 with the same weights and in bf16, on the
   main path's weights and prompts and on two more seeds of both
   (``phase_lm_checks``); K7 against its plain version at the main path's
   layer-0 inputs (32 KV heads read for 128 query heads), timed beside
   ``scaled_dot_product_attention``, its float32 route and the layout
   copies around it, with the compiler's register and spill report; one line
   with prefill seconds and tokens/s, decode ms per step and tokens/s,
   peak device memory and K7's share of the prefill;
9. RWKV6 serving and the §7 quantizer: K8 (``wkv6_forward``) against its
   plain version ``_wkv6_plain`` at head_dim 16 / 32 / 64, S 64 / 70 /
   128 / 2,049, chunk 16 / 32 / 64, zero and non-zero initial states, the
   model's decays and extreme ones, on the (BH, S, hd) float32 layout, and
   on the model's (B, S, H, hd) layout against ``_wkv6_model_plain``: bf16
   and float32 r / k / v, H > 1, S 1 / 33 / 70 / 300 / 2,049; K6
   (``quantize_forward``) through
   ``quantize_tensor`` against ``_quantize_plain`` bit for bit at 2 / 4 /
   8 / 12 bits, without dither and with seeds 0, 7, -1 and 2**31 - 1,
   n < 256 and ragged n, float32 and bf16, each within the §7 bound; then
   rwkv6-1.6b at full width and depth (24 layers, d_model 2,048, 32 heads
   of 64, bf16, random weights from seed 0) — ``make_prefill_step(cfg,
   use_flash=True)`` over 4 seeded prompts of 2,048 tokens with
   ``max_len`` 2,080 (a warm-up prefill, then the timed one; K8's count
   must equal the 24 layers after each, and in the warm-up every launch
   must get the model's own (B, S, H, hd) bf16 tensors) and 32 greedy
   decode steps; the
   whole-model checks with u perturbed from the seed (K8 against the
   reference-branch prefill ``wkv_chunked``, logits and every layer's
   cache, and decode after prefill(S) against prefill(S + 1)) in float32
   at 1e-4 relative L2 and in bf16 within 1.5x bf16's own floor, on seeds
   0-2 (``phase_rwkv_checks``); K6 through ``quantize_tensor`` at 8 bits,
   without and with dither, over every 2-D weight of the served model
   (``LAUNCHES["quantize"]`` equal to the number of tensors per pass),
   each within its §7 bound, and bit for bit at the largest; K8 and K6
   timed beside their plain versions (K8 at the main path's launch and at
   the same work folded to (BH, S, hd) float32, each with its own bound
   and median / min / max; ``ops.wkv6`` whole, its peak memory above its
   inputs, and the ``bh_layout`` copies it no longer makes; the library's
   tiling and the ``-Xptxas -v`` report); one line with prefill seconds and
   tokens/s, K8's share of the prefill, decode ms per step and tokens/s
   and peak device memory;
10. the fleet store (the subscriber scenario): (a) ``build_store`` of
   ``benchmarks/store_bench.py``'s 100-user fleets on the card and on the
   CPU — RFT1 bytes equal, and ``ForestStore.from_bytes`` of them
   re-serializes to them on both; (b) a 1,000-user classification fleet
   (~12,000 trees) and the 100-user regression fleet, each served 256
   ragged requests of 256 rows through ``ForestServer(store,
   device="cuda").serve`` with ``pipelined`` (K1), ``simple`` (K2) and
   ``sharded`` (K5) over ``devices=["cuda:0"]`` and ``["cuda:0"] * 4``,
   every request held against ``predict_compressed`` on the CPU, and
   ``serve_safe`` with one user's delta corrupted (that user
   quarantined, the others unchanged); (c) K1, K2 and K5 launch counts
   read around (b), positive, with 4 K1 launches per S = 4 batch; (d) K5
   against its plain version at the S = 1 and S = 4 inputs, and K1 at the
   S = 1 session's batch timed beside its plain version and bound, with
   its configuration (part of K1's ``{"kernels"}`` entry); (e) the
   builds' seconds, each engine's cold and warm batch with its stages,
   K1's share, and K5 at S = 1 and 4, in one ``{"fleet": ...}`` line.

``python3 chip_smoke.py --forest-times`` runs only K3 and K4 at the two
Liberty shapes and the large one (the same command times a parent tree's
kernels); ``--forest-profile`` adds ``max_depth`` cut to 0, 2, ..., 12
and a ``torch.profiler`` split of each call by kernel.  ``--seg-times``
runs only K1, K2 and K5: K1 and K2 at the single-forest 1,024-row batch
of phase 4, K1 at phase 10's 65,536-row fleet batch, K5 there at S = 1
and 4, K1 and K2 at the large classification and regression shapes, each
held against its plain version (the same command times a parent tree's
kernels); ``--seg-profile`` adds ``max_depth`` cut to 0, 2, ..., 8 at the
single-forest batch, with each call's device time from ``torch.profiler``.

Votes must be equal; regression sums are held at rtol = atol = 1e-5 (the
reference's own serving tolerance); on the card K1-K4 equal their plain
versions bit for bit, and K7 is held to its plain version at the
reference's float32 flash tolerance (2e-5) and, in bf16, at one bf16 ulp
(rtol 2**-7, atol 2e-5); K8 at the reference's float32 WKV6 tolerance
(1e-4), K6 bit for bit, K5 bit for bit.  The line before
the last is one JSON object ``{"kernels": [...]}``; the last line is
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
#: The kernels a parity case runs when it names them (K3, K4; K1, K2).
FOREST = ("agg", "per_tree")
SEG = ("seg_packed", "seg_simple")

K5 = {
    "name": "seg_sharded",
    "route": "cuda",
    "source": "src/repro_torch/kernels/tree_predict/csrc/tree_predict.cu",
    "replaces": "src/repro/kernels/tree_predict/ops.py:145",
}

K7 = {
    "name": "flash",
    "route": "cuda",
    "source": "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
    "replaces": "src/repro/kernels/flash_attention/flash_attention.py:29",
}
K8 = {
    "name": "wkv6",
    "route": "cuda",
    "source": "src/repro_torch/kernels/rwkv6_scan/csrc/rwkv6_scan.cu",
    "replaces": "src/repro/kernels/rwkv6_scan/rwkv6_scan.py:26",
}
K6 = {
    "name": "quantize",
    "route": "cuda",
    "source": "src/repro_torch/kernels/quantize/csrc/quantize.cu",
    "replaces": "src/repro/kernels/quantize/quantize.py:20",
}

# LM serving (phase 8): qwen3-4b at full width and depth, bf16, random
# weights from seed 0; 4 seeded prompts of 2,048 tokens, then greedy decode.
LM_ARCH = "qwen3-4b"
LM_SHAPE = (36, 2560, "bfloat16")  # layers, d_model, dtype: uncut
LM_BATCH = 4
LM_PROMPT = 2048
LM_MAX_LEN = 2080
LM_DECODE_STEPS = 32
# dense tensor-core bf16 peak (NVIDIA's data sheet), the rate bf16
# attention is counted at; float32 attention at CUDA_CORE_OPS_PER_S
BF16_OPS_PER_S = 989e12
# K7 against its plain version, (atol, rtol): both compute in float32 and
# differ only in summation order, so float32 holds at the reference's own
# 2e-5 (tests/test_kernels.py); in bf16 each side then rounds its float32
# result once, which puts them at most one bf16 ulp apart (<= 2**-7 of the
# value), plus the float32 gap
FLASH_TOL = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (2e-5, 2**-7)}
# whole-model checks (phase_lm_checks), for each seed of weights and
# prompts in LM_CHECK_SEEDS (0 is the main path's): float32 with the same
# weights, at full width and depth, holds the paths together at 1e-4
# relative L2; the bf16 paths differ by bf16's own rounding over 36 layers
# (each sits ~2 % from the float32 run), bounded at 1.5x that floor
LM_CHECK_SEEDS = (0, 1, 2)
F32_MODEL_REL_L2 = 1e-4
BF16_MODEL_REL_L2 = 3e-2
DECODE_RTOL = DECODE_ATOL = 5e-2  # tests/test_system.py:49

# RWKV6 serving (phase 9): rwkv6-1.6b at full width and depth, bf16,
# random weights from seed 0; 4 seeded prompts of 2,048 tokens, then greedy
# decode.  Prefill runs the WKV6 recurrence through K8.
RWKV_ARCH = "rwkv6-1.6b"
RWKV_SHAPE = (24, 2048, "bfloat16")  # layers, d_model, dtype: uncut
RWKV_BATCH = 4
RWKV_PROMPT = 2048
RWKV_MAX_LEN = 2080
RWKV_DECODE_STEPS = 32
RWKV_CHECK_SEEDS = (0, 1, 2)
# K8 against _wkv6_plain: both float32, other summation orders; the
# reference's own float32 tolerance for its kernel (tests/test_kernels.py)
WKV_TOL = (1e-4, 1e-4)
# whole-model checks (phase_rwkv_checks), with u perturbed from the seed:
# float32 (the same weights upcast) holds the K8 and reference-branch
# prefills and decode-after-prefill together at 1e-4 relative L2.  In
# bf16 the two paths round their y to bf16 after other float32 sums and
# then take 24 layers of bf16 matmuls: their gap is held to 1.5x the
# witness, bf16's own rounding floor on the same weights, read in the same
# run as each bf16 path's distance from the float32 K8 run (phase 8's 3e-2
# is that factor over the floor it measured on qwen3-4b)
RWKV_F32_REL_L2 = 1e-4
RWKV_BF16_OVER_FLOOR = 1.5
# (name, BH, S, hd, chunk, initial state, decays): K8 against _wkv6_plain;
# chunk None calls the launch directly (S not a multiple of any chunk);
# decays "model" draw log w from U(-6, -4) (the model's w0 = -5 gives
# w ~ 0.9933), "extreme" from U(-6, 2.5) (tests/test_perf_paths.py)
WKV_PARITY_CASES = [
    ("hd64-s128-c64-zero-model", 8, 128, 64, 64, "zero", "model"),
    ("hd64-s2049-ragged-state-model", 8, 2049, 64, None, "state", "model"),
    ("hd64-s64-c16-state-extreme", 8, 64, 64, 16, "state", "extreme"),
    ("hd32-s128-c32-state-extreme", 8, 128, 32, 32, "state", "extreme"),
    ("hd32-s70-ragged-zero-extreme", 8, 70, 32, None, "zero", "extreme"),
    ("hd16-s64-c16-state-model", 8, 64, 16, 16, "state", "model"),
    ("hd16-s2049-ragged-zero-extreme", 4, 2049, 16, None, "zero", "extreme"),
]
# (name, B, S, H, hd, r/k/v dtype, initial state, decays): K8 on the model's
# (B, S, H, hd) layout, as ops.wkv6 hands it over, against
# _wkv6_model_plain (which upcasts the same bf16 values exactly)
WKV_MODEL_PARITY_CASES = [
    ("model-bf16-b2-h4-hd64-s300-state-extreme", 2, 300, 4, 64,
     torch.bfloat16, "state", "extreme"),
    ("model-bf16-b2-h3-hd64-s2049-zero-model", 2, 2049, 3, 64,
     torch.bfloat16, "zero", "model"),
    ("model-f32-b2-h4-hd64-s128-state-model", 2, 128, 4, 64, torch.float32,
     "state", "model"),
    ("model-f32-b3-h2-hd64-s70-state-extreme", 3, 70, 2, 64, torch.float32,
     "state", "extreme"),
    ("model-bf16-b3-h2-hd32-s70-state-extreme", 3, 70, 2, 32, torch.bfloat16,
     "state", "extreme"),
    ("model-f32-b2-h5-hd16-s33-state-extreme", 2, 33, 5, 16, torch.float32,
     "state", "extreme"),
    ("model-bf16-b1-h2-hd64-s1-state-model", 1, 1, 2, 64, torch.bfloat16,
     "state", "model"),
]
# K6 against _quantize_plain, bit for bit: (shape, dtype) x bits x dither
QUANT_SHAPES = [((200,), torch.float32), ((100003,), torch.bfloat16),
                ((517, 389), torch.float32), ((2048, 7168), torch.bfloat16)]
QUANT_BITS = (2, 4, 8, 12)
QUANT_DITHERS = ((False, 0), (True, 0), (True, 7), (True, -1),
                 (True, 2**31 - 1))
QUANT_MODEL_BITS = 8

# (name, BH, S, T, hd, dtype, window, n_rep): K7 against _flash_plain;
# n_rep > 1 goes through _flash_attention_grouped with BH / n_rep KV heads
FLASH_PARITY_CASES = [
    ("f32-hd128", 8, 256, 256, 128, torch.float32, None, 1),
    ("bf16-hd128", 8, 256, 256, 128, torch.bfloat16, None, 1),
    ("f32-hd64", 8, 512, 512, 64, torch.float32, None, 1),
    ("bf16-hd64-window64", 8, 512, 512, 64, torch.bfloat16, 64, 1),
    ("f32-hd32-window64", 8, 512, 512, 32, torch.float32, 64, 1),
    ("bf16-hd32", 8, 256, 256, 32, torch.bfloat16, None, 1),
    ("f32-ragged-s200", 8, 200, 200, 128, torch.float32, None, 1),
    ("bf16-ragged-s2049", 4, 2049, 2049, 128, torch.bfloat16, None, 1),
    ("f32-s1000-t2048", 4, 1000, 2048, 128, torch.float32, None, 1),
    ("f32-s2048-t1000", 4, 2048, 1000, 64, torch.float32, None, 1),
    ("bf16-s1000-t2048", 4, 1000, 2048, 128, torch.bfloat16, None, 1),
    ("bf16-s2048-t1000", 4, 2048, 1000, 128, torch.bfloat16, None, 1),
    ("bf16-ragged-t1500", 4, 1024, 1500, 64, torch.bfloat16, None, 1),
    ("bf16-hd128-window256", 4, 1024, 1024, 128, torch.bfloat16, 256, 1),
    ("bf16-grouped-nrep2", 8, 512, 512, 128, torch.bfloat16, None, 2),
    ("bf16-grouped-nrep4-window100", 8, 512, 512, 64, torch.bfloat16, 100,
     4),
    ("f32-grouped-nrep4", 8, 256, 256, 128, torch.float32, None, 4),
    # rows 1,063 on keep no key (S >= T + window): 0 on every route
    ("bf16-s2048-t1000-window64", 4, 2048, 1000, 64, torch.bfloat16, 64, 1),
    ("f32-s2048-t1000-window64", 4, 2048, 1000, 128, torch.float32, 64, 1),
]

# Fleet serving (phase 10): the subscriber scenario — one ForestStore per
# task (one shared codebook, one delta per user) serving ragged mixed-user
# batches.  benchmarks/store_bench.py's 100-user fleets (depth 6, 8
# features) for the RFT1 round trip; for serving, a 1,000-user
# classification fleet (~12,000 trees, inside the arena's default
# 16,384-tree capacity) and the 100-user regression fleet, each sent 256
# requests of 256 rows (65,536 rows) of make_request_batch(seed=1).
FLEET_BENCH_USERS = 100
FLEET_SERVE_USERS = {"classification": 1000, "regression": 100}
FLEET_REQUESTS = 256
FLEET_ROWS = 256
# store_total_bytes of those 100-user fleets in BENCH_store.json: a
# reference run of an older commit, printed as a witness, not a gate
BENCH_STORE_BYTES = {"classification": 201586, "regression": 237396}
# (label, shards on the one card or None for the session default, engine)
FLEET_ENGINES = (
    ("pipelined", None, "pipelined"),
    ("simple", None, "simple"),
    ("sharded_s1", 1, "sharded"),
    ("sharded_s4", 4, "sharded"),
)

# Table 1's Liberty configuration (benchmarks/table1_liberty.py, full
# mode), cut from 1,000 trees to TRAIN_TREES for the run's time limit
# (100 until the fleet phase and the second regression training and
# compression of phase 6 brought the run near 600 s).
LIBERTY = {"classification": "liberty_cls", "regression": "liberty_reg"}
TRAIN_TREES = 50
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


def fleet_segments(rng, n_users, n_requests, rows):
    """A fleet batch's segments: users of 8-16 trees each, and
    ``n_requests`` requests of ``rows`` rows, every user asked at least
    once, the rows sorted by user (as the serving plan sorts them)."""
    tseg = np.repeat(np.arange(n_users), rng.integers(8, 17, n_users))
    asked = np.concatenate([np.arange(n_users),
                            rng.integers(0, n_users, n_requests - n_users)])
    oseg = np.sort(np.repeat(asked, rows))
    return tseg.astype(np.int32), oseg.astype(np.int32)


def walk_depth(case):
    """``max_depth`` of a case: two levels past the heap when it asks."""
    return case["depth"] + (2 if case.get("past_heap") else 0)


def seg_layout(rng, case):
    """(trees, rows, tree segments or None, row segments or None) of a K1 /
    K2 case: a fleet batch's when it asks, else drawn after the heaps."""
    if "fleet" in case:
        tseg, oseg = fleet_segments(rng, *case["fleet"])
        return len(tseg), len(oseg), tseg, oseg
    return case["trees"], case["rows"], None, None


def k1_inputs(dev, case, rng):
    from repro_torch.kernels.tree_predict import tree_predict as tp

    d, nb, c = 8, 32, case["classes"]
    t, n, tseg, oseg = seg_layout(rng, case)
    depth = case["depth"]
    bt, bo = case.get("k1_blocks", (8, 128))
    feature, threshold, is_internal, fit = random_heaps(
        rng, t, depth, d, nb, c, negative=False,
        past_heap=case.get("past_heap", False),
    )
    tb = case.get("tb") or tp.fused_threshold_base(nb - 1)
    code = tp.fuse_node_attrs(feature, threshold, is_internal, tb)
    t_pad = -(-t // bt) * bt
    if tseg is None:
        tseg = ragged_segments(rng, t, case["segs"], sort=True)
    pad = t_pad - t
    code = np.pad(code, ((0, pad), (0, 0)))
    fit = np.pad(fit, ((0, pad), (0, 0)))
    tseg = np.pad(tseg, (0, pad), constant_values=-1)
    xb = rng.integers(0, nb, (n, d)).astype(np.int32)
    if oseg is None:
        oseg = ragged_segments(rng, n, case["segs"], sort=case["sorted"])
    lo, hi = tp.segment_chunk_ranges(oseg, tseg, bt, bo)
    if case.get("empty_ranges"):  # every third row block walks nothing
        hi[::3] = lo[::3]

    def T(a, dt):
        return torch.as_tensor(a, dtype=dt, device=dev)

    i32, f32 = torch.int32, torch.float32
    return (
        T(xb, i32), T(oseg, i32), T(code, f32), T(fit, f32), T(tseg, i32),
        T(lo, i32), T(hi, i32), walk_depth(case), 2 * tb, c, bt, bo,
    )


def k2_inputs(dev, case, rng):
    d, nb, c = 8, 32, case["classes"]
    t, n, tseg, oseg = seg_layout(rng, case)
    feature, threshold, is_internal, fit = random_heaps(
        rng, t, case["depth"], d, nb, c, negative=True,
        past_heap=case.get("past_heap", False),
    )
    if tseg is None:
        tseg = ragged_segments(rng, t, case["segs"], sort=True)
    xb = rng.integers(-2, nb, (n, d)).astype(np.int32)
    if oseg is None:
        oseg = ragged_segments(rng, n, case["segs"], sort=case["sorted"])

    def T(a, dt):
        return torch.as_tensor(a, dtype=dt, device=dev)

    bt, bo = case.get("k2_blocks", (32, 256))
    return (
        T(xb, torch.int32), T(oseg, torch.int32), T(tseg, torch.int32),
        T(feature, torch.int32), T(threshold, torch.int32),
        T(fit, torch.float32), T(is_internal, torch.bool), walk_depth(case),
        c, bt, min(bo, n),
    )


def forest_inputs(dev, case, rng):
    """K3 / K4 inputs: K2's random heaps (negative features and
    thresholds, out-of-range class ids) without segments; 8 features and
    32 bins unless the case sets ``d`` / ``bins``."""
    t, depth, d, nb, c, n = (
        case["trees"], case["depth"], case.get("d", 8), case.get("bins", 32),
        case["classes"], case["rows"],
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
    return (*forest_inputs(dev, case, rng), case["classes"],
            *case.get("k3_blocks", (8, 256)))


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
    after warm-up (``time_stats``)."""
    return time_stats(fn, reps)["median"]


def time_stats(fn, reps: int = REPS) -> dict:
    """Median, min and max device ms of ``fn`` over ``reps``
    CUDA-event-timed calls, after warm-up.  A spin kernel before each start
    event lets the host enqueue the call while the card is busy, so
    host-side wrapper work does not show as device time."""
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
    return {"median": float(np.median(times)), "min": float(min(times)),
            "max": float(max(times))}


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
    # K3 and K4 only (K1's fused code word cannot hold d = 40,000): what
    # their tiling introduces.  Depth 14: trees only partly staged
    {"name": "cls7-d14", "classes": 7, "depth": 14, "trees": 37,
     "rows": 3001, "kernels": FOREST},
    {"name": "reg-d14", "classes": 0, "depth": 14, "trees": 37,
     "rows": 3001, "kernels": FOREST},
    # thresholds up to 70,000 >= 2**15: the wide records
    {"name": "cls3-wide-thresholds", "classes": 3, "depth": 10,
     "trees": 45, "rows": 4001, "bins": 70000, "kernels": FOREST},
    {"name": "reg-wide-thresholds", "classes": 0, "depth": 10, "trees": 45,
     "rows": 4001, "bins": 70000, "kernels": FOREST},
    # 40,000 features: the wide records, x read from global memory; C = 40
    # counts votes with integer atomics
    {"name": "cls40-d40000", "classes": 40, "depth": 8, "trees": 17,
     "rows": 257, "d": 40000, "kernels": FOREST},
    {"name": "reg-d40000", "classes": 0, "depth": 8, "trees": 17,
     "rows": 257, "d": 40000, "kernels": FOREST},
    # one tree; one row
    {"name": "cls2-t1", "classes": 2, "depth": 12, "trees": 1, "rows": 4099,
     "kernels": FOREST},
    {"name": "reg-t1", "classes": 0, "depth": 12, "trees": 1, "rows": 4099,
     "kernels": FOREST},
    {"name": "cls7-n1", "classes": 7, "depth": 12, "trees": 203, "rows": 1,
     "kernels": FOREST},
    {"name": "reg-n1", "classes": 0, "depth": 12, "trees": 203, "rows": 1,
     "kernels": FOREST},
    # groups of more than 128 trees (K3's packed vote counts carry into
    # its registers every 128 trees)
    {"name": "cls5-d4-big-groups", "classes": 5, "depth": 4, "trees": 700,
     "rows": 3001, "kernels": FOREST},
    {"name": "reg-d4-big-groups", "classes": 0, "depth": 4, "trees": 700,
     "rows": 3001, "kernels": FOREST},
    # T not a multiple of the tree group; K3's chunks of 5 trees
    {"name": "cls7-ragged-groups", "classes": 7, "depth": 10, "trees": 301,
     "rows": 2003, "kernels": FOREST},
    {"name": "reg-ragged-groups-bt5", "classes": 0, "depth": 10,
     "trees": 301, "rows": 2003, "k3_blocks": (5, 256), "kernels": FOREST},
    # 67 features: the 137,216-byte x tile beside a full tree budget would
    # pass a CTA's shared memory; it comes out of the trees' budget
    {"name": "cls2-d67-depth12", "classes": 2, "depth": 12, "trees": 12,
     "rows": 3001, "d": 67, "kernels": FOREST},
    {"name": "reg-d67-t96", "classes": 0, "depth": 8, "trees": 96,
     "rows": 3001, "d": 67, "kernels": FOREST},
    {"name": "cls3-d67-t96", "classes": 3, "depth": 8, "trees": 96,
     "rows": 3001, "d": 67, "kernels": FOREST},
    # K1 and K2 only: what their tiling introduces.  A fleet batch: 256
    # requests of 256 rows from 222 users of 8-16 trees at depth 6, the
    # rows sorted by user (65,536 rows)
    {"name": "cls2-d6-fleet", "classes": 2, "depth": 6,
     "fleet": (222, 256, 256), "kernels": SEG},
    {"name": "reg-d6-fleet", "classes": 0, "depth": 6,
     "fleet": (222, 256, 256), "kernels": SEG},
    # rows that are no multiple of a CTA's rows; one row
    {"name": "cls3-n1000", "classes": 3, "depth": 8, "trees": 100,
     "rows": 1000, "segs": 2, "sorted": False, "kernels": SEG},
    {"name": "reg-n1000", "classes": 0, "depth": 8, "trees": 100,
     "rows": 1000, "segs": 2, "sorted": False, "kernels": SEG},
    {"name": "cls3-seg-n1", "classes": 3, "depth": 8, "trees": 203,
     "rows": 1, "segs": 3, "sorted": True, "kernels": SEG},
    {"name": "reg-seg-n1", "classes": 0, "depth": 8, "trees": 203,
     "rows": 1, "segs": 3, "sorted": True, "kernels": SEG},
    # every third row block with an empty chunk range (K1; K2 walks all)
    {"name": "cls3-empty-ranges", "classes": 3, "depth": 8, "trees": 301,
     "rows": 3001, "segs": 7, "sorted": True, "empty_ranges": True,
     "kernels": SEG},
    {"name": "reg-empty-ranges", "classes": 0, "depth": 8, "trees": 301,
     "rows": 3001, "segs": 7, "sorted": True, "empty_ranges": True,
     "kernels": SEG},
    # one user of 2,100 trees: a range of more slices than one window of
    # a CTA's threads (263 chunks of 8 for K1, 263 slices of 8 for K2)
    {"name": "cls3-long-range", "classes": 3, "depth": 6, "trees": 2100,
     "rows": 700, "segs": 1, "sorted": True, "kernels": SEG},
    {"name": "reg-long-range", "classes": 0, "depth": 6, "trees": 2100,
     "rows": 700, "segs": 1, "sorted": True, "kernels": SEG},
    # K1 with a code word base that is no power of two (TB 48: decoded by
    # division)
    {"name": "cls3-tb48", "classes": 3, "depth": 8, "trees": 99,
     "rows": 2001, "segs": 3, "sorted": False, "tb": 48, "kernels": SEG},
    {"name": "reg-tb48", "classes": 0, "depth": 8, "trees": 99,
     "rows": 2001, "segs": 3, "sorted": True, "tb": 48, "kernels": SEG},
    # 160 users over 640 trees: most chunks of 32 meet none of a CTA's rows
    {"name": "cls3-dead-chunks", "classes": 3, "depth": 8, "trees": 640,
     "rows": 8192, "segs": 160, "sorted": True, "kernels": SEG},
    {"name": "reg-dead-chunks", "classes": 0, "depth": 8, "trees": 640,
     "rows": 8192, "segs": 160, "sorted": True, "kernels": SEG},
    # C = 300: a vote table past the shared budget (integer atomics)
    {"name": "cls300-d8", "classes": 300, "depth": 8, "trees": 64,
     "rows": 20000, "segs": 4, "sorted": True, "kernels": SEG},
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
    Returns each kernel's inputs at the large classification case, and
    K1's and K2's at the large regression case."""
    rng = np.random.default_rng(0)
    makers = {"seg_packed": k1_inputs, "seg_simple": k2_inputs,
              "agg": k3_inputs, "per_tree": k4_inputs}
    large, large_reg = {}, {}
    for case in PARITY_CASES:
        for kern, launch, plain, _ in kernel_table():
            if kern["name"] not in case.get("kernels", makers):
                continue
            args = makers[kern["name"]](dev, case, rng)
            got = launch(*args)
            torch.cuda.synchronize()
            err = max_abs_err(got, plain(*args))
            errs[kern["name"]].append(err)
            line = {"parity": kern["name"], "case": case["name"],
                    "out": list(got.shape), "max_abs_err": err}
            if kern["name"] in FOREST:
                cfg = forest_config_checked(kern["name"], args)
                line["config"] = {k: cfg[k] for k in (
                    "levels", "group", "n_groups", "x_smem", "smem", "walks")}
            else:
                cfg = seg_config_checked(kern["name"], args)
                line["config"] = {k: cfg[k] for k in (
                    "mode", "decode", "rows", "cols", "grid", "smem")}
            log(json.dumps(line))
            if case["name"] == "cls2-d8-large":
                large[kern["name"]] = args
            elif case["name"] == "reg-d8-large":
                large_reg[kern["name"]] = args
    return large, large_reg


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
    phase 5).  Returns {task: (model, x)}, the K3 / K4 launch counts of
    this phase and {task: compressed bytes}."""
    from repro_torch.core import decompress_forest, predict_compressed
    from repro_torch.forest import (
        per_tree_predictions,
        predict_forest,
        to_compact_forest,
        train_forest,
    )
    from repro_torch.kernels.tree_predict import ops
    from repro_torch.kernels.tree_predict import tree_predict as tp

    models, blobs = {}, {}
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
        blobs[task] = comp.to_bytes()
    launches = dict(tp.LAUNCHES)
    log(f"training-path launches: {json.dumps(launches)}")
    for name in (K3["name"], K4["name"]):
        assert launches[name] > 0, f"kernel {name} was not launched on the training path"
    return models, launches, blobs


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


def phase_train_again(dev, model, blob):
    """One seed, one forest (module docstring, phase 6): the Liberty
    regression forest of phase 5 trained again on the card from its seed
    has equal heap arrays and compresses to the same bytes."""
    from repro_torch.core import compress_forest
    from repro_torch.forest import to_compact_forest, train_forest

    spec, x, y, binner = liberty("regression")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    again = train_forest(
        x, y, binner, n_trees=TRAIN_TREES, max_depth=TRAIN_DEPTH,
        task="regression", n_classes=spec.n_classes, seed=0, device=dev,
    )
    train_s = time.perf_counter() - t0
    for f in ("feature", "threshold", "node_fit", "is_internal", "node_count"):
        assert np.array_equal(getattr(again, f), getattr(model, f)), (
            f"regression {f} differs between two trainings from one seed"
        )
    t0 = time.perf_counter()
    comp = compress_forest(to_compact_forest(again), device=dev)
    compress_s = time.perf_counter() - t0
    assert comp.to_bytes() == blob, "compressed bytes differ between trainings"
    log(json.dumps({"train_again": "regression", "trees": TRAIN_TREES,
                    "heaps_equal": True, "bytes_equal": len(blob),
                    "train_s": train_s, "card_compress_s": compress_s}))


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
            "ms": time_ms(bound_launch(kern["name"], launch, args)),
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
        "ms": time_ms(bound_launch(kern["name"], launch, large_args)),
        "plain_ms": time_ms(lambda: plain(*large_args), reps=20),
        "bound_ms": bms, "bound_by": by, "work": work,
    }
    return entry


def forest_shape_of(name, args):
    """(t, h, n, d, max_depth, n_classes, per_tree, block_trees, form) of
    K3 / K4 inputs."""
    from repro_torch.kernels.tree_predict import tree_predict as tp

    xb, feature, threshold, max_depth = args[0], args[1], args[2], args[5]
    per_tree = name == K4["name"]
    c, bt = (0, args[6]) if per_tree else (args[6], args[7])
    form = tp._record_form(xb.shape[1], int(threshold.abs().max()))
    return (feature.shape[0], feature.shape[1], xb.shape[0], xb.shape[1],
            max_depth, c, per_tree, bt, form)


def bound_launch(name, launch, args, **kw):
    """A call of ``launch`` on ``args`` for timing.  K3 and K4 get their
    record form, as their entry points hand it over: left to the launch,
    it would read the thresholds' maximum from the card, and that sync
    would put the wrapper's host time inside the timed window.  A launch
    that takes no form (the parent tree's, under --forest-times) is
    called as it is."""
    import inspect

    if name in FOREST and "form" in inspect.signature(launch).parameters:
        kw["form"] = forest_shape_of(name, args)[-1]
    return lambda: launch(*args, **kw)


def forest_config_checked(name, args):
    """The configuration the library reports for these inputs, held equal
    to its plain twin's at the same resident CTA count."""
    from repro_torch.kernels.tree_predict import tree_predict as tp

    shape = forest_shape_of(name, args)
    card = tp.forest_config(*shape)
    twin = tp._forest_config(*shape, resident=card["resident"])
    assert card == twin, (name, card, twin)
    return card


def seg_shape_of(name, args):
    """(n, d, t, h, max_depth, n_classes, block_trees, block_obs, tb2) of
    K1 / K2 inputs (tb2 None for K2)."""
    if name == K1["name"]:
        xb, _, code, _, _, _, _, depth, tb2, c, bt, bo = args
        t, h = code.shape
    else:
        xb, _, _, feature, _, _, _, depth, c, bt, bo = args
        t, h = feature.shape
        tb2 = None
    return (xb.shape[0], xb.shape[1], t, h, depth, c, bt, bo, tb2)


def seg_config_checked(name, args):
    """K1's / K2's configuration as the library reports it for these
    inputs, held equal to its plain twin's at the same resident CTA
    count."""
    from repro_torch.kernels.tree_predict import tree_predict as tp

    shape = seg_shape_of(name, args)
    card = tp.seg_config(*shape)
    twin = tp._seg_config(*shape, resident=card["resident"])
    assert card == twin, (name, card, twin)
    return card


def seg_ptxas(cfg) -> dict | None:
    """``-Xptxas -v``'s registers and spills of the seg_kernel
    instantiation a K1 / K2 configuration runs (nodes, mode, x in shared
    memory)."""
    import re

    from repro_torch.kernels import build

    text = build.build_logs.get("tree_predict")
    if text is None:
        return None
    nodes = ("SimpleNodes", "PackedNodesILb1EE",
             "PackedNodesILb0EE")[cfg["decode"]]
    args = f"ELi{cfg['mode']}ELb{cfg['x_smem']}EE"
    for name in re.findall(r"Compiling entry function '(\S+)'", text):
        if "seg_kernel" in name and nodes in name and args in name:
            return {"entry": name, **ptxas_report("tree_predict", name)}
    return None


def seg_timed(name, launch, plain, parts, args, reps=REPS):
    """One K1 / K2 shape of its ``{"kernels"}`` entry: median / min / max
    ms, the plain version's ms, the bound and the library's configuration
    (checked against its twin)."""
    bms, by, work = bound(parts(args))
    cfg = seg_config_checked(name, args)
    stats = time_stats(bound_launch(name, launch, args))
    return {"ms": stats["median"], "ms_min": stats["min"],
            "ms_max": stats["max"],
            "plain_ms": time_ms(lambda: plain(*args), reps=reps),
            "bound_ms": bms, "bound_by": by, "work": work,
            "config": cfg, "ptxas": seg_ptxas(cfg)}


def forest_ptxas(cfg) -> dict | None:
    """``-Xptxas -v``'s registers and spills of the forest_kernel
    instantiation a configuration runs (form, mode, x in shared memory,
    walks)."""
    import re

    from repro_torch.kernels import build

    text = build.build_logs.get("tree_predict")
    if text is None:
        return None
    form = ("NarrowForm", "WideForm")[cfg["form"]]
    args = (f"{form}ELi{cfg['mode']}ELb{cfg['x_smem']}"
            f"ELi{cfg['walks']}EE")
    for name in re.findall(r"Compiling entry function '(\S+)'", text):
        if "forest_kernel" in name and args in name:
            return {"entry": name, **ptxas_report("tree_predict", name)}
    return None


def forest_report(name, per_task_args, large_args):
    """K3's / K4's part of its ``{"kernels"}`` entry: the configuration
    the library reports at the main path's shapes and at the large parity
    shape (checked against the plain twin), the record form and the
    ``-Xptxas -v`` report of the instantiation the classification shape
    runs."""
    configs = {task: forest_config_checked(name, a)
               for task, a in per_task_args.items()}
    configs["cls2-d8-large"] = forest_config_checked(name, large_args)
    main_cfg = configs["classification"]
    return {
        "config": configs,
        "record_form": ("narrow: 4-byte node words", "wide: 8-byte node "
                        "words")[main_cfg["form"]],
        "ptxas": forest_ptxas(main_cfg),
        "prologue": "pack_kernel, one launch inside each K3 / K4 call "
                    "(timed and counted with it)",
    }


def seg_report(name, launch, plain, parts, per_task_args, large_args,
               large_reg_args):
    """K1's / K2's part of its ``{"kernels"}`` entry: the configuration
    the library reports at the main path's shapes and at the large parity
    shapes (checked against the plain twin), the ``-Xptxas -v`` report of
    the instantiation the classification shape runs, and the large
    regression shape timed beside its plain version and bound."""
    configs = {task: seg_config_checked(name, a)
               for task, a in per_task_args.items()}
    configs["cls2-d8-large"] = seg_config_checked(name, large_args)
    return {
        "config": configs,
        "ptxas": seg_ptxas(configs["classification"]),
        "reg-d8-large": seg_timed(name, launch, plain, parts, large_reg_args,
                                  reps=5),
    }


def forest_shapes(dev):
    """K3's and K4's inputs at the two Liberty shapes (phase 5's forests,
    trained again from seed 0) and at the large parity shape."""
    from repro_torch.forest import train_forest

    shapes = {}
    for task in LIBERTY:
        spec, x, y, binner = liberty(task)
        model = train_forest(
            x, y, binner, n_trees=TRAIN_TREES, max_depth=TRAIN_DEPTH,
            task=task, n_classes=spec.n_classes, seed=0, device=dev,
        )
        shapes[task] = forest_args(model, x, dev)
    large = next(c for c in PARITY_CASES if c["name"] == "cls2-d8-large")
    shapes["cls2-d8-large"] = {
        K3["name"]: k3_inputs(dev, large, np.random.default_rng(0)),
        K4["name"]: k4_inputs(dev, large, np.random.default_rng(0)),
    }
    return shapes


def forest_times_main(profile: bool) -> None:
    """``--forest-times``: K3 and K4 alone at ``forest_shapes``, each held
    against its plain version, median / min / max of REPS calls — the
    same command runs the parent's tree (only the launch and plain
    functions are used).  ``--forest-profile`` adds
    ``forest_depth_profile`` (this tree only)."""
    from repro_torch.kernels import build

    dev = phase_environment()
    build.build(["tree_predict"])
    shapes = forest_shapes(dev)
    for kern, launch, plain, _ in kernel_table()[2:]:
        name = kern["name"]
        for where, args in shapes.items():
            a = args[name]
            run = bound_launch(name, launch, a)
            max_abs_err(run(), plain(*a))
            log(json.dumps({"forest_times": name, "shape": where,
                            **time_stats(run)}))
    if profile:
        forest_depth_profile(shapes["classification"])
    print(json.dumps({"ok": True}), flush=True)


def seg_shapes(dev):
    """K1's, K2's and K5's inputs at the shapes ``--seg-times`` times: the
    single-forest 1,024-row batch of phase 4 (K1, and K2's first tree
    chunk), the 65,536-row batch of phase 10's 1,000-user fleet (K1; K5 at
    S = 1 and 4) and the large parity shapes."""
    from repro_torch.serving import ForestServer
    from repro_torch.store import (
        build_store,
        make_request_batch,
        make_synthetic_fleet,
    )

    shapes = {}
    rng = np.random.default_rng(1)
    for task in ("classification", "regression"):
        server = ForestServer.from_forest(synthetic_forest(task),
                                          device="cuda")
        x = rng.integers(0, 32, (5000, 8)).astype(np.int32)
        shapes[f"main-path-{task}"] = main_path_args(server, x)
    task = "classification"
    store = build_store(make_synthetic_fleet(FLEET_SERVE_USERS[task], task,
                                             seed=0), device=dev)
    requests = make_request_batch(store, FLEET_REQUESTS, FLEET_ROWS, seed=1)
    shapes["fleet"] = {K1["name"]: fleet_kernel_args(
        fleet_session(store, dev, None), requests, "pipelined")[1]}
    for shards in (1, 4):
        shapes[f"fleet-s{shards}"] = {K5["name"]: fleet_kernel_args(
            fleet_session(store, dev, shards), requests, "sharded")[1]}
    for case in PARITY_CASES:
        if case["name"] in ("cls2-d8-large", "reg-d8-large"):
            shapes[case["name"]] = {
                K1["name"]: k1_inputs(dev, case, np.random.default_rng(0)),
                K2["name"]: k2_inputs(dev, case, np.random.default_rng(0)),
            }
    return shapes


def seg_depth_profile(args):
    """--seg-profile: K1 and K2 at the single-forest classification batch
    with ``max_depth`` cut to 0, 2, ..., 8 (0: the launch, the keep window,
    staging and the reduction alone), device ms per call of each kernel
    from ``torch.profiler``, each held against its plain version."""
    from repro_torch.kernels.tree_predict import tree_predict as tp

    for name, launch, plain in ((K1["name"], tp._launch_seg_packed,
                                 tp._seg_packed_plain),
                                (K2["name"], tp._launch_seg_simple,
                                 tp._seg_simple_plain)):
        a = list(args[name])
        for depth in range(0, 9, 2):
            a[7] = depth  # max_depth, in K1's and K2's arguments alike
            max_abs_err(launch(*a), plain(*a))
            split = profile_kernels(lambda: launch(*a), calls=20)
            log(json.dumps({"seg_profile": name, "max_depth": depth,
                            "kernel_ms": sum(split.values()),
                            "event_ms": time_ms(lambda: launch(*a))}))


def seg_times_main(profile: bool) -> None:
    """``--seg-times``: K1, K2 and K5 alone at ``seg_shapes``, each held
    against its plain version, median / min / max of REPS calls, with the
    library's configuration where the tree has one.  Only the launch and
    plain functions are used, so the same command times a parent tree's
    kernels.  ``--seg-profile`` adds ``seg_depth_profile``."""
    from repro_torch.kernels import build
    from repro_torch.kernels.tree_predict import tree_predict as tp

    dev = phase_environment()
    build.build(["tree_predict"])
    runs = {K1["name"]: (tp._launch_seg_packed, tp._seg_packed_plain),
            K2["name"]: (tp._launch_seg_simple, tp._seg_simple_plain),
            K5["name"]: (tp._launch_seg_sharded, tp._seg_sharded_plain)}
    shapes = seg_shapes(dev)
    for where, kernels in shapes.items():
        for name, args in kernels.items():
            launch, plain = runs[name]
            run = bound_launch(name, launch, args)
            max_abs_err(run(), plain(*args))
            line = {"seg_times": name, "shape": where, **time_stats(run)}
            if hasattr(tp, "seg_config") and name in SEG:
                cfg = seg_config_checked(name, args)
                line["config"] = {k: cfg[k] for k in (
                    "mode", "decode", "rows", "cols", "grid", "resident",
                    "smem")}
            log(json.dumps(line))
    if profile:
        seg_depth_profile(shapes["main-path-classification"])
    print(json.dumps({"ok": True}), flush=True)


def forest_depth_profile(args):
    """--forest-profile: K3 and K4 at the classification Liberty shape with
    ``max_depth`` cut to 0, 2, ..., 12 (0: the prologue, staging, x tiles
    and output alone), each held against its plain version."""
    for kern, launch, plain, _ in kernel_table()[2:]:
        name = kern["name"]
        a = list(args[name])
        for depth in range(0, TRAIN_DEPTH + 1, 2):
            a[5] = depth
            run = bound_launch(name, launch, tuple(a))
            max_abs_err(run(), plain(*a))
            log(json.dumps({"depth_profile": name, "max_depth": depth,
                            "ms": time_ms(run)}))
        log(json.dumps({"kernel_split": name,
                        **profile_kernels(bound_launch(name, launch,
                                                       args[name]))}))


def profile_kernels(fn, calls: int = 10) -> dict:
    """Device ms per call of each kernel ``fn`` launches, from
    ``torch.profiler`` over ``calls`` calls after a warm-up."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    split = {}
    for evt in prof.key_averages():
        us = getattr(evt, "device_time_total", None)
        if us is None:
            us = getattr(evt, "cuda_time_total", 0.0)
        if us:
            split[evt.key[:60]] = us / calls / 1e3
    return split


# ---------------------------------------------------------------------------
# the LM serving path (phase 8)
# ---------------------------------------------------------------------------

def close_err(got: torch.Tensor, want: torch.Tensor, tol) -> float:
    """The kernel's output must be finite and within ``tol`` = (atol,
    rtol) of its plain version's; returns the max abs difference."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{tuple(got.shape)} {got.dtype} != "
                             f"{tuple(want.shape)} {want.dtype}")
    if not bool(torch.isfinite(got).all()):
        raise AssertionError("kernel output has non-finite values")
    g, w = got.float(), want.float()
    err = float((g - w).abs().max())
    atol, rtol = tol
    if not torch.allclose(g, w, rtol=rtol, atol=atol):
        raise AssertionError(f"kernel differs from its plain version: {err} "
                             f"> {tol}")
    return err


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm())


def flash_bound(q, k, causal=True, window=None) -> tuple[float, str, dict]:
    """Least time for K7's work on these inputs: q, k, v read once (k and
    v hold BH / n_rep heads) and the output written once at HBM rate,
    against the two products' flops (an FMA, 2 flops, per kept (row,
    column) pair per head-dim element each) at the tensor cores' bf16 peak
    (the CUDA cores' for float32)."""
    bh, s, hd = q.shape
    bkv, t = k.shape[:2]
    rows = torch.arange(s)[:, None]
    cols = torch.arange(t)[None, :]
    keep = torch.ones((s, t), dtype=torch.bool)
    if causal:
        keep &= rows >= cols
    if window is not None:
        keep &= rows - cols < window
    pairs = bh * int(keep.sum())
    ops = 4 * hd * pairs
    nbytes = q.element_size() * hd * (2 * bh * s + 2 * bkv * t)
    peak = BF16_OPS_PER_S if q.dtype == torch.bfloat16 else CUDA_CORE_OPS_PER_S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / peak
    work = {"bytes": nbytes, "flops": ops, "kept_pairs": pairs}
    if t_bytes >= t_ops:
        return t_bytes * 1e3, "bytes", work
    return t_ops * 1e3, "operations", work


def phase_flash_parity(dev, errs):
    """K7 against ``_flash_plain`` on the same CUDA inputs at every case of
    FLASH_PARITY_CASES: float32 and bf16, head_dim 32 / 64 / 128, windows
    of 64, 100 and 256, ragged S (200, 2,049) and T (1,500), S != T both
    ways (with a window, rows that keep no key), and grouped KV heads
    (n_rep 2 and 4) through ``_flash_attention_grouped``."""
    from repro_torch.kernels.flash_attention import flash_attention as fa

    gen = torch.Generator(device=dev).manual_seed(7)
    for name, bh, s, t, hd, dtype, window, n_rep in FLASH_PARITY_CASES:
        q, k, v = (torch.randn((n, ln, hd), generator=gen,
                               device=dev).to(dtype)
                   for n, ln in ((bh, s), (bh // n_rep, t), (bh // n_rep, t)))
        if n_rep > 1:
            got = fa._flash_attention_grouped(q, k, v, n_rep, True, window)
        else:
            got = fa._launch_flash(q, k, v, True, window)
        torch.cuda.synchronize()
        err = close_err(got, fa._flash_plain(q, k, v, True, window,
                                             n_rep=n_rep),
                        FLASH_TOL[dtype])
        errs.append(err)
        log(json.dumps({"parity": K7["name"], "case": name,
                        "out": list(got.shape), "n_rep": n_rep,
                        "max_abs_err": err, "tol": FLASH_TOL[dtype]}))


def lm_flash_args(cfg, params, tokens):
    """The main path's attention inputs at layer 0 in the model's layout:
    q (B, S, H, hd), k and v (B, S, KV, hd)."""
    from repro_torch.models.attention import _project_qkv
    from repro_torch.models.layers import rms_norm
    from repro_torch.models.model import _positions, embed_inputs

    x = embed_inputs(cfg, params, tokens)
    h = rms_norm(x, params.layers[0].norm1, cfg.rms_eps)
    return _project_qkv(params.layers[0].attn, cfg, h,
                        _positions(*tokens.shape, tokens.device))


def phase_lm(dev):
    """Phase 8, the main path: qwen3-4b at full width and depth in bf16,
    ``make_prefill_step(cfg, use_flash=True)`` over 4 x 2,048 prompts with
    ``max_len`` 2,080 (a warm-up prefill first, then the timed one), then
    32 greedy ``make_decode_step`` steps.  K7's count must rise by exactly
    one launch per layer per prefill and not at all in decode."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import init_params

    cfg = get_config(LM_ARCH)
    assert (cfg.n_layers, cfg.d_model, cfg.dtype) == LM_SHAPE, cfg
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    host = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT),
                           generator=host).to(dev)
    prefill_step = make_prefill_step(cfg, use_flash=True)
    decode = make_decode_step(cfg)

    fa.reset_launches()
    _, warm_cache = prefill_step(params, tokens, max_len=LM_MAX_LEN)  # warm-up
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash"] == cfg.n_layers, fa.LAUNCHES

    fa.reset_launches()
    t0 = time.perf_counter()
    logits, cache = prefill_step(params, tokens, max_len=LM_MAX_LEN)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    assert fa.LAUNCHES["flash"] == cfg.n_layers, fa.LAUNCHES
    assert logits.shape == (LM_BATCH, cfg.vocab_size)
    assert bool(torch.isfinite(logits).all()), "prefill logits not finite"
    tok = logits.argmax(-1)
    out = [tok]
    t0 = time.perf_counter()
    for _ in range(LM_DECODE_STEPS):
        logits, cache = decode(params, tok, cache)
        tok = logits.argmax(-1)
        out.append(tok)
    torch.cuda.synchronize()
    t_decode = time.perf_counter() - t0
    launches = dict(fa.LAUNCHES)
    assert launches["flash"] == cfg.n_layers, launches
    assert bool(torch.isfinite(logits).all()), "decode logits not finite"
    assert int(cache["pos"].min()) == int(cache["pos"].max()) == (
        LM_PROMPT + LM_DECODE_STEPS
    )
    gen = torch.stack(out, 1)
    assert gen.shape == (LM_BATCH, LM_DECODE_STEPS + 1)
    assert 0 <= int(gen.min()) and int(gen.max()) < cfg.vocab_size
    # profiled decode steps at position S, from the warm-up's cache (the
    # main path's cache is full)
    profile = decode_profile(lambda: decode(params, tok, warm_cache))
    del warm_cache
    profile["device_busy_share"] = (
        profile["device_ms_per_step"] * LM_DECODE_STEPS / (t_decode * 1e3)
    )
    row = {
        "lm": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
        "heads": cfg.n_heads, "kv_heads": cfg.n_kv_heads,
        "params": cfg.n_params(), "dtype": cfg.dtype, "batch": LM_BATCH,
        "prompt": LM_PROMPT, "max_len": LM_MAX_LEN, "init_s": init_s,
        "prefill_s": t_prefill,
        "prefill_tok_s": LM_BATCH * LM_PROMPT / t_prefill,
        "decode_steps": LM_DECODE_STEPS,
        "decode_ms_per_step": t_decode / LM_DECODE_STEPS * 1e3,
        "decode_tok_s": LM_BATCH * LM_DECODE_STEPS / t_decode,
        "max_memory_allocated": torch.cuda.max_memory_allocated(dev),
        "flash_launches_per_prefill": launches["flash"],
        "sample_tokens": gen[0, :8].tolist(),
        "decode_profile": profile,
    }
    return cfg, params, tokens, launches, row


def decode_profile(step, steps: int = 2) -> dict:
    """``torch.profiler`` over ``steps`` decode steps: summed device kernel
    ms and kernel launches per step, and the host ms per step under the
    profiler (which slows the host; ``phase_lm`` divides the device ms by
    the unprofiled step time for the device's busy share)."""
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3 / steps
    device_us = launches = 0
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            device_us += e.self_device_time_total
        if e.key in ("cudaLaunchKernel", "cuLaunchKernel", "cuLaunchKernelEx",
                     "cudaLaunchKernelExC"):
            launches += e.count
    return {"profiled_host_ms_per_step": host_ms,
            "device_ms_per_step": device_us / 1e3 / steps,
            "launches_per_step": launches / steps}


def model_pair_checks(cfg, params, tokens, nxt):
    """Flash against dense prefill, and decode after prefill(S) against
    prefill(S + 1)'s last logits, for one set of weights."""
    from repro_torch.launch.steps import make_decode_step, make_prefill_step

    flash = make_prefill_step(cfg, use_flash=True)
    dense = make_prefill_step(cfg, use_flash=False)
    lf, cache = flash(params, tokens, max_len=LM_MAX_LEN)
    ld, _ = dense(params, tokens, max_len=LM_MAX_LEN)
    l1, _ = make_decode_step(cfg)(params, nxt, cache)
    del cache
    l2, _ = flash(params, torch.cat([tokens, nxt[:, None]], 1),
                  max_len=LM_MAX_LEN)
    for name, t in (("flash", lf), ("dense", ld), ("decode", l1),
                    ("prefill S+1", l2)):
        assert bool(torch.isfinite(t).all()), f"{name} logits not finite"
    return {
        "flash_vs_dense_rel_l2": rel_l2(lf, ld),
        "decode_vs_prefill_rel_l2": rel_l2(l1, l2),
        "decode_vs_prefill_max_abs": float((l1.float() - l2.float()).abs().max()),
        "decode_vs_prefill_allclose_5e-2": bool(torch.allclose(
            l1.float(), l2.float(), rtol=DECODE_RTOL, atol=DECODE_ATOL)),
    }, lf, ld


def seed_checks(dev, cfg, params, tokens, nxt):
    """The whole-model checks for one set of weights and prompts.  In
    float32 (the same weights upcast, so only rounding differs) the flash
    and dense prefills agree to F32_MODEL_REL_L2 and decode after
    prefill(S) matches prefill(S + 1) at rtol = atol = 5e-2 and
    F32_MODEL_REL_L2.  In bf16, the served precision, the same differences
    are read beside each path's distance from the float32 run (bf16's
    rounding floor over 36 layers)."""
    import dataclasses

    from repro_torch.models import TransformerLM

    bf16, bf_flash, bf_dense = model_pair_checks(cfg, params, tokens, nxt)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params32 = TransformerLM(cfg32, dev)
    with torch.no_grad():
        for p32, p in zip(params32.parameters(), params.parameters()):
            p32.copy_(p.float())
    f32, f_flash, _ = model_pair_checks(cfg32, params32, tokens, nxt)
    del params32
    torch.cuda.empty_cache()
    bf16["flash_vs_f32_rel_l2"] = rel_l2(bf_flash, f_flash)
    bf16["dense_vs_f32_rel_l2"] = rel_l2(bf_dense, f_flash)
    return {"float32": f32, "bfloat16": bf16}


def phase_lm_checks(dev, cfg, params, tokens):
    """``seed_checks`` on the main path's weights and prompts (seed 0) and
    on fresh weights and prompts for each further seed of LM_CHECK_SEEDS;
    every seed's float32 differences must be within F32_MODEL_REL_L2 (and
    the decode allclose), its bf16 differences within BF16_MODEL_REL_L2."""
    from repro_torch.models import init_params

    readings = {}
    for seed in LM_CHECK_SEEDS:
        host = torch.Generator().manual_seed(2 + 100 * seed)
        nxt = torch.randint(0, cfg.vocab_size, (LM_BATCH,),
                            generator=host).to(dev)
        if seed == 0:
            readings[seed] = seed_checks(dev, cfg, params, tokens, nxt)
            continue
        p = init_params(cfg, seed=seed, device=dev)
        tok = torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT),
                            generator=host).to(dev)
        readings[seed] = seed_checks(dev, cfg, p, tok, nxt)
        del p, tok
        torch.cuda.empty_cache()
    row = {"lm_checks": cfg.name, "seeds": readings,
           "bounds": {"float32_rel_l2": F32_MODEL_REL_L2,
                      "bfloat16_rel_l2": BF16_MODEL_REL_L2,
                      "decode_rtol_atol": DECODE_RTOL}}
    log(json.dumps(row))
    for seed, r in readings.items():
        f32, bf16 = r["float32"], r["bfloat16"]
        assert f32["flash_vs_dense_rel_l2"] <= F32_MODEL_REL_L2, (seed, f32)
        assert f32["decode_vs_prefill_rel_l2"] <= F32_MODEL_REL_L2, (seed, f32)
        assert f32["decode_vs_prefill_allclose_5e-2"], (seed, f32)
        assert bf16["flash_vs_dense_rel_l2"] <= BF16_MODEL_REL_L2, (seed, bf16)
        assert bf16["decode_vs_prefill_rel_l2"] <= BF16_MODEL_REL_L2, (seed,
                                                                     bf16)
    return row


def ptxas_report(lib: str, kernel: str) -> dict | None:
    """Registers, stack and spills that ``-Xptxas -v`` reported in this
    run's build of ``lib`` for the entry whose mangled name holds
    ``kernel``; None when the library was not built in this run."""
    import re

    from repro_torch.kernels import build

    text = build.build_logs.get(lib)
    if text is None:
        return None
    entry = text[text.index(kernel):] if kernel in text else ""
    nums = {}
    for key, pat in (("stack_bytes", r"(\d+) bytes stack frame"),
                     ("spill_store_bytes", r"(\d+) bytes spill stores"),
                     ("spill_load_bytes", r"(\d+) bytes spill loads"),
                     ("registers", r"Used (\d+) registers"),
                     ("static_smem_bytes", r"(\d+) bytes smem")):
        m = re.search(pat, entry.split("Compiling entry")[0])
        nums[key] = int(m.group(1)) if m else 0
    return nums


def flash_entry(launches, main_args, errs, prefill_s):
    """K7's entry of the ``{"kernels": [...]}`` line, at the main path's
    layer-0 inputs (BH = 128 query heads over 32 KV heads, n_rep 4, S =
    2,048, hd = 128, bf16) through the grouped call the model makes, with
    ``scaled_dot_product_attention`` on the KV heads repeated as the
    yardstick (the port never calls it), the float32 route at the same
    shape, and the layout copies ``ops.flash_attention`` makes around K7."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention.ops import bh_layout

    q4, k4, v4 = main_args
    b, s, h, hd = q4.shape
    q, k, v, n_rep = bh_layout(q4, k4, v4)
    got = fa._flash_attention_grouped(q, k, v, n_rep, True, None)
    torch.cuda.synchronize()
    err = close_err(got, fa._flash_plain(q, k, v, True, None, n_rep=n_rep),
                    FLASH_TOL[q.dtype])
    errs.append(err)
    log(json.dumps({"parity": K7["name"], "case": "main-path-layer0",
                    "out": list(got.shape), "n_rep": n_rep,
                    "max_abs_err": err, "tol": FLASH_TOL[q.dtype]}))
    bms, by, work = flash_bound(q, k)
    ms = time_ms(lambda: fa._launch_flash(q, k, v, True, None, n_rep))
    kr, vr = k.repeat_interleave(n_rep, 0), v.repeat_interleave(n_rep, 0)
    qf, kf, vf = q.float(), k.float(), v.float()
    entry = dict(K7)
    entry.update({
        "launches": launches["flash"],
        "max_abs_err": max(errs),
        "ms": ms,
        "plain_ms": time_ms(lambda: fa._flash_plain(q, k, v, True, None,
                                                    n_rep=n_rep)),
        "bound_ms": bms, "bound_by": by,
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
            q[None], kr[None], vr[None], is_causal=True)),
        "library_note": "torch.nn.functional.scaled_dot_product_attention"
                        "(is_causal=True) on the KV heads repeated, timed "
                        "only",
        "timed_at": "one prefill layer of qwen3-4b: BH=128 (32 KV heads, "
                    "n_rep 4), S=T=2048, hd=128, bf16, causal",
        "bf16_route": "wgmma (tensor cores), TMA into a K/V ring, P split "
                      "into bf16 high and low parts, S of tile i issued with "
                      "P V of tile i - 1, warpgroups taking turns",
        "tc_config": fa.tc_config(hd),
        "ptxas_bf16": ptxas_report("flash_attention",
                                   f"flash_tc_kernelILi{hd}"),
        "f32_route_ms": time_ms(lambda: fa._launch_flash(
            qf, kf, vf, True, None, n_rep)),
        "layout_ms": {
            "q_k_v_heads_first": time_ms(lambda: bh_layout(q4, k4, v4)),
            "out_tokens_first": time_ms(lambda: got.reshape(
                b, h, s, hd).transpose(1, 2).reshape(b, s, h * hd)),
        },
        "work": work,
        "share_of_prefill": ms * launches["flash"] / (prefill_s * 1e3),
    })
    return entry


# ---------------------------------------------------------------------------
# RWKV6 serving through K8, and the §7 quantizer K6 (phase 9)
# ---------------------------------------------------------------------------

def wkv_inputs(dev, gen, bh, s, hd, init, decay):
    """Seeded K8 inputs: r, k, v ~ N(0, 1); w = exp(-exp(log w)) with
    log w ~ U(-6, -4) ("model") or U(-6, 2.5) ("extreme"); u ~ 0.1 N(0, 1);
    the initial state zero or ~ 0.1 N(0, 1)."""
    r, k, v = (torch.randn((bh, s, hd), generator=gen, device=dev)
               for _ in range(3))
    hi = -4.0 if decay == "model" else 2.5
    logw = torch.rand((bh, s, hd), generator=gen, device=dev) * (hi + 6) - 6
    w = torch.exp(-torch.exp(logw))
    u = 0.1 * torch.randn((bh, hd), generator=gen, device=dev)
    s0 = torch.zeros((bh, hd, hd), device=dev)
    if init == "state":
        s0 = 0.1 * torch.randn((bh, hd, hd), generator=gen, device=dev)
    return r, k, v, w, u, s0


def wkv_model_inputs(dev, gen, b, s, h, hd, dtype, init, decay):
    """``wkv_inputs`` on the model's layout: r, k, v (B, S, H, hd) in
    ``dtype``, w (B, S, H, hd) float32, u (H, hd) and the state
    (B, H, hd, hd) float32, all contiguous."""
    r, k, v, w, u, s0 = wkv_inputs(dev, gen, b * h, s, hd, init, decay)

    def unfold(a):
        return a.reshape(b, h, s, hd).transpose(1, 2).contiguous()

    r, k, v = (unfold(a).to(dtype) for a in (r, k, v))
    return (r, k, v, unfold(w), u[:h].contiguous(),
            s0.reshape(b, h, hd, hd))


def wkv_err(got, want) -> float:
    """K8's (y, final state) within WKV_TOL of the plain version's."""
    return max(close_err(g, w, WKV_TOL) for g, w in zip(got, want))


def wkv_bound(args) -> tuple[float, str, dict]:
    """Least time for K8's work on ``args`` (either layout): r, k, v (in
    their type), w and u read once, the initial state read once, y and the
    final state written once (float32) at HBM rate, against the flops WKV6
    cannot avoid at the CUDA cores' float32 peak: per step, 4 per state
    element (an FMA for r . S and an FMA for the rank-one update k v^T; the
    decay's product is one per element per group of steps taken together,
    so it vanishes as the group grows, as in the chunked form) and 5 per
    head-dim element for the u bonus, which factors out as
    v_j * sum_i r_i u_i k_i."""
    r, _, _, _, u, state = args
    hd = r.shape[-1]
    n = r.numel()
    steps = n // hd  # (b, h, t) triples
    nbytes = (3 * n * r.element_size() + 4 * n + 4 * n + 4 * u.numel()
              + 2 * 4 * state.numel())
    flops = steps * (4 * hd * hd + 5 * hd)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / CUDA_CORE_OPS_PER_S
    work = {"bytes": nbytes, "flops": flops}
    if t_bytes >= t_ops:
        return t_bytes * 1e3, "bytes", work
    return t_ops * 1e3, "operations", work


def phase_wkv_parity(dev, errs):
    """K8 against ``_wkv6_plain`` on the same CUDA inputs at every case of
    WKV_PARITY_CASES: head_dim 16 / 32 / 64, S 64 / 70 / 128 / 2,049,
    chunk 16 / 32 / 64 through ``wkv6_scan`` (and the ragged S straight
    through the launch), zero and non-zero initial states, the model's
    decays and the extreme ones; and every WKV_MODEL_PARITY_CASES case on
    the model's layout, through ``wkv6_bh``, against
    ``_wkv6_model_plain``."""
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan as ws

    gen = torch.Generator(device=dev).manual_seed(9)
    for name, b, s, h, hd, dtype, init, decay in WKV_MODEL_PARITY_CASES:
        args = wkv_model_inputs(dev, gen, b, s, h, hd, dtype, init, decay)
        got = ws.wkv6_bh(*args)
        torch.cuda.synchronize()
        err = wkv_err(got, ws._wkv6_model_plain(*args))
        errs.append(err)
        log(json.dumps({"parity": K8["name"], "case": name,
                        "out": list(got[0].shape), "max_abs_err": err,
                        "tol": WKV_TOL}))
    for name, bh, s, hd, chunk, init, decay in WKV_PARITY_CASES:
        args = wkv_inputs(dev, gen, bh, s, hd, init, decay)
        if chunk is None:
            got = ws._launch_wkv6(*args)
        else:
            got = ws.wkv6_scan(*args, chunk=chunk)
        torch.cuda.synchronize()
        err = wkv_err(got, ws._wkv6_plain(*args))
        errs.append(err)
        log(json.dumps({"parity": K8["name"], "case": name,
                        "out": list(got[0].shape), "max_abs_err": err,
                        "tol": WKV_TOL}))


def equal_err(got, want) -> float:
    """K6's (q, recon) must equal the plain version's bit for bit."""
    for g, w in zip(got, want):
        if g.shape != w.shape or g.dtype != w.dtype or not torch.equal(g, w):
            raise AssertionError("K6 differs from its plain version")
    return 0.0


def section7(x, recon, step, dither) -> float:
    """|recon - x| against the §7 bound, step / 2 (step with dither), plus
    float32 rounding slack (step * 2**-10 + 2**-22 * max |x|); returns the
    largest error as a share of the bound."""
    xf = x.float()
    err = float((recon - xf).abs().max())
    bound = ((step if dither else step / 2) * (1 + 2**-10)
             + 2**-22 * float(xf.abs().max()))
    if not err <= bound:
        raise AssertionError(f"§7 bound broken: {err} > {bound}")
    return err / bound if bound else 0.0


def phase_quant_parity(dev):
    """``quantize_tensor`` on the card (K6) against ``_quantize_plain`` on
    the same tiles, bit for bit, at every (shape, dtype) of QUANT_SHAPES x
    QUANT_BITS x QUANT_DITHERS (n < 256, n not a multiple of 256, float32
    and bf16), each within its §7 bound.  Returns the errors (0.0)."""
    from repro_torch.kernels.quantize import quantize as qz
    from repro_torch.kernels.quantize.ops import quantize_tensor, tiles

    gen = torch.Generator(device=dev).manual_seed(6)
    errs = []
    for shape, dtype in QUANT_SHAPES:
        x = (3 * torch.randn(shape, generator=gen, device=dev)).to(dtype)
        n = x.numel()
        worst = 0.0
        for bits in QUANT_BITS:
            for dither, seed in QUANT_DITHERS:
                q, recon, (lo, step) = quantize_tensor(x, bits, dither, seed)
                torch.cuda.synchronize()
                pq, precon = qz._quantize_plain(tiles(x), lo, step, 1 << bits,
                                                dither, seed)
                errs.append(equal_err(
                    (q.reshape(-1), recon.reshape(-1)),
                    (pq.reshape(-1)[:n], precon.reshape(-1)[:n])))
                worst = max(worst, section7(x, recon, step, dither))
        log(json.dumps({"parity": K6["name"], "shape": list(shape),
                        "dtype": str(dtype), "bits": list(QUANT_BITS),
                        "dithers": [list(d) for d in QUANT_DITHERS],
                        "max_abs_err": 0.0,
                        "section7_err_over_bound": worst}))
    return errs


def perturb_u(params, seed, dev):
    """Set every layer's bonus u (0 at init) to 0.1 N(0, 1) from ``seed``,
    so the checks see the u term; returns the values it replaced."""
    gen = torch.Generator(device=dev).manual_seed(1000 + seed)
    saved = []
    with torch.no_grad():
        for blk in params.layers:
            u = blk.attn.u
            saved.append(u.clone())
            u.copy_(0.1 * torch.randn(u.shape, generator=gen, device=dev))
    return saved


def phase_rwkv(dev):
    """Phase 9, the main path: rwkv6-1.6b at full width and depth in bf16,
    ``make_prefill_step(cfg, use_flash=True)`` over 4 x 2,048 prompts with
    ``max_len`` 2,080 (a warm-up prefill first, then the timed one), then
    32 greedy ``make_decode_step`` steps.  K8's count must rise by exactly
    one launch per layer per prefill and not at all in decode."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan as ws
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import init_params

    cfg = get_config(RWKV_ARCH)
    assert (cfg.n_layers, cfg.d_model, cfg.dtype) == RWKV_SHAPE, cfg
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    host = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (RWKV_BATCH, RWKV_PROMPT),
                           generator=host).to(dev)
    prefill_step = make_prefill_step(cfg, use_flash=True)
    decode = make_decode_step(cfg)

    # the warm-up prefill also records what each K8 launch is handed: the
    # model's own (B, S, H, hd) bf16 tensors, not a folded float32 copy
    launch, handed = ws._launch_wkv6, []

    def spy(r, k, v, w, u, state):
        handed.append((tuple(r.shape), str(r.dtype), str(w.dtype)))
        return launch(r, k, v, w, u, state)

    ws.reset_launches()
    ws._launch_wkv6 = spy
    try:
        _, warm_cache = prefill_step(params, tokens, max_len=RWKV_MAX_LEN)
    finally:
        ws._launch_wkv6 = launch
    torch.cuda.synchronize()
    assert ws.LAUNCHES["wkv6"] == cfg.n_layers, ws.LAUNCHES
    model_layout = ((RWKV_BATCH, RWKV_PROMPT, cfg.n_heads, cfg.head_dim_),
                    "torch.bfloat16", "torch.float32")
    assert handed == [model_layout] * cfg.n_layers, handed

    ws.reset_launches()
    t0 = time.perf_counter()
    logits, cache = prefill_step(params, tokens, max_len=RWKV_MAX_LEN)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    assert ws.LAUNCHES["wkv6"] == cfg.n_layers, ws.LAUNCHES
    assert logits.shape == (RWKV_BATCH, cfg.vocab_size)
    assert bool(torch.isfinite(logits).all()), "prefill logits not finite"
    tok = logits.argmax(-1)
    out = [tok]
    t0 = time.perf_counter()
    for _ in range(RWKV_DECODE_STEPS):
        logits, cache = decode(params, tok, cache)
        tok = logits.argmax(-1)
        out.append(tok)
    torch.cuda.synchronize()
    t_decode = time.perf_counter() - t0
    launches = dict(ws.LAUNCHES)
    assert launches["wkv6"] == cfg.n_layers, launches
    assert bool(torch.isfinite(logits).all()), "decode logits not finite"
    assert int(cache["pos"].min()) == int(cache["pos"].max()) == (
        RWKV_PROMPT + RWKV_DECODE_STEPS
    )
    gen = torch.stack(out, 1)
    assert gen.shape == (RWKV_BATCH, RWKV_DECODE_STEPS + 1)
    assert 0 <= int(gen.min()) and int(gen.max()) < cfg.vocab_size
    profile = decode_profile(lambda: decode(params, tok, warm_cache))
    del warm_cache
    profile["device_busy_share"] = (
        profile["device_ms_per_step"] * RWKV_DECODE_STEPS / (t_decode * 1e3)
    )
    row = {
        "rwkv6": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
        "heads": cfg.n_heads, "head_dim": cfg.head_dim_, "d_ff": cfg.d_ff,
        "vocab": cfg.vocab_size, "dtype": cfg.dtype, "batch": RWKV_BATCH,
        "prompt": RWKV_PROMPT, "max_len": RWKV_MAX_LEN, "init_s": init_s,
        "prefill_s": t_prefill,
        "prefill_tok_s": RWKV_BATCH * RWKV_PROMPT / t_prefill,
        "decode_steps": RWKV_DECODE_STEPS,
        "decode_ms_per_step": t_decode / RWKV_DECODE_STEPS * 1e3,
        "decode_tok_s": RWKV_BATCH * RWKV_DECODE_STEPS / t_decode,
        "max_memory_allocated": torch.cuda.max_memory_allocated(dev),
        "wkv6_launches_per_prefill": launches["wkv6"],
        "wkv6_handed": {"r_shape": list(model_layout[0]),
                        "r_dtype": model_layout[1],
                        "w_dtype": model_layout[2]},
        "sample_tokens": gen[0, :8].tolist(),
        "decode_profile": profile,
    }
    return cfg, params, tokens, launches, row


def rwkv_pair_checks(cfg, params, tokens, nxt):
    """The K8 prefill against the reference-branch prefill
    (``use_flash=False``: ``wkv_chunked`` at S = 2,048), logits and every
    layer's cache, and decode after prefill(S) against prefill(S + 1)'s
    last logits, for one set of weights."""
    from repro_torch.launch.steps import make_decode_step, make_prefill_step

    k8 = make_prefill_step(cfg, use_flash=True)
    ref = make_prefill_step(cfg, use_flash=False)
    lk, ck = k8(params, tokens, max_len=RWKV_MAX_LEN)
    lr, cr = ref(params, tokens, max_len=RWKV_MAX_LEN)
    cache_err = max(
        rel_l2(a[key], b[key])
        for a, b in zip(ck["layers"], cr["layers"])
        for key in ("state", "x_prev_tm", "x_prev_cm")
    )
    del cr
    l1, _ = make_decode_step(cfg)(params, nxt, ck)
    del ck
    l2, _ = k8(params, torch.cat([tokens, nxt[:, None]], 1),
               max_len=RWKV_MAX_LEN)
    for name, t in (("k8", lk), ("reference", lr), ("decode", l1),
                    ("prefill S+1", l2)):
        assert bool(torch.isfinite(t).all()), f"{name} logits not finite"
    return {
        "k8_vs_reference_rel_l2": rel_l2(lk, lr),
        "k8_vs_reference_cache_rel_l2": cache_err,
        "decode_vs_prefill_rel_l2": rel_l2(l1, l2),
        "decode_vs_prefill_max_abs": float(
            (l1.float() - l2.float()).abs().max()),
    }, (lk, lr, l1, l2)


def rwkv_seed_checks(dev, cfg, params, tokens, nxt):
    """``rwkv_pair_checks`` in bf16 and in float32 (the same weights
    upcast).  The bf16 witness: the reference branch's distance from the
    float32 K8 prefill (for the prefill comparison) and the bf16
    prefill(S + 1)'s distance from its float32 run (for decode)."""
    import dataclasses

    from repro_torch.models import TransformerLM

    bf16, (bk, br, bd, bs1) = rwkv_pair_checks(cfg, params, tokens, nxt)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params32 = TransformerLM(cfg32, dev)
    with torch.no_grad():
        for p32, p in zip(params32.parameters(), params.parameters()):
            p32.copy_(p.float())
    f32, (fk, _, _, fs1) = rwkv_pair_checks(cfg32, params32, tokens, nxt)
    del params32
    torch.cuda.empty_cache()
    bf16["k8_vs_f32_rel_l2"] = rel_l2(bk, fk)
    bf16["reference_vs_f32_rel_l2"] = rel_l2(br, fk)
    bf16["prefill_s1_vs_f32_rel_l2"] = rel_l2(bs1, fs1)
    bf16["decode_vs_f32_rel_l2"] = rel_l2(bd, fs1)
    return {"float32": f32, "bfloat16": bf16}


def phase_rwkv_checks(dev, cfg, params, tokens):
    """``rwkv_seed_checks`` on the main path's weights (seed 0) and on
    fresh weights and prompts for seeds 1 and 2, every time with u
    perturbed from the seed (``perturb_u``; the old u is put back).
    Float32 differences must be within
    RWKV_F32_REL_L2; bf16 differences within RWKV_BF16_OVER_FLOOR times
    their witness."""
    from repro_torch.models import init_params

    readings = {}
    for seed in RWKV_CHECK_SEEDS:
        host = torch.Generator().manual_seed(2 + 100 * seed)
        nxt = torch.randint(0, cfg.vocab_size, (RWKV_BATCH,),
                            generator=host).to(dev)
        if seed == 0:
            p, tok = params, tokens
        else:
            p = init_params(cfg, seed=seed, device=dev)
            tok = torch.randint(0, cfg.vocab_size, (RWKV_BATCH, RWKV_PROMPT),
                                generator=host).to(dev)
        saved = perturb_u(p, seed, dev)
        readings[seed] = rwkv_seed_checks(dev, cfg, p, tok, nxt)
        with torch.no_grad():
            for blk, u in zip(p.layers, saved):
                blk.attn.u.copy_(u)
        del p, tok
        torch.cuda.empty_cache()
    row = {"rwkv6_checks": cfg.name, "seeds": readings,
           "bounds": {"float32_rel_l2": RWKV_F32_REL_L2,
                      "bfloat16_over_witness": RWKV_BF16_OVER_FLOOR}}
    log(json.dumps(row))
    for seed, r in readings.items():
        f32, bf16 = r["float32"], r["bfloat16"]
        for key in ("k8_vs_reference_rel_l2", "k8_vs_reference_cache_rel_l2",
                    "decode_vs_prefill_rel_l2"):
            assert f32[key] <= RWKV_F32_REL_L2, (seed, key, f32)
        witness = bf16["reference_vs_f32_rel_l2"]
        assert bf16["k8_vs_reference_rel_l2"] <= (
            RWKV_BF16_OVER_FLOOR * witness), (seed, bf16)
        assert bf16["decode_vs_prefill_rel_l2"] <= (
            RWKV_BF16_OVER_FLOOR * bf16["prefill_s1_vs_f32_rel_l2"]), (seed,
                                                                      bf16)
    return row


def phase_quant_model(params):
    """K6 through its entry point over the served model: ``quantize_tensor``
    at QUANT_MODEL_BITS bits, without and with dither (seed 0), over every
    2-D parameter of the rwkv6-1.6b in bf16; each within its §7 bound.
    ``LAUNCHES["quantize"]`` is reset before each pass and must equal the
    number of tensors after it.  Returns the line, the launches of both
    passes, and the largest and a channel-mix-sized weight."""
    from repro_torch.kernels.quantize import quantize as qz
    from repro_torch.kernels.quantize.ops import quantize_tensor

    weights = [(n, p) for n, p in params.named_parameters() if p.dim() == 2]
    passes = {}
    launches = 0
    for dither in (False, True):
        qz.reset_launches()
        t0 = time.perf_counter()
        worst = 0.0
        elems = 0
        for _, w in weights:
            _, recon, (_, step) = quantize_tensor(w, QUANT_MODEL_BITS, dither,
                                                  0)
            worst = max(worst, section7(w, recon, step, dither))
            elems += w.numel()
            del recon
        torch.cuda.synchronize()
        assert qz.LAUNCHES["quantize"] == len(weights), qz.LAUNCHES
        launches += qz.LAUNCHES["quantize"]
        passes["dither" if dither else "plain"] = {
            "tensors": len(weights), "elements": elems,
            "launches": qz.LAUNCHES["quantize"],
            "host_s": time.perf_counter() - t0,
            "section7_err_over_bound": worst,
        }
    largest = max(weights, key=lambda nw: nw[1].numel())
    mlp = params.layers[0].mlp.w_k
    row = {"quantize_model": RWKV_ARCH, "bits": QUANT_MODEL_BITS,
           "largest": [largest[0], list(largest[1].shape)], "passes": passes}
    return row, launches, largest[1], mlp


def rwkv_wkv_args(cfg, params, tokens):
    """The r, k, v, w (B, S, H, hd), u (H, hd) and zero state that the main
    path hands ``ops.wkv6`` at layer 0, as it hands them (bf16 r, k, v and
    u, float32 w and state)."""
    from repro_torch.models.layers import rms_norm
    from repro_torch.models.model import embed_inputs
    from repro_torch.models.rwkv6 import _mix_inputs

    x = embed_inputs(cfg, params, tokens)
    h = rms_norm(x, params.layers[0].norm1, cfg.rms_eps)
    b, _, d = h.shape
    hd = cfg.head_dim_
    attn = params.layers[0].attn
    x_prev = torch.zeros((b, d), dtype=h.dtype, device=h.device)
    r, k, v, _, w = _mix_inputs(attn, cfg, h, x_prev)
    state = torch.zeros((b, cfg.n_heads, hd, hd), device=h.device)
    return r, k, v, w, attn.u, state


def wkv6_entry(launches, ops_args, errs, prefill_s):
    """K8's entry of the ``{"kernels": [...]}`` line, at the main path's
    layer-0 launch (B 4, S 2,048, H 32, hd 64; bf16 r, k, v in the model's
    layout, as ``ops.wkv6`` hands them over), and at the same work folded
    to (BH, S, hd) float32 by ``bh_layout``, as the port ran it before;
    each with its own bound, and median / min / max over REPS.  Also
    ``ops.wkv6`` whole (its peak device memory above its inputs must be
    its outputs', so it copies no input), the ``bh_layout`` copies it no
    longer makes, the library's tiling and the compiler's report.  No
    single PyTorch call computes the WKV6 recurrence."""
    from repro_torch.kernels.rwkv6_scan import ops
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan as ws

    r, k, v, w, u, state = ops_args
    main_args = (r, k, v, w, u.float(), state)
    bh_args = ws.bh_layout(*main_args)
    for case, args, plain in (("main-path-layer0", main_args,
                               ws._wkv6_model_plain),
                              ("main-path-layer0-bh-f32", bh_args,
                               ws._wkv6_plain)):
        got = ws._launch_wkv6(*args)
        torch.cuda.synchronize()
        err = wkv_err(got, plain(*args))
        errs.append(err)
        log(json.dumps({"parity": K8["name"], "case": case,
                        "out": list(got[0].shape), "max_abs_err": err,
                        "tol": WKV_TOL}))
    del got
    bms, by, work = wkv_bound(main_args)
    stats = time_stats(lambda: ws._launch_wkv6(*main_args))
    bh_bms, bh_by, bh_work = wkv_bound(bh_args)
    bh_stats = time_stats(lambda: ws._launch_wkv6(*bh_args))

    # ops.wkv6 whole: no input copied on the card, so its peak above what
    # was allocated before is y, the final state and u upcast
    dev = r.device
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    y, s_final = ops.wkv6(*ops_args)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated(dev) - before
    out_bytes = 4 * (y.numel() + s_final.numel() + u.numel())
    del y, s_final
    assert extra <= out_bytes + (1 << 20), (extra, out_bytes)

    entry = dict(K8)
    entry.update({
        "launches": launches["wkv6"],
        "max_abs_err": max(errs),
        "ms": stats["median"], "ms_min": stats["min"], "ms_max": stats["max"],
        "plain_ms": time_ms(lambda: ws._wkv6_model_plain(*main_args)),
        "bound_ms": bms, "bound_by": by,
        "library_ms": None,
        "library_note": "no single PyTorch call computes the WKV6 "
                        "recurrence",
        "timed_at": "one prefill layer of rwkv6-1.6b: B=4, S=2048, H=32, "
                    "hd=64, bf16 r/k/v in (B, S, H, hd), float32 w and "
                    "state, as ops.wkv6 hands them over",
        "work": work,
        "bh_f32": {
            "ms": bh_stats["median"], "ms_min": bh_stats["min"],
            "ms_max": bh_stats["max"], "bound_ms": bh_bms,
            "bound_by": bh_by, "work": bh_work,
            "timed_at": "the same work folded by bh_layout: (BH, S, hd) "
                        "float32, BH=128",
        },
        "ops_wkv6_ms": time_stats(lambda: ops.wkv6(*ops_args)),
        "ops_wkv6_peak_extra_bytes": extra,
        "ops_wkv6_out_bytes": out_bytes,
        "bh_layout_copies_ms": time_stats(lambda: ws.bh_layout(*main_args)),
        "config": {"bf16": ws.config(64, torch.bfloat16),
                   "float32": ws.config(64, torch.float32)},
        "ptxas_report": {
            "bf16": ptxas_report("rwkv6_scan", "wkv6_kernelILi1ELi64E"),
            "float32": ptxas_report("rwkv6_scan", "wkv6_kernelILi0ELi64E"),
        },
        "share_of_prefill": stats["median"] * launches["wkv6"]
        / (prefill_s * 1e3),
    })
    return entry


def quant_bound(x, dither) -> tuple[float, str, dict]:
    """Least time for K6's work: x read once, q (int32) and recon (float32)
    written once, at HBM rate, against 9 operations per element (10 more
    for the dither's hash) at the CUDA cores' rate."""
    n = x.numel()
    nbytes = n * (x.element_size() + 8)
    ops = n * (9 + (11 if dither else 0))
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / CUDA_CORE_OPS_PER_S
    work = {"bytes": nbytes, "ops": ops, "elements": n}
    if t_bytes >= t_ops:
        return t_bytes * 1e3, "bytes", work
    return t_ops * 1e3, "operations", work


def quant_entry(launches, largest, mlp, errs):
    """K6's entry of the ``{"kernels": [...]}`` line: held against its
    plain version at the served model's largest weight (without and with
    dither), and timed there without dither; also timed at a channel-mix
    weight (2,048 x 7,168)."""
    from repro_torch.kernels.quantize import quantize as qz
    from repro_torch.kernels.quantize.ops import tiles

    def args_of(w):
        flat = w.reshape(-1)
        lo, hi = float(flat.min()), float(flat.max())
        n_levels = 1 << QUANT_MODEL_BITS
        return tiles(w), lo, max((hi - lo) / n_levels, 1e-30), n_levels

    x2, lo, step, n_levels = args_of(largest)
    for dither in (False, True):
        got = qz._launch_quantize(x2, lo, step, n_levels, dither, 0)
        torch.cuda.synchronize()
        errs.append(equal_err(got, qz._quantize_plain(x2, lo, step, n_levels,
                                                      dither, 0)))
        del got
    log(json.dumps({"parity": K6["name"], "case": "main-path-largest",
                    "out": list(x2.shape), "max_abs_err": 0.0}))
    bms, by, work = quant_bound(x2, False)
    entry = dict(K6)
    entry.update({
        "launches": launches,
        "max_abs_err": max(errs),
        "ms": time_ms(lambda: qz._launch_quantize(x2, lo, step, n_levels)),
        "plain_ms": time_ms(lambda: qz._quantize_plain(x2, lo, step,
                                                      n_levels)),
        "bound_ms": bms, "bound_by": by,
        "library_ms": None,
        "library_note": "torch.quantize_per_tensor rounds instead of "
                        "flooring, has no dither and returns uint8: not the "
                        "same function",
        "timed_at": f"the largest weight of rwkv6-1.6b, "
                    f"{list(largest.shape)} bf16, {QUANT_MODEL_BITS} bits, "
                    "no dither",
        "work": work,
    })
    m2, mlo, mstep, _ = args_of(mlp)
    mbms, mby, _ = quant_bound(m2, False)
    entry["channel_mix_weight"] = {
        "shape": list(mlp.shape),
        "ms": time_ms(lambda: qz._launch_quantize(m2, mlo, mstep, n_levels)),
        "plain_ms": time_ms(lambda: qz._quantize_plain(m2, mlo, mstep,
                                                      n_levels)),
        "bound_ms": mbms, "bound_by": mby,
    }
    return entry


# ---------------------------------------------------------------------------
# the fleet store's main path (phase 10)
# ---------------------------------------------------------------------------

def phase_fleet_store(dev):
    """RFT1 round trip (module docstring, phase 10a): each 100-user fleet
    built on the card and on the CPU serializes to the same bytes, and
    each store loaded from them serializes back to them.  Returns {task:
    card store} and the rows logged."""
    from repro_torch.store import ForestStore, build_store, make_synthetic_fleet

    stores, rows = {}, {}
    for task in LIBERTY:
        fleet = make_synthetic_fleet(FLEET_BENCH_USERS, task, seed=0)
        t0 = time.perf_counter()
        card = build_store(fleet, device=dev)
        t1 = time.perf_counter()
        cpu = build_store(fleet, device="cpu")
        t2 = time.perf_counter()
        blob = card.to_bytes()
        assert blob == cpu.to_bytes(), f"{task}: card and CPU RFT1 differ"
        for where in (dev, "cpu"):
            back = ForestStore.from_bytes(blob, device=where)
            assert back.to_bytes() == blob, f"{task}: RFT1 round trip"
        rep = card.size_report()
        rows[task] = {
            "fleet_store": task, "users": rep["n_users"],
            "trees": sum(card.n_trees(u) for u in card.user_ids),
            "rft1_bytes": len(blob),
            "store_total_bytes": rep["total_bytes"],
            "bench_store_json_total_bytes": BENCH_STORE_BYTES[task],
            "card_build_s": t1 - t0, "cpu_build_s": t2 - t1,
        }
        log(json.dumps(rows[task]))
        stores[task] = card
    return stores, rows


def fleet_session(store, dev, shards):
    from repro_torch.serving import ForestServer

    devices = None if shards is None else [dev] * shards
    return ForestServer(store, device=dev, devices=devices)


def check_fleet(task, requests, preds, want, what):
    assert len(preds) == len(want) == len(requests), what
    for (u, _), got, ref in zip(requests, preds, want):
        check_pred(task, got, ref, f"{what}: user {u}")


def phase_fleet_serving(dev, bench_stores):
    """The fleet's main path (module docstring, phase 10b-c): every engine
    serves 65,536 ragged rows of 256 requests, held against
    ``predict_compressed`` on the CPU; ``serve_safe`` quarantines one
    corrupted user.  Launch counts are set to 0 before and read after.
    Returns {task: (store, requests, want)}, the launch counts, the build
    rows and the S = 4 session's K5 inputs per task."""
    from repro_torch.kernels.tree_predict import tree_predict as tp
    from repro_torch.runtime.chaos import poison_user
    from repro_torch.serving import ForestServer
    from repro_torch.store import (
        ForestStore,
        build_store,
        make_request_batch,
        make_synthetic_fleet,
    )

    build_rows = {}
    fleets = {}
    for task, n_users in FLEET_SERVE_USERS.items():
        if n_users == FLEET_BENCH_USERS:
            fleets[task] = bench_stores[task]
            continue
        fleet = make_synthetic_fleet(n_users, task, seed=0)
        t0 = time.perf_counter()
        fleets[task] = build_store(fleet, device=dev)
        build_rows[task] = {"users": n_users,
                            "build_s": time.perf_counter() - t0}
        del fleet
    out = {}
    tp.reset_launches()
    for task, store in fleets.items():
        requests = make_request_batch(store, FLEET_REQUESTS, FLEET_ROWS, seed=1)
        oracle = ForestStore.from_bytes(store.to_bytes(), device="cpu")
        want = [oracle.predict(u, x) for u, x in requests]
        row = {"fleet_serving": task, "users": len(store.user_ids),
               "trees": sum(store.n_trees(u) for u in store.user_ids),
               "requests": len(requests),
               "rows": sum(len(x) for _, x in requests),
               "distinct_users": len({u for u, _ in requests})}
        default = fleet_session(store, dev, None)
        plan = default.plan(requests)
        assert plan.engine.name == "pipelined", plan.engine
        for label, shards, engine in FLEET_ENGINES:
            server = default if shards is None else fleet_session(
                store, dev, shards)
            before = dict(tp.LAUNCHES)
            preds = server.serve(requests, engine=engine)
            check_fleet(task, requests, preds, want, f"{task} {label}")
            if label == "sharded_s4":
                k1 = tp.LAUNCHES["seg_packed"] - before["seg_packed"]
                k5 = tp.LAUNCHES["seg_sharded"] - before["seg_sharded"]
                assert (k1, k5) == (4, 1), (k1, k5)
                auto = server.plan(requests)
                row["cost_model_4_devices"] = [auto.engine.name,
                                               auto.engine.reason]
        row["engines_match_predict_compressed"] = [e for e, *_ in FLEET_ENGINES]
        # serve_safe: one corrupted delta is quarantined, the rest unchanged
        safe = ForestStore.from_bytes(store.to_bytes(), device=dev)
        bad = requests[0][0]
        poison_user(safe, bad)
        statuses = ForestServer(safe, device=dev).serve_safe(requests)
        for (u, _), st, ref in zip(requests, statuses, want):
            if u == bad:
                assert st.status == "quarantined" and st.prediction is None
            else:
                assert st.status == "ok" and not st.degraded, (u, st.status)
                check_pred(task, st.prediction, ref, f"{task} serve_safe {u}")
        row["serve_safe_quarantined"] = bad
        log(json.dumps(row))
        out[task] = (store, requests, want)
    launches = dict(tp.LAUNCHES)
    log(f"fleet-path launches: {json.dumps(launches)}")
    for name in (K1["name"], K2["name"], K5["name"]):
        assert launches[name] > 0, f"kernel {name} was not launched on the fleet path"
    return out, launches, build_rows


def fleet_kernel_args(server, requests, engine):
    """The inputs one batch of ``requests`` gives ``engine``: K1's
    (``pipelined``) or K5's (``sharded``, one list per argument)."""
    from repro_torch.kernels.tree_predict import tree_predict as tp
    from repro_torch.serving.pack import concat_rows

    dev = server.device
    store = server.store
    c = store.shared.n_classes if store.shared.task == "classification" else 0
    plan = server.plan(requests, engine=engine)
    pack = server._gathered_pack(plan)
    xb = concat_rows([x for _, x in requests])[plan.order]

    def T(a, where=dev):
        return tp._on(a, torch.int32, where)

    if plan.engine.name == "pipelined":
        return plan, (T(xb), T(plan.oseg_s), pack.code, pack.fit,
                      T(pack.tree_seg), T(pack.chunk_lo), T(pack.chunk_hi),
                      pack.max_depth, store.arena.tb2, c,
                      plan.engine.block_trees, pack.block_obs)
    devs = pack.devices
    return plan, ([T(xb, d) for d in devs], [T(plan.oseg_s, d) for d in devs],
                  list(pack.code), list(pack.fit),
                  [T(a, d) for a, d in zip(pack.tree_seg, devs)],
                  [T(a, d) for a, d in zip(pack.chunk_lo, devs)],
                  [T(a, d) for a, d in zip(pack.chunk_hi, devs)],
                  pack.max_depth, store.arena.tb2, c,
                  plan.engine.block_trees, pack.block_obs)


def fleet_batch_times(dev, store, requests, label, shards, engine):
    """Cold (a store freshly loaded from its bytes: decode, fuse, upload,
    then serve) and warm (median of REPS after warm-up) host ms of one
    batch, with the warm batch's stages."""
    from repro_torch.serving import engines
    from repro_torch.serving.pack import concat_rows
    from repro_torch.store import ForestStore

    cold_store = ForestStore.from_bytes(store.to_bytes(), device=dev)
    server = fleet_session(cold_store, dev, shards)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    server.serve(requests, engine=engine)
    cold_ms = (time.perf_counter() - t0) * 1e3
    server.serve(requests, engine=engine)
    xs = [x for _, x in requests]
    stages = {k: [] for k in ("plan", "pack", "run", "finalize", "total")}
    for _ in range(REPS):
        t0 = time.perf_counter()
        server.serve(requests, engine=engine)
        t1 = time.perf_counter()
        plan = server.plan(requests, engine=engine)
        t2 = time.perf_counter()
        xb = concat_rows(xs)
        if engine == "simple":
            pack = None
            t3 = time.perf_counter()
            total = engines.run_simple(cold_store, plan, xb)
        else:
            pack = server._gathered_pack(plan)
            t3 = time.perf_counter()
            run = (engines.run_pipelined if engine == "pipelined"
                   else engines.run_sharded)
            total = run(cold_store, plan, pack, xb)
        t4 = time.perf_counter()
        server._finalize(plan, total)
        t5 = time.perf_counter()
        for k, dt in zip(stages, (t2 - t1, t3 - t2, t4 - t3, t5 - t4,
                                  t1 - t0)):
            stages[k].append(dt * 1e3)
    med = {k: float(np.median(v)) for k, v in stages.items()}
    rows = sum(len(x) for x in xs)
    return {
        "engine": label, "cold_ms": cold_ms,
        "cold_rows_per_s": rows / cold_ms * 1e3,
        "warm_ms": med["total"], "warm_rows_per_s": rows / med["total"] * 1e3,
        "stage_ms": {k: med[k] for k in ("plan", "pack", "run", "finalize")},
    }


def fleet_entry(served, launches, build_rows, fleet_rows):
    """K5's entry of the ``{"kernels": [...]}`` line and the ``{"fleet":
    ...}`` line: K5 against its plain version at the S = 1 and S = 4
    sessions' inputs (both tasks), timed beside K1 at the same batch;
    then every engine's cold and warm batch."""
    from repro_torch.kernels.tree_predict import tree_predict as tp

    errs, per_task, fleet = [], {}, {"build": {**build_rows}, "store": fleet_rows}
    for task, (store, requests, _want) in served.items():
        dev = store.device
        plan1, k1_args = fleet_kernel_args(fleet_session(store, dev, None),
                                           requests, "pipelined")
        k1 = seg_timed(K1["name"], tp._launch_seg_packed,
                       tp._seg_packed_plain, k1_parts, k1_args, reps=3)
        k1_ms, bms, by, work = (k1[k] for k in ("ms", "bound_ms",
                                                "bound_by", "work"))
        times = {}
        for shards in (1, 4):
            _plan, args = fleet_kernel_args(
                fleet_session(store, dev, shards), requests, "sharded")
            got = tp._launch_seg_sharded(*args)
            torch.cuda.synchronize()
            errs.append(max_abs_err(got, tp._seg_sharded_plain(*args)))
            times[shards] = {
                "ms": time_ms(lambda: tp._launch_seg_sharded(*args)),
                "plain_ms": time_ms(lambda: tp._seg_sharded_plain(*args),
                                    reps=3),
            }
        per_task[task] = {
            "shape": {"rows": plan1.n_rows, "trees": int(plan1.seg_trees.sum()),
                      "users": plan1.n_users, "t_pad": plan1.t_pad},
            "ms_s1": times[1]["ms"], "ms_s4": times[4]["ms"],
            "plain_ms_s1": times[1]["plain_ms"],
            "plain_ms_s4": times[4]["plain_ms"],
            "k1_ms": k1_ms, "bound_ms": bms, "bound_by": by, "work": work,
        }
        engines_rows = [fleet_batch_times(dev, store, requests, label, shards,
                                          engine)
                        for label, shards, engine in FLEET_ENGINES]
        pipelined = engines_rows[0]
        fleet[task] = {"engines": engines_rows, "k1_ms": k1_ms, "k1": k1,
                       "k1_share_of_warm_batch": k1_ms / pipelined["warm_ms"],
                       "k5_ms_s1": times[1]["ms"], "k5_ms_s4": times[4]["ms"]}
    main = per_task["classification"]
    entry = dict(K5)
    entry.update({
        "launches": launches[K5["name"]],
        "k1_launches_per_s4_batch": 4,
        "max_abs_err": max(errs),
        "ms": main["ms_s4"], "plain_ms": main["plain_ms_s4"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "library_ms": None,
        "library_note": "no single PyTorch call computes a tree traversal",
        "route_note": "no kernel of its own: K1 (tp_seg_packed) per tree "
                      "shard on each device, then an ordered sum",
        "timed_at": "one 65,536-row fleet batch at S = 4 shards on one card, "
                    "classification (1,000 users); bound: K1's for the same "
                    "rows and trees",
        "main_path": per_task,
    })
    return entry, fleet


def main() -> None:
    dev = phase_environment()
    phase_build()

    table = kernel_table()
    errs = {kern["name"]: [] for kern, *_ in table}
    clock = {"start": time.perf_counter()}
    large, large_reg = phase_parity(dev, errs)
    clock["parity"] = time.perf_counter()
    servers, serve_launches = phase_main_path(dev)
    clock["serving"] = time.perf_counter()
    models, train_launches, train_blobs = phase_training(dev)
    clock["training"] = time.perf_counter()
    phase_train_again(dev, models["regression"][0], train_blobs["regression"])
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
        task_args = {task: a[name] for task, a in args.items()}
        out.append(kernel_entry(
            kern, launch, plain, parts, launches, task_args, errs[name],
            timed_at, large[name],
        ))
        if name in FOREST:
            out[-1]["forest"] = forest_report(name, task_args, large[name])
        else:
            out[-1]["seg"] = seg_report(name, launch, plain, parts, task_args,
                                        large[name], large_reg[name])

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

    flash_errs = []
    phase_flash_parity(dev, flash_errs)
    cfg, params, tokens, lm_launches, lm_row = phase_lm(dev)
    lm_row["checks"] = phase_lm_checks(dev, cfg, params, tokens)
    entry = flash_entry(lm_launches, lm_flash_args(cfg, params, tokens),
                        flash_errs, lm_row["prefill_s"])
    out.append(entry)
    lm_row["k7_ms"] = entry["ms"]
    lm_row["k7_share_of_prefill"] = entry["share_of_prefill"]
    log(json.dumps({k: v for k, v in lm_row.items() if k != "checks"}))
    del params
    torch.cuda.empty_cache()
    clock["lm"] = time.perf_counter()

    wkv_errs = []
    phase_wkv_parity(dev, wkv_errs)
    quant_errs = phase_quant_parity(dev)
    rcfg, rparams, rtokens, wkv_launches, rwkv_row = phase_rwkv(dev)
    rwkv_row["checks"] = phase_rwkv_checks(dev, rcfg, rparams, rtokens)
    quant_row, quant_launches, largest, mlp = phase_quant_model(rparams)
    log(json.dumps(quant_row))
    k8 = wkv6_entry(wkv_launches, rwkv_wkv_args(rcfg, rparams, rtokens),
                    wkv_errs, rwkv_row["prefill_s"])
    k6 = quant_entry(quant_launches, largest, mlp, quant_errs)
    out += [k8, k6]
    rwkv_row["k8_ms"] = k8["ms"]
    rwkv_row["k8_share_of_prefill"] = k8["share_of_prefill"]
    log(json.dumps({k: v for k, v in rwkv_row.items() if k != "checks"}))
    del rparams, largest, mlp
    torch.cuda.empty_cache()
    clock["rwkv6"] = time.perf_counter()

    bench_stores, fleet_rows = phase_fleet_store(dev)
    served, fleet_launches, build_rows = phase_fleet_serving(dev, bench_stores)
    k5, fleet = fleet_entry(served, fleet_launches, build_rows, fleet_rows)
    for entry in out:
        if entry["name"] in (K1["name"], K2["name"]):
            entry["fleet_launches"] = fleet_launches[entry["name"]]
        if entry["name"] == K1["name"]:
            entry["fleet"] = {task: fleet[task]["k1"] for task in served}
    out.append(k5)
    log(json.dumps({"fleet": fleet}))
    clock["fleet"] = time.perf_counter()
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
    if len(sys.argv) > 1 and sys.argv[1] in ("--forest-times",
                                             "--forest-profile"):
        forest_times_main(sys.argv[1] == "--forest-profile")
    elif len(sys.argv) > 1 and sys.argv[1] in ("--seg-times",
                                               "--seg-profile"):
        seg_times_main(sys.argv[1] == "--seg-profile")
    else:
        main()
