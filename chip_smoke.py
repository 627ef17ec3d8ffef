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
   again on the card from its seed has equal heap arrays (the
   regression histograms add in a fixed order; equal heaps compress to
   equal bytes, which phase 5 shows card against CPU, so the second
   compression, ~46 s, is cut to keep the script near 900 s);
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
   (n_rep 2 and 4; n_rep 5 with a window of 2,048 at S = 4,096 and n_rep
   3 at S = 2,048, phase 13's launches; n_rep 6 at 72 / 12 heads, phase
   15's padded Hymba); then
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
   re-serializes to them on both; (b) a 500-user classification fleet
   (~6,000 trees; cut from 1,000 users to pay for phase 15 (f)) and the 100-user
   regression fleet, each served 256
   ragged requests of 256 rows through ``ForestServer(store,
   device="cuda").serve`` with ``pipelined`` (K1), ``simple`` (K2) and
   ``sharded`` (K5) over ``devices=["cuda:0"]`` and ``["cuda:0"] * 4``,
   every request held against ``predict_compressed`` on the CPU, and
   ``serve_safe`` with one user's delta corrupted (that user
   quarantined, the others unchanged); (c) K1, K2 and K5 launch counts
   read around (b), positive, with no K1 launch and one K5 launch per S =
   4 batch on the card; (d) K5 against its plain version bit for bit at
   the S = 1, 2 and 4 sessions' inputs (both tasks; its configuration
   against the twin's) and at shards cut to unequal tree counts before
   they are padded, each S timed, and K1 at the
   S = 1 session's batch timed beside its plain version and bound, with
   its configuration (part of K1's ``{"kernels"}`` entry); (e) the
   builds' seconds, each engine's cold and warm batch with its stages,
   K1's share, and K5 at S = 1, 2 and 4, in one ``{"fleet": ...}`` line;
11. the store's life on disk and across codebook generations (its K1
   count set to 0 before and read after, positive): (a) durable: phase
   10's 500-user classification store written by
   ``DurableStore.create`` (slabs, XOR parity, the RFN1 manifest), opened
   lazily and eagerly with ``load_store(device="cuda")``, and the fleet
   batch served from the lazy store through ``pipelined``, equal to
   phase 10's CPU answer; (b) residency: budgets of 0.15 and 0.6 of the
   fleet's delta bytes with a background ``Prefetcher`` (no prefetch
   error, at least one request served from a prefetch), 16 seeded
   batches (cut from 64) of 16 requests x 256 rows, each served by the
   lazy and the eager store on the card and equal to the CPU's answer
   from the store's RFT1 bytes, the budget held after every batch; (c)
   repair: bits flipped in one user's shard on disk, ``serve_safe`` with
   ``attach_auto_repair`` serves the batch exactly after one parity
   repair and a scrub finds nothing left, then a second fault in one
   slab is a typed ``UnrepairableError`` and its users are quarantined;
   (d) lifecycle: ``make_drifted_fleet(1000, late_fraction=0.3)``, the
   700 initial users built on the card and the 300 late users onboarded (``drift_report`` recommends a recluster), a
   warm session, equal to the CPU's answer from the pre-recluster RFT1
   bytes, crosses ``recluster(mode="extend")`` with an RFJ1 journal on
   disk (verified, every user bit-exact, no fallback users after, the
   CPU's answer again, arena runs lost only by re-encoded users), and
   ``mode="full"`` runs on 300 users (cut from 1,000) of a store opened
   from the pre-recluster RFT1 bytes, serving the CPU's answer; a
   100-user drifted fleet (``benchmarks/recluster_bench.py``'s
   size) is crashed at every journal step and resumed from its journal's
   bytes to the uncrashed run's RFT1 bytes (in spawned worker processes,
   beside the rest); (e) streaming: ``build_store_streaming`` of phase
   10's fleet in waves of 256 with extend, loaded bit-exact on the card
   and serving phase 10's CPU answer; all in one
   ``{"store_lifecycle": ...}`` line with the card's name and power
   limit;
12. online serving through ``repro_torch.sched`` (its K1 count set to 0
   before and read after, positive), over phase 10's 500-user
   classification store, every answer held to the CPU's from the store's
   RFT1 bytes: (a) throughput: ``benchmarks/sched_bench.py``'s trace (a
   seeded Poisson trace, 4 s at 150 requests/s, bursts of 2x, Zipf skew
   1.1, rows 64 / 128 / 256; the generator copied here), its
   micro-batches of up to 2,048 rows recorded under ``VirtualClock``,
   then timed through ``Scheduler`` (``WallClock``, overlap on,
   ``safe=False``) and through direct ``serve``, warm and with the plan
   cache cleared, 5 interleaved repeats, the minimum of each; every
   ticket equal to direct ``serve``; (b) latency: the trace at rows 16 /
   32 / 64 replayed open-loop on the wall clock (``max_rows`` 512, SLO
   0.25 s, ``serve_safe``), two passes, the second reported: p50, p99,
   SLO attainment at 1x and 2x, triggers, plan hit rate; (c) the online
   stack over the durable tier: the fleet written by
   ``DurableStore.create``, bits flipped in one user's shard, opened
   lazily at a residency budget of 0.15 of its delta bytes with a
   background ``Prefetcher``, served by a ``Scheduler`` with a
   ``LifecycleDriver`` whose ``Scrubber`` repairs the shard in the idle
   gap before the first arrival, then (b)'s trace paced: one repair, no
   prefetch error, the budget held, every arena call made on the
   ``sched-executor`` thread, cold loads counted by thread and in
   ``plan`` (ROADMAP R7); (d) the self-driving lifecycle:
   ``make_drifted_fleet(100, late_fraction=0.3)`` built on the card and
   on the CPU, each served 200 requests of 8 rows every 0.05 virtual s
   while a ``LifecycleDriver`` (RFJ1 journal on disk) reclusters and
   migrates 20 users/s, 2 a tick: a recluster, requests served
   mid-migration, the journal committed, no fallback user after, every
   card ticket equal to per-user ``predict_compressed`` on the CPU, and
   the card's RFT1 and RFJ1 bytes equal to the CPU's; (e) batch
   isolation: ``BatchFaults`` fails one micro-batch of a ``WallClock``
   run, exactly its tickets ``failed``, every other one exact.  In
   parts (a)-(d) every ticket is ``ok`` and not degraded, no batch
   fails, overlapped runs pre-plan, and ``pipelined`` serves every
   batch; all in one ``{"online": ...}`` line with the card's name and
   power limit;
13. the LM substrate's other families, bf16, random weights from seed 0:
   hymba-1.5b uncut (32 layers, d_model 1,600, 25 / 5 heads of 64, a
   window of 2,048, the SSM branch at d_inner 3,200, state 16) over 2 x
   4,096 prompts with ``max_len`` 4,128 and 32 decode steps (the ring
   buffer wraps); granite-moe-3b-a800m uncut (32 layers, d_model 1,536,
   24 / 8 heads, 40 experts, top 8) over 4 x 2,048 (capacity 2,048 of
   8,192 tokens: drops happen) and 32 steps; deepseek-v3-671b at full
   width (d_model 7,168, 128 heads, MLA ranks 1,536 / 512, 256 experts
   of 2,048 and one shared, the MTP head built) cut to one dense and one
   MoE layer, over 1 x 4,096 (MLA's chunked prefill) and 16 steps
   of its absorbed decode.  Each through ``make_prefill_step(cfg,
   use_flash=True)``: a warm-up prefill and the timed one, K7's count set
   to 0 before and read after each (32 launches for Hymba and Granite,
   none for MLA), none added by decode; a prefill profiled by
   ``torch.profiler`` with the selective scan, ``moe_apply``, the expert
   products and MLA's attention labelled (their device-time shares); K7
   at Hymba's and Granite's layer-0 launch against its plain version,
   timed beside its bound and ``scaled_dot_product_attention``; then the
   checks, MoE dropless: K7's prefill against the plain one (Hymba,
   Granite) and decode after prefill(S) against ``forward`` on S + 1
   tokens, in float32 at 1e-4 relative L2 and in bf16 within 1.5x bf16's
   floor; DeepSeek-V3's on a copy with 32 routed experts and a 1 x 2,047
   prompt, plus layer 0's chunked MLA against the dense formula at S =
   4,096 in float32 (1e-4); one ``{"families": ...}`` line with the
   card's name and power limit;
14. LM training (plain PyTorch autograd, no kernel: K7's and K8's counts
   set to 0 before and read after, both 0): (a) qwen3-4b at full width
   and depth (36 layers, d_model 2,560, vocab 151,936, untied head,
   4.41 B parameters, bf16, seeded weights) through
   ``make_train_step(cfg, AdamWConfig(lr=3e-4, warmup_steps=2,
   total_steps=10), remat="full")`` on ``synth_batch`` of 2 x 2,048
   tokens (chunked cross entropy): a warm-up step and 8 timed ones
   (host clock, median / min / max; forward / backward / optimizer by
   CUDA events, each part's peak memory), tokens/s, mfu, every loss and
   gradient norm finite, the last three losses' mean below the first;
   1 more step with deterministic algorithms off (its cost) and one
   under ``torch.profiler``; (b) card against CPU in float32 (TF32 off)
   with 8-bit gradient compression: every family's smoke config for 2
   steps (loss and every gradient leaf at 1e-4 relative L2, the update
   on the CPU's gradients bit for bit equal on both devices) and
   qwen3-4b at full width cut to 2 layers over 1 x 256 tokens for 3
   steps (loss and gradients); (c) ``TrainLoop`` with a lossless
   ``CheckpointManager`` over qwen3-4b's and granite-moe-3b-a800m's
   smoke configs, 12 steps, a checkpoint every 4, preempted at step 5:
   the final state bit-equal to an uninterrupted run's, and a
   final checkpoint (the reference's layout) decoded exactly; (d)
   ``compress_tensors`` lossless on (a)'s layer 0 (bf16, ~101 M values),
   its float32 first moments and the embedding: exact decode, bytes
   against raw, host seconds; (e) ``python -m repro_torch.launch.train
   --arch qwen3-4b --smoke --steps 20 --ckpt-codec lossless`` in the
   background; one ``{"train": ...}`` line with the card's name and
   power limit;
15. the mesh (``repro_torch.models.sharding``, ``launch/mesh.py``,
   ``shardings.py``): 4 ranks spawned on the one card (the kernels built
   before, in this process) talk through gloo carrying CUDA tensors (NCCL
   refuses two ranks on one card; the backend is chosen and printed, and
   each collective's transport printed: direct, or an int16 sum carried
   as int32). (a) granite-moe-3b-a800m uncut, bf16, seed 0, tensor-parallel
   (each rank its shards, ``shard_params``), phase 13's 4 x 2,048 prompts
   prefilled through K7 at each rank's heads and its MoE layers through
   the expert-parallel ``_moe_ep_partial`` on meshes (1, 4) and (2, 2),
   then with the whole model on every rank on (1, 4) (whole activations,
   its MoE layers through ``moe_apply``'s expert-parallel dispatch; a
   warm-up prefill each, and a timed one on (1, 4) tensor-parallel):
   K7's count per prefill equals the 32 layers on every rank; every
   layer's dropped (token, slot) set, over the ranks, equals a
   one-process replay of the per-shard routing (the dense ``_route`` on
   each data shard's tokens); both (1, 4) runs' logits against a
   single-process dense prefill within 1.5x bf16's floor (the dense bf16
   prefill's distance from a float32 one).
   (b) hymba-1.5b at full width cut to 2 layers under (1, 4): its 25 / 5
   heads padded to 36 / 6, K7 launched at 72 query heads over 12 KV
   heads; the logits within K7's bf16 tolerance of the unpadded
   single-process prefill. (c) ``make_wire_train_step`` on (4, 1),
   qwen3-4b at full width cut to 2 layers, 4-bit codes, 1 x 1,024 tokens
   a rank, 2 steps: the replicated leaves bit-equal across ranks, the
   losses within 2 float32 ulps of a one-process replay with the same
   Generator draws and every final shard bit-equal to it; the wire bytes
   a step (int8 codes against bf16 gradients). (d) qwen3-4b's smoke
   state saved, then ``load_checkpoint(shardings=...)`` onto (4, 1):
   every local shard bit-equal to its slice of the saved leaf. (e)
   tensor-parallel qwen3-4b: first, in this process, the whole model's
   bf16 prefill and greedy decode and the same weights' float32 runs;
   then on the ranks its shards cut leaf by leaf (stored bytes equal to
   the sum of ``shard_shape`` bytes, the init's peak below the whole
   model), at full width and depth on (1, 4) (a 4 x 2,048 prefill
   through K7 at 32 / 8 heads a rank, 2 decode steps fed the whole
   run's tokens), cut to 4 layers on (2, 2) and float32 cut to 2 layers
   on (1, 4): the gathered logits within 1.5x bf16's floor (1e-4 in
   float32); K7 at that launch against its plain version, timed beside
   its bound and SDPA. (e)'s timed prefill and decode run under
   ``collective_timing``: each collective's calls, bytes, barrier and own
   seconds per kind. (f) tensor-parallel training of qwen3-4b at full
   width (plain attention: K7's and K8's counts set to 0 before and read
   0 after): float32 cut to 2 layers on (1, 4), 2 x 256 tokens, 2 steps,
   TF32 off, against one process's steps of the same weights (losses and
   grad norms within 1e-5 relative, every gradient shard within 1e-4
   relative L2 of the one-process gradients' slice, the first step's
   updated parameter, m and v shards within 1e-5 of that step's update
   of the same slices, the parameters but for the elements whose Adam
   denominator lies within 300 eps of zero on both sides, which must
   outnumber the elements off and are counted by leaf, the head's split
   by label columns; the replicated leaves bit-equal across ranks); the
   same float32 model's first step on (2, 2) with 4-bit gradient
   compression (each leaf's global lo / hi by one ``pmax``, the error
   feedback cut like the gradients) beside the uncompressed step, each
   side's first step its warm-up with its peak a rank, held to the
   one-process compressed step by the code-flip rule of
   ``tests/test_torch_mesh_train.py`` (its grad norm and lo / hi held
   first, the allowance from those scalars, a control that must fail
   it; its error feedback against the one process's, sliced), then two
   timed steps a side, plain, compressed, compressed, plain; bf16
   cut to 4 layers, AdamW, remat "full", 2 x 2,048 tokens (the chunked
   vocab-parallel cross entropy) on (1, 4) and on (2, 2) (ZeRO-3): a
   warm-up step and 3 timed ones under ``collective_timing`` (the
   backward's collectives timed too), step s, tokens/s, forward /
   backward / optimizer ms, the collectives' share per kind, the stored
   bytes of parameters, m and v a rank equal to the sum of
   ``shard_shape`` bytes, each rank's peak; every loss finite and equal
   on every rank, the first step's loss and grad norm within 1.5x bf16's
   floor of one process's bf16 step; the smoke config's train state of
   shards on (2, 2) through ``TrainLoop``, a checkpoint every 2 steps,
   preempted at step 3 and resumed: the final shards bit-equal to an
   uninterrupted run's, the last checkpoint's leaves equal to them
   gathered whole. (g) tensor-parallel serving of rwkv6-1.6b and
   hymba-1.5b as (e) serves qwen3-4b (``MESH_RECURRENT``), K8 and K7 at
   a rank's heads. (h) tensor-parallel serving of deepseek-v3-671b at
   full width cut to 1 dense and 1 MoE layer (``MESH_DSV3``): each
   rank's 32 of 128 MLA heads, its 64 of 256 routed experts and its
   columns of the shared expert and the dense MLP, the latents gathered
   along the sequence, the latent cache cut along time (1 x 4,096, the
   chunked MLA route; decode's positions on rank 3's slice), the ranks
   cutting their shards from the seeded leaves one rank at a time (a
   rank holds one whole MoE block while it cuts it); the stored bytes
   a rank equal to the ``shard_shape`` sum; logits within 1.5x the bf16
   floor, read on the 32-expert copy one process holds in float32
   beside bf16; a float32 32-expert run within 1e-4 and a dropless
   32-expert run on (2, 2); no K7 or K8 launch.  One ``{"mesh": ...}``
   line: each rank's peak memory, (e)'s, (g)'s and (h)'s bytes, prefill
   s and decode ms a step with the collectives' shares, (f) under
   ``train_tp`` with the card's name and power limit, K7's launches per
   rank, the transports, the phase's seconds.

``python3 chip_smoke.py --forest-times`` runs only K3 and K4 at the two
Liberty shapes and the large one (the same command times a parent tree's
kernels); ``--forest-profile`` adds ``max_depth`` cut to 0, 2, ..., 12
and a ``torch.profiler`` split of each call by kernel.  ``--seg-times``
runs only K1, K2 and K5: K1 and K2 at the single-forest 1,024-row batch
of phase 4, K1 at phase 10's 65,536-row fleet batch, K5 there at S = 1,
2 and 4 (and on the 100-user regression fleet),
K1 and K2 at the large classification and regression shapes, each
held against its plain version (the same command times a parent tree's
kernels); ``--seg-profile`` adds ``max_depth`` cut to 0, 2, ..., 8 at the
single-forest batch, with each call's device time from ``torch.profiler``.
``--lifecycle`` runs phase 11 alone, over phase 10's 500-user fleet
built for it; ``--online`` runs phase 12 alone, likewise; ``--families``
runs K7's parity cases and phase 13 alone; ``--train`` runs phase 14
alone; ``--mesh`` runs K7's parity cases and phase 15 alone;
``--mesh-mla`` runs phase 15 (h) alone; ``--mesh-train-families`` runs
phase 15 (i) alone.

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

import contextlib
import json
import os
import re
import subprocess
import sys
import time
import types

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
    # phase 13's launches: hymba-1.5b (2 x 25 query heads over 5 KV heads,
    # a window of 2,048 cutting half the keys of late rows) and
    # granite-moe-3b-a800m (4 x 24 over 8)
    ("bf16-hymba-nrep5-window2048", 50, 4096, 4096, 64, torch.bfloat16,
     2048, 5),
    ("f32-hymba-nrep5-window2048", 50, 4096, 4096, 64, torch.float32, 2048,
     5),
    ("bf16-granite-nrep3", 96, 2048, 2048, 64, torch.bfloat16, None, 3),
    ("f32-granite-nrep3", 96, 2048, 2048, 64, torch.float32, None, 3),
    # phase 15's: hymba-1.5b's heads padded for a 4-way model axis, 2 x 36
    # query heads over 6 KV heads
    ("bf16-hymba-pad-nrep6-window2048", 72, 4096, 4096, 64, torch.bfloat16,
     2048, 6),
    ("f32-hymba-pad-nrep6-window2048", 72, 4096, 4096, 64, torch.float32,
     2048, 6),
]

# Fleet serving (phase 10): the subscriber scenario — one ForestStore per
# task (one shared codebook, one delta per user) serving ragged mixed-user
# batches.  benchmarks/store_bench.py's 100-user fleets (depth 6, 8
# features) for the RFT1 round trip; for serving, a 500-user
# classification fleet (~6,000 trees, inside the arena's default
# 16,384-tree capacity) and the 100-user regression fleet, each sent 256
# requests of 256 rows (65,536 rows) of make_request_batch(seed=1).
FLEET_BENCH_USERS = 100
# (classification cut from 1,000 users, whose build took 43-61 s, to pay
# for phase 15 (f))
FLEET_SERVE_USERS = {"classification": 500, "regression": 100}
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

def smi_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def phase_environment():
    from repro_torch.device import resolve_device

    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    log(smi_line())
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


# the card's and the CPU's compressed bytes are compared on the forest's
# first CPU_COMPRESS_TREES trees (the whole 50-tree regression forest took
# 50-58 s on the CPU, cut to pay for phase 15 (i))
CPU_COMPRESS_TREES = 5


def forest_head(forest, k: int):
    """The forest of ``forest``'s first ``k`` trees; a regression forest's
    fit table cut to the values they use, their fits renumbered."""
    import dataclasses

    trees = forest.trees[:k]
    if not len(forest.fit_values):
        return dataclasses.replace(forest, trees=trees)
    used = np.unique(np.concatenate([t.node_fit for t in trees]))
    return dataclasses.replace(
        forest, fit_values=forest.fit_values[used],
        trees=[dataclasses.replace(t, node_fit=np.searchsorted(
            used, t.node_fit)) for t in trees])


def compress_on_card_and_cpu(forest, dev, what):
    """``compress_forest`` of ``forest`` on the card, and of its first
    CPU_COMPRESS_TREES trees (``forest_head``) on the card and on the CPU,
    whose bytes must be equal (the CPU bytes equal the reference's)."""
    from repro_torch.core import compress_forest

    t0 = time.perf_counter()
    comp = compress_forest(forest, device=dev)
    t1 = time.perf_counter()
    head = forest_head(forest, CPU_COMPRESS_TREES)
    card = compress_forest(head, device=dev)
    t2 = time.perf_counter()
    cpu = compress_forest(head, device="cpu")
    t3 = time.perf_counter()
    blob, cpu_blob = card.to_bytes(), cpu.to_bytes()
    info = {"bytes": len(comp.to_bytes()), "card_compress_s": t1 - t0,
            "compared_trees": head.n_trees, "compared_bytes": len(blob),
            "card_compared_s": t2 - t1, "cpu_compress_s": t3 - t2}
    if blob != cpu_blob:
        info.update(cpu_bytes=len(cpu_blob),
                    **first_byte_difference(card, cpu))
        log(json.dumps({"byte_mismatch": what, **info}))
        raise AssertionError(f"{what}: card and CPU compressed bytes differ")
    return comp, info


def phase_training(dev):
    """The paper's pipeline on the card for each task (module docstring,
    phase 5).  Returns {task: (model, x)} and the K3 / K4 launch counts
    of this phase."""
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


def phase_train_again(dev, model):
    """One seed, one forest (module docstring, phase 6): the Liberty
    regression forest of phase 5 trained again on the card from its seed
    has equal heap arrays."""
    from repro_torch.forest import train_forest

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
    log(json.dumps({"train_again": "regression", "trees": TRAIN_TREES,
                    "heaps_equal": True, "train_s": train_s}))


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
    chunk), the 65,536-row batch of phase 10's 500-user fleet (K1; K5 at
    S = 1, 2 and 4) and of its 100-user regression fleet (K5 at S = 1, 2
    and 4), and the large parity shapes."""
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
    for task in ("classification", "regression"):
        store = build_store(make_synthetic_fleet(FLEET_SERVE_USERS[task],
                                                 task, seed=0), device=dev)
        requests = make_request_batch(store, FLEET_REQUESTS, FLEET_ROWS,
                                      seed=1)
        tag = "fleet" if task == "classification" else "fleet-reg"
        if task == "classification":
            shapes[tag] = {K1["name"]: fleet_kernel_args(
                fleet_session(store, dev, None), requests, "pipelined")[1]}
        for shards in (1, 2, 4):
            shapes[f"{tag}-s{shards}"] = {K5["name"]: fleet_kernel_args(
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
    K1 and K2 (K5's inputs are this tree's: one stack a device).
    ``--seg-profile`` adds ``seg_depth_profile``."""
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
            plain_args = k5_shard_args(args) if name == K5["name"] else args
            run = bound_launch(name, launch, args)
            max_abs_err(run(), plain(*plain_args))
            line = {"seg_times": name, "shape": where, **time_stats(run)}
            if hasattr(tp, "seg_config") and name in SEG:
                cfg = seg_config_checked(name, args)
                line["config"] = {k: cfg[k] for k in (
                    "mode", "decode", "rows", "cols", "grid", "resident",
                    "smem")}
            if name == K5["name"]:
                line["config"] = k5_config_checked(args)
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
    (n_rep 2 and 4; phase 13's n_rep 5 with a window of 2,048 and n_rep
    3; phase 15's n_rep 6) through ``_flash_attention_grouped``."""
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


def cpu_answers(blob, batches):
    """The independent answer to each batch of requests: the store read
    back from its RFT1 bytes ``blob`` on the CPU, where no kernel runs,
    and each request predicted there."""
    from repro_torch.store import ForestStore

    oracle = ForestStore.from_bytes(blob, device="cpu")
    return [[oracle.predict(u, x) for u, x in batch] for batch in batches]


def phase_fleet_serving(dev, bench_stores):
    """The fleet's main path (module docstring, phase 10b-c): every engine
    serves 65,536 ragged rows of 256 requests, held against
    ``predict_compressed`` on the CPU; ``serve_safe`` quarantines one
    corrupted user.  Launch counts are set to 0 before and read after.
    Returns {task: (store, requests, want)}, the launch counts, the build
    rows and {task: the forests} of the fleets built here."""
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
    forests = {}
    for task, n_users in FLEET_SERVE_USERS.items():
        if n_users == FLEET_BENCH_USERS:
            fleets[task] = bench_stores[task]
            continue
        forests[task] = make_synthetic_fleet(n_users, task, seed=0)
        t0 = time.perf_counter()
        fleets[task] = build_store(forests[task], device=dev)
        build_rows[task] = {"users": n_users,
                            "build_s": time.perf_counter() - t0}
    out, s4_batch = {}, None
    tp.reset_launches()
    for task, store in fleets.items():
        requests = make_request_batch(store, FLEET_REQUESTS, FLEET_ROWS, seed=1)
        want, = cpu_answers(store.to_bytes(), [requests])
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
                # one card: K5 launches once for its four shards, no K1
                k1 = tp.LAUNCHES["seg_packed"] - before["seg_packed"]
                k5 = tp.LAUNCHES["seg_sharded"] - before["seg_sharded"]
                assert (k1, k5) == (0, 1), (k1, k5)
                s4_batch = {"k1": k1, "k5": k5}
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
    launches["s4_batch"] = s4_batch
    return out, launches, build_rows, forests


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
    groups = {d: [i for i, e in enumerate(devs) if e == d]
              for d in dict.fromkeys(devs)}
    return plan, ([T(xb, d) for d in groups], [T(plan.oseg_s, d)
                                               for d in groups],
                  [pack.code[d] for d in groups],
                  [pack.fit[d] for d in groups],
                  *([T(a[idx], d) for d, idx in groups.items()]
                    for a in (pack.tree_seg, pack.chunk_lo, pack.chunk_hi)),
                  pack.max_depth, store.arena.tb2, c,
                  plan.engine.block_trees, pack.block_obs,
                  list(groups.values()))


def k5_shard_args(args):
    """K5's launch inputs (one entry a device, its shards stacked, then
    each device's shard indices) as its plain version takes them: one
    tensor a shard, in shard order, rows replicated."""
    *tensors, depth, tb2, c, bt, bo, shards = args
    per_shard = {}
    for j, idx in enumerate(shards):
        for r, i in enumerate(idx):
            per_shard[i] = [a[j] if k < 2 else a[j][r]
                            for k, a in enumerate(tensors)]
    cols = zip(*(per_shard[i] for i in sorted(per_shard)))
    return (*map(list, cols), depth, tb2, c, bt, bo)


def k5_uneven(args):
    """(K5's launch inputs, its plain version's) with each shard cut back
    to its last chunk holding a real tree (at least one chunk): the
    shards then differ in ``T_pad``, as the plain version takes them, and
    the launch gets each device's shards padded to one (``_stacked``, as
    the sharded entry pads them).  Chunk ranges never reach past a
    shard's last real chunk, so they stay as they are."""
    from repro_torch.kernels.tree_predict import tree_predict as tp

    xb, oseg, code, fit, tseg, lo, hi, *rest = k5_shard_args(args)
    bt = rest[3]
    keep = []
    for t in tseg:
        real = torch.nonzero(t >= 0)
        last = int(real[-1]) + 1 if len(real) else 1
        keep.append(-(-last // bt) * bt)
    code, fit, tseg = ([a[:k] for a, k in zip(tiles, keep)]
                       for tiles in (code, fit, tseg))
    shards = args[-1]
    stacked = ([tp._stacked([tiles[i] for i in idx], fill)
                for idx in shards]
               for tiles, fill in ((code, 0.0), (fit, 0.0), (tseg, -1)))
    return ((*args[:2], *stacked, *args[5:]),
            (xb, oseg, code, fit, tseg, lo, hi, *rest))


def k5_config_checked(args):
    """K5's configuration as the library reports it for these inputs (one
    card: every shard in one launch), held equal to its twin's."""
    from repro_torch.kernels.tree_predict import tree_predict as tp

    xb, _, code, _, _, _, _, depth, tb2, c, bt, bo, _ = args
    (k, t_pad, h), = {tuple(t.shape) for t in code}
    shape = (xb[0].shape[0], xb[0].shape[1], t_pad, h, depth, c, bt, bo,
             tb2)
    card = tp.seg_config(*shape, shards=k)
    twin = tp._seg_config(*shape, resident=card["resident"], shards=k)
    assert card == twin, (card, twin)
    return card


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


#: K5's shard counts at phase 10's fleet batch (one card)
K5_SHARDS = (1, 2, 4)


def fleet_entry(served, launches, build_rows, fleet_rows):
    """K5's entry of the ``{"kernels": [...]}`` line and the ``{"fleet":
    ...}`` line: K5 against its plain version bit for bit at the S = 1, 2
    and 4 sessions' inputs (both tasks) and at shards of unequal T_pad,
    its configuration against the twin's, each S timed beside K1 at the
    same batch; then every engine's cold and warm batch."""
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
        times, configs = {}, {}
        for shards in K5_SHARDS:
            _plan, args = fleet_kernel_args(
                fleet_session(store, dev, shards), requests, "sharded")
            cfg = k5_config_checked(args)
            configs[shards] = {k: cfg[k] for k in (
                "mode", "rows", "grid", "shards", "resident")}
            plain_args = k5_shard_args(args)
            for case, plain in ((args, plain_args), k5_uneven(args)):
                got = tp._launch_seg_sharded(*case)
                torch.cuda.synchronize()
                errs.append(max_abs_err(got, tp._seg_sharded_plain(*plain)))
            stats = time_stats(lambda: tp._launch_seg_sharded(*args))
            times[shards] = {
                "ms": stats["median"], "ms_min": stats["min"],
                "ms_max": stats["max"],
                "plain_ms": time_ms(
                    lambda: tp._seg_sharded_plain(*plain_args), reps=3),
            }
        per_task[task] = {
            "shape": {"rows": plan1.n_rows, "trees": int(plan1.seg_trees.sum()),
                      "users": plan1.n_users, "t_pad": plan1.t_pad},
            **{f"ms_s{k}": times[k]["ms"] for k in K5_SHARDS},
            **{f"plain_ms_s{k}": times[k]["plain_ms"] for k in K5_SHARDS},
            "times": times, "config": configs,
            "k1_ms": k1_ms, "bound_ms": bms, "bound_by": by, "work": work,
        }
        engines_rows = [fleet_batch_times(dev, store, requests, label, shards,
                                          engine)
                        for label, shards, engine in FLEET_ENGINES]
        pipelined = engines_rows[0]
        fleet[task] = {"engines": engines_rows, "k1_ms": k1_ms, "k1": k1,
                       "k1_share_of_warm_batch": k1_ms / pipelined["warm_ms"],
                       **{f"k5_ms_s{k}": times[k]["ms"] for k in K5_SHARDS}}
    main = per_task["classification"]
    entry = dict(K5)
    entry.update({
        "launches": launches[K5["name"]],
        "k1_launches_per_s4_batch": launches["s4_batch"]["k1"],
        "k5_launches_per_s4_batch": launches["s4_batch"]["k5"],
        "max_abs_err": max(errs),
        "ms": main["ms_s4"], "plain_ms": main["plain_ms_s4"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "library_ms": None,
        "library_note": "no single PyTorch call computes a tree traversal",
        "route_note": "one launch a device for all of its tree shards "
                      "(tp_seg_sharded: K1's kernel with the shard as a grid "
                      "dimension); regression partials folded in shard "
                      "order by a kernel after the walks, votes added by "
                      "every shard into one output",
        "timed_at": "one 65,536-row fleet batch at S = 4 shards on one card, "
                    f"classification ({FLEET_SERVE_USERS['classification']:,} "
                    "users); bound: K1's for the same "
                    "rows and trees",
        "main_path": per_task,
    })
    return entry, fleet


# ---------------------------------------------------------------------------
# phase 11: the fleet store's life on disk and across codebook generations
# ---------------------------------------------------------------------------

LIFE_BUDGETS = (0.15, 0.6)  # residency budgets, fractions of delta bytes
LIFE_BATCHES = 16  # residency batches per budget (64 before the cut)
LIFE_REQUESTS = 16  # requests per residency batch
LIFE_ROWS = 256  # rows per request
LIFE_USERS = 500  # the drifted fleet (make_drifted_fleet; 1,000 before
# the cut that pays for phase 15 (g))
LIFE_FULL_USERS = 300  # the full rebuild's fleet (1,000 before the cut)
LIFE_LATE = 0.3
LIFE_SEED = 7
LIFE_BATCH = (64, 256)  # the warm lifecycle batch: requests, rows
CRASH_USERS = 50  # benchmarks/recluster_bench.py's fleet, cut from 100
# to pay for phase 15 (h)
CRASH_SEED = 0
CRASH_WORKERS = 6
STREAM_WAVE = 256


def counted_invalidations(arena):
    """Count, on this arena only, the invalidations that drop a live run
    (a demotion's or a re-registration's)."""
    real = arena.invalidate
    counter = {"runs": 0}

    def invalidate(user_id):
        counter["runs"] += user_id in arena
        real(user_id)

    arena.invalidate = invalidate
    return counter


def flip_shard_bits(durable, user_id, seed, n=8):
    """Flip ``n`` seeded bits of one user's shard in its slab file."""
    from repro_torch.runtime.chaos import flip_bits

    entry = durable.shard_for_user(user_id)
    path, off, length = durable.shard_location(entry.shard_id)
    with open(path, "r+b") as f:
        f.seek(off)
        bad, _ = flip_bits(f.read(length), seed, n)
        f.seek(off)
        f.write(bad)
    return entry


def life_durable(dev, store, requests, want, root):
    """Write the fleet with ``DurableStore.create``, open it lazily and
    eagerly on the card, and serve the fleet batch from the lazy store;
    ``want`` is phase 10's CPU answer to it."""
    from repro_torch.serving import ForestServer
    from repro_torch.store import DurableStore

    path = os.path.join(root, "fleet")
    t0 = time.perf_counter()
    durable = DurableStore.create(path, store)
    t1 = time.perf_counter()
    lazy = DurableStore.open(path).load_store(device=dev)
    t2 = time.perf_counter()
    eager = DurableStore.open(path).load_store(lazy=False, device=dev)
    t3 = time.perf_counter()
    assert lazy._deltas.n_loaded() == 0
    server = ForestServer(lazy, device=dev)
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    got = server.serve(requests, engine="pipelined")
    t5 = time.perf_counter()
    task = store.shared.task
    check_fleet(task, requests, got, want,
                "lazy store against phase 10's CPU answer")
    check_fleet(task, requests, ForestServer(eager, device=dev).serve(
        requests, engine="pipelined"), want, "eager store")
    assert eager.to_bytes() == store.to_bytes()
    st = durable.stats()
    return path, durable, eager, {
        "users": st["n_users"],
        "trees": sum(store.n_trees(u) for u in store.user_ids),
        "create_ms": (t1 - t0) * 1e3, "open_lazy_ms": (t2 - t1) * 1e3,
        "open_eager_ms": (t3 - t2) * 1e3,
        "first_touch_ms": (t5 - t4) * 1e3,
        "first_touch_loaded_users": lazy._deltas.n_loaded(),
        "live_bytes": st["live_bytes"], "n_slabs": st["n_slabs"],
        "lazy_serve_equals_cpu": True,
    }


def residency_batches(dev, eager):
    """LIFE_BATCHES seeded batches of the eager store's users and their
    CPU answers, which the eager store serves on the card too."""
    from repro_torch.serving import ForestServer
    from repro_torch.store import make_request_batch

    batches = [make_request_batch(eager, LIFE_REQUESTS, LIFE_ROWS,
                                  seed=1000 + i)
               for i in range(LIFE_BATCHES)]
    wants = cpu_answers(eager.to_bytes(), batches)
    on_card = ForestServer(eager, device=dev)
    for i, (batch, want) in enumerate(zip(batches, wants)):
        check_fleet(eager.shared.task, batch,
                    on_card.serve(batch, engine="pipelined"), want,
                    f"eager store, residency batch {i}")
    return batches, wants


def life_residency(dev, path, frac, batches, wants):
    """Serve ``batches`` from a lazy store under a budget of ``frac`` of
    the fleet's delta bytes, with a background prefetcher warming the
    next batch's users while one is served (the first batch's warmed
    before the clock starts); every answer is held to its CPU answer in
    ``wants``, and the budget after every batch."""
    from repro_torch.serving import ForestServer
    from repro_torch.store import DurableStore, Prefetcher, attach_residency

    durable = DurableStore.open(path)
    delta_bytes = sum(e.length for e in durable.delta_entries())
    budget = int(frac * delta_bytes)
    store = durable.load_store(device=dev)
    invalidated = counted_invalidations(store.arena)
    mgr = attach_residency(store, durable, budget,
                           clock=time.perf_counter)
    server = ForestServer(store, device=dev)
    task = store.shared.task
    pf = Prefetcher(mgr, server=server, background=True)
    try:
        pf.request([u for u, _ in batches[0]])
        pf.drain()
        serve_s = 0.0
        for i, (batch, want) in enumerate(zip(batches, wants)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            # install what was staged for this batch before it is planned:
            # planning reads each user's delta, and one still staged
            # would be loaded cold again
            mgr.absorb_staged()
            if i + 1 < len(batches):
                pf.request([u for u, _ in batches[i + 1]])
            got = server.serve(batch, engine="pipelined")
            serve_s += time.perf_counter() - t0
            check_fleet(task, batch, got, want, f"residency {frac} batch {i}")
            assert mgr.accounted_bytes() <= budget, (frac, i)
    finally:
        pf.close()
    st = mgr.stats()
    assert st["prefetch_errors"] == 0, st["prefetch_errors"]
    assert st["prefetch_hits"] > 0, "no request was served from a prefetch"
    n_req = LIFE_BATCHES * LIFE_REQUESTS
    return {
        "budget_fraction": frac, "budget_bytes": budget,
        "delta_bytes": delta_bytes, "batches": LIFE_BATCHES,
        "requests_per_batch": LIFE_REQUESTS, "rows": LIFE_ROWS,
        "demotions": st["demotions"], "reloads": st["reloads"],
        "writebacks": st["writebacks"],
        "over_budget_events": st["over_budget_events"],
        "prefetch_staged": st["prefetch_staged"],
        "prefetch_hits": st["prefetch_hits"],
        "prefetch_errors": st["prefetch_errors"],
        "cold_load_ms_p50": st["cold_load_ms_p50"],
        "cold_load_ms_p99": st["cold_load_ms_p99"],
        "prefetch_load_ms_p50": st["prefetch_load_ms_p50"],
        "requests_per_s": n_req / serve_s,
        "rows_per_s": n_req * LIFE_ROWS / serve_s,
        "arena_runs_invalidated": invalidated["runs"],
        "arena": store.arena.stats(),
        "budget_held_after_every_batch": True,
        "answers_equal_cpu_and_eager": True,
    }


def life_repair(dev, path, requests, want, root):
    """One user's shard corrupted on disk: ``serve_safe`` with
    ``attach_auto_repair`` serves it exactly after one parity repair, and
    a scrub finds nothing left; a second fault in one slab is a typed
    ``UnrepairableError`` and its users are quarantined, not served."""
    import shutil

    from repro_torch.core.framing import IntegrityError, UnrepairableError
    from repro_torch.serving import ForestServer
    from repro_torch.store import DurableStore, Scrubber, attach_auto_repair

    rpath = os.path.join(root, "repair")
    shutil.copytree(path, rpath)
    durable = DurableStore.open(rpath)
    victim = requests[0][0]
    entry = flip_shard_bits(durable, victim, seed=11)
    try:
        durable.read_shard(entry.shard_id)
        raise AssertionError("a corrupt shard read back clean")
    except IntegrityError:
        pass
    server = ForestServer(durable.load_store(device=dev), device=dev)
    attach_auto_repair(server, durable)
    statuses = server.serve_safe(requests)
    assert [s.status for s in statuses] == ["ok"] * len(requests)
    task = server.store.shared.task
    check_fleet(task, requests, [s.prediction for s in statuses], want,
                "after repair")
    health = server.stats()["health"]
    assert health["repairs"] == 1 and health["n_quarantined"] == 0, health
    scrub = Scrubber(durable).scrub_all()
    assert scrub["repaired"] == scrub["unrepairable"] == 0, scrub
    assert scrub["parity_rebuilt"] == 0, scrub

    slab, _ = durable._locate(entry.shard_id)
    pair = [e.name for e in slab.shards if e.name and e.name != victim][:2]
    assert len(pair) == 2, "the victim's slab holds fewer than 3 users"
    for i, u in enumerate(pair):
        flip_shard_bits(durable, u, seed=12 + i)
    first = durable.shard_for_user(pair[0])
    try:
        durable.read_shard(first.shard_id, repair=True)
        raise AssertionError("a double fault was repaired")
    except UnrepairableError as exc:
        typed = type(exc).__name__
    server2 = ForestServer(DurableStore.open(rpath).load_store(device=dev),
                           device=dev)
    attach_auto_repair(server2, durable)
    x = requests[0][1]
    reqs2 = [(pair[0], x), (pair[1], x), (victim, x)]
    st2 = server2.serve_safe(reqs2)
    assert [s.status for s in st2[:2]] == ["quarantined"] * 2
    assert all(s.prediction is None for s in st2[:2])
    assert st2[2].status == "ok"
    check_pred(task, st2[2].prediction, want[0], "a healthy sibling")
    health2 = server2.stats()["health"]
    assert "UnrepairableError" in health2["last_repair_error"]
    return {
        "victim": victim, "repairs": health["repairs"],
        "repair_attempts": health["repair_attempts"],
        "served_exact_after_repair": True, "scrub_after": scrub,
        "double_fault": typed, "double_fault_users": pair,
        "quarantined": health2["n_quarantined"],
    }


def crash_points(pre: bytes, want: bytes, points: list, device: str,
                 submitted: float):
    """A worker's share of the crash sweep: for each step index, a
    recluster from ``pre`` crashed there (``CrashSchedule``), then resumed
    from the journal's bytes.  Returns the indices whose RFT1 bytes differ
    from the uncrashed run's, the worker's CPU seconds over its points,
    and its clock (``time.time()``) in seconds after ``submitted``: when
    it entered (the process spawned and the main module imported), when
    the store's modules were imported, when its CUDA context was up, and
    when it finished.  The runs skip ``verify``: their RFT1 bytes are held
    equal to the uncrashed run's, which was verified user by user."""
    entered = time.time()
    sys.path.insert(0, os.path.join(ROOT, "src"))
    torch.set_num_threads(1)
    from repro_torch.runtime.chaos import CrashSchedule, InjectedCrash
    from repro_torch.store import (
        ForestStore,
        MigrationJournal,
        recluster,
        resume_recluster,
    )

    imported = time.time()
    torch.empty(0, device=device)
    ready = time.time()
    cpu0 = time.process_time()
    bad = []
    for i in points:
        store = ForestStore.from_bytes(pre, device=device)
        journal = MigrationJournal()
        try:
            recluster(store, mode="extend", journal=journal, verify=False,
                      on_step=CrashSchedule(fail_at=(i,)))
            bad.append((i, "no crash"))
            continue
        except InjectedCrash:
            pass
        revived = MigrationJournal.from_bytes(journal.to_bytes())
        if revived.state == "idle":
            recluster(store, mode="extend", journal=revived, verify=False)
        else:
            resume_recluster(store, revived, verify=False)
        if revived.state != "committed" or store.to_bytes() != want:
            bad.append((i, revived.state))
    clock = {"entered_s": entered, "imported_s": imported,
             "cuda_ready_s": ready, "done_s": time.time()}
    return bad, time.process_time() - cpu0, {
        k: t - submitted for k, t in clock.items()}


def life_crash_sweep(dev):
    """Start the crash-at-every-step sweep on CRASH_USERS users in
    CRASH_WORKERS spawned processes (host work: every point reruns a
    recluster); returns what ``life_crash_result`` reads."""
    import concurrent.futures as cf
    import multiprocessing as mp

    from repro_torch.runtime.chaos import CrashSchedule
    from repro_torch.store import (
        ForestStore,
        MigrationJournal,
        build_store,
        make_drifted_fleet,
        recluster,
    )

    initial, late = make_drifted_fleet(CRASH_USERS, late_fraction=LIFE_LATE,
                                       seed=CRASH_SEED)
    store = build_store(initial, device=dev)
    for u, f in late.items():
        store.add_user(u, f)
    pre = store.to_bytes()
    clean = ForestStore.from_bytes(pre, device=dev)
    sched = CrashSchedule()
    t0 = time.perf_counter()
    recluster(clean, mode="extend", journal=MigrationJournal(), on_step=sched)
    uncrashed_s = time.perf_counter() - t0
    want, steps = clean.to_bytes(), list(sched.steps)
    submitted = time.time()
    pool = cf.ProcessPoolExecutor(CRASH_WORKERS,
                                  mp_context=mp.get_context("spawn"))
    futures = [pool.submit(crash_points, pre, want,
                           list(range(w, len(steps), CRASH_WORKERS)),
                           str(dev), submitted)
               for w in range(CRASH_WORKERS)]
    return {"pool": pool, "futures": futures, "steps": steps,
            "submitted": submitted, "uncrashed_s": uncrashed_s}


def life_crash_result(sweep):
    try:
        results = [f.result() for f in sweep["futures"]]
    finally:
        sweep["pool"].shutdown(wait=True, cancel_futures=True)
    collected_s = time.time() - sweep["submitted"]
    bad = [b for r in results for b in r[0]]
    assert bad == [], f"crash points that did not resume bit-exact: {bad}"
    steps = sweep["steps"]
    clocks = [r[2] for r in results]
    return {"users": CRASH_USERS, "steps": len(steps),
            "migrate_steps": sum(s.startswith("migrate:") for s in steps),
            "workers": CRASH_WORKERS, "uncrashed_s": sweep["uncrashed_s"],
            "sweep_span_s": max(c["done_s"] for c in clocks),
            "collected_s": collected_s,
            "worker_cpu_s": [r[1] for r in results],
            "worker_clock_s": {k: [c[k] for c in clocks] for k in clocks[0]},
            "every_step_resumed_to_uncrashed_bytes": True}


def life_recluster(dev, root):
    """The drifted fleet: the initial users built on the card, the late
    users onboarded; a warm session, held to the CPU's answer for the
    fleet before the recluster, crosses an extend recluster (RFJ1 journal
    on disk, verified) and serves that answer again; then a full rebuild
    of the pre-recluster bytes serves it too."""
    from repro_torch.serving import ForestServer
    from repro_torch.store import (
        ForestStore,
        MigrationJournal,
        build_store,
        drift_report,
        make_drifted_fleet,
        make_request_batch,
        recluster,
    )

    t0 = time.perf_counter()
    initial, late = make_drifted_fleet(LIFE_USERS, late_fraction=LIFE_LATE,
                                       seed=LIFE_SEED)
    fleet = {**initial, **late}
    t1 = time.perf_counter()
    store = build_store(initial, device=dev)
    t2 = time.perf_counter()
    for u, f in late.items():
        store.add_user(u, f)
    t3 = time.perf_counter()
    drift = drift_report(store)
    assert drift["recommend_recluster"], drift["fallback_user_fraction"]
    batch = make_request_batch(store, *LIFE_BATCH, seed=LIFE_SEED)
    pre = store.to_bytes()
    before, = cpu_answers(pre, [batch])
    server = ForestServer(store, device=dev)
    task = store.shared.task
    check_fleet(task, batch, server.serve(batch), before,
                "cold lifecycle batch")
    check_fleet(task, batch, server.serve(batch), before,
                "warm lifecycle batch")
    arena = store.arena
    runs = {u: arena.run_token(u) for u in store.user_ids if u in arena}
    journal = MigrationJournal(path=os.path.join(root, "recluster.rfj"))
    t4 = time.perf_counter()
    res = recluster(store, mode="extend", journal=journal, verify=True)
    t5 = time.perf_counter()
    assert res.verified_bit_exact and res.n_pending == 0
    assert journal.state == "committed"
    assert store.generations == [res.new_generation]
    reencoded = {u for u, r in res.per_user.items()
                 if r["status"] == "reencoded"}
    lost = {u for u in runs if arena.run_token(u) != runs[u]}
    assert lost <= reencoded, sorted(lost - reencoded)[:5]
    after = drift_report(store)
    assert after["n_fallback_users"] == 0, after["n_fallback_users"]
    check_fleet(task, batch, server.serve(batch), before,
                "after extend recluster")
    t6 = time.perf_counter()
    extend = {
        "n_relabeled": res.n_relabeled, "n_reencoded": res.n_reencoded,
        "bytes_before": res.bytes_before, "bytes_after": res.bytes_after,
        "wall_time_s": res.wall_time_s, "verified_bit_exact": True,
        "arena_runs_before": len(runs),
        "arena_runs_invalidated": len(lost),
        "invalidated_only_reencoded": True,
        "fallback_users_after": after["n_fallback_users"],
        "same_answer_after": True,
    }

    full_store = ForestStore.from_bytes(pre, device=dev)
    keep = sorted(full_store.user_ids)[:LIFE_FULL_USERS]
    if len(keep) < len(full_store.user_ids):
        cut = ForestStore(full_store.shared, device=dev)
        for u in keep:
            cut.add_delta(u, full_store.delta(u))
        full_store = cut
    res_full = recluster(full_store, mode="full", verify=True)
    assert res_full.verified_bit_exact and res_full.n_pending == 0
    fbatch = [(u, x) for u, x in batch if u in full_store]
    fwant = [p for (u, _), p in zip(batch, before) if u in full_store]
    check_fleet(task, fbatch, ForestServer(full_store, device=dev).serve(
        fbatch), fwant, "after full recluster")
    t7 = time.perf_counter()
    return {
        "users": len(fleet), "late_users": len(late),
        "fleet_s": t1 - t0, "build_initial_s": t2 - t1,
        "onboard_late_s": t3 - t2,
        "drift_before": {k: drift[k] for k in (
            "n_fallback_users", "fallback_user_fraction", "fallback_bytes",
            "fallback_overhead_fraction", "recommend_recluster")},
        "batch": {"requests": LIFE_BATCH[0], "rows": LIFE_BATCH[1]},
        "extend": extend, "extend_phase_s": t6 - t4,
        "full": {
            "users": len(keep), "n_relabeled": res_full.n_relabeled,
            "n_reencoded": res_full.n_reencoded,
            "bytes_before": res_full.bytes_before,
            "bytes_after": res_full.bytes_after,
            "wall_time_s": res_full.wall_time_s,
            "verified_bit_exact": True, "same_answer_after": True,
        },
        "full_phase_s": t7 - t6,
    }


def life_streaming(dev, root, fleet, requests, want):
    """``build_store_streaming`` of phase 10's 500-user fleet in waves,
    with extend; the durable store it writes loads bit-exact on the card
    and serves phase 10's batch to its CPU answer ``want``."""
    from repro_torch.serving import ForestServer
    from repro_torch.store import build_store_streaming

    waves = []
    t0 = time.perf_counter()
    durable = build_store_streaming(
        fleet, os.path.join(root, "stream"), wave_users=STREAM_WAVE,
        extend=True, on_wave=waves.append, device=dev)
    t1 = time.perf_counter()
    store = durable.load_store(lazy=False, device=dev)
    for u, f in fleet.items():
        assert store.reconstruct(u).equals(f), u
    check_fleet(store.shared.task, requests, ForestServer(
        store, device=dev).serve(requests, engine="pipelined"), want,
        "streaming-built store")
    return {
        "users": len(fleet), "wave_users": STREAM_WAVE, "waves": len(waves),
        "generations": store.generations,
        "extended_waves": sum(w["extended"] for w in waves),
        "build_s": t1 - t0, "epoch": durable.manifest.epoch,
        "live_bytes": durable.stats()["live_bytes"],
        "bit_exact_every_user": True, "serves_cpu_answer": True,
    }


def phase_store_lifecycle(dev, store, fleet, requests, want):
    """Phase 11 (module docstring): the fleet's life on disk and across
    codebook generations, on the card, over phase 10's classification
    store, the forests it was built from, its batch and the CPU's answer
    to it.  K1's count is set to 0 before and read after, and must be
    positive.  Returns the ``{"store_lifecycle": ...}`` row and the
    launch counts."""
    import shutil
    import tempfile

    from repro_torch.kernels.tree_predict import tree_predict as tp

    build_dir = os.path.join(ROOT, "build")
    os.makedirs(build_dir, exist_ok=True)
    root = tempfile.mkdtemp(prefix="store_lifecycle_", dir=build_dir)
    clock = {"start": time.perf_counter()}
    sweep = None
    try:
        sweep = life_crash_sweep(dev)
        clock["crash_sweep_started"] = time.perf_counter()
        tp.reset_launches()
        row = {"card": smi_line()}
        path, _durable, eager, row["durable"] = life_durable(
            dev, store, requests, want, root)
        clock["durable"] = time.perf_counter()
        batches, wants = residency_batches(dev, eager)
        row["residency"] = [life_residency(dev, path, frac, batches, wants)
                            for frac in LIFE_BUDGETS]
        clock["residency"] = time.perf_counter()
        row["repair"] = life_repair(dev, path, requests, want, root)
        clock["repair"] = time.perf_counter()
        row["lifecycle"] = life_recluster(dev, root)
        clock["lifecycle"] = time.perf_counter()
        row["streaming"] = life_streaming(dev, root, fleet, requests, want)
        clock["streaming"] = time.perf_counter()
        launches = dict(tp.LAUNCHES)
        row["crash_resume"] = life_crash_result(sweep)
        clock["crash_resume"] = time.perf_counter()
    finally:
        if sweep is not None:
            sweep["pool"].shutdown(wait=True, cancel_futures=True)
        shutil.rmtree(root, ignore_errors=True)
    assert launches[K1["name"]] > 0, "K1 was not launched by phase 11"
    row["launches"] = launches
    marks = list(clock.items())
    row["phase_s"] = {b[0]: b[1] - a[1] for a, b in zip(marks, marks[1:])}
    row["total_s"] = marks[-1][1] - marks[0][1]
    return row, launches


def lifecycle_main() -> None:
    """``--lifecycle``: phase 11 alone, over phase 10's 500-user
    classification fleet built here."""
    from repro_torch.kernels import build
    from repro_torch.store import (
        build_store,
        make_request_batch,
        make_synthetic_fleet,
    )

    dev = phase_environment()
    build.build(["tree_predict"])
    fleet = make_synthetic_fleet(FLEET_SERVE_USERS["classification"],
                                 "classification", seed=0)
    t0 = time.perf_counter()
    store = build_store(fleet, device=dev)
    log(json.dumps({"fleet_build_s": time.perf_counter() - t0}))
    requests = make_request_batch(store, FLEET_REQUESTS, FLEET_ROWS, seed=1)
    want, = cpu_answers(store.to_bytes(), [requests])
    row, _ = phase_store_lifecycle(dev, store, fleet, requests, want)
    log(json.dumps({"store_lifecycle": row}))
    print(json.dumps({"ok": True}), flush=True)


# ---------------------------------------------------------------------------
# phase 12: online serving (the scheduler) over the fleet store
# ---------------------------------------------------------------------------

# benchmarks/sched_bench.py's defaults: a seeded Poisson trace of 4 s at
# 150 requests/s, bursts of 2x, Zipf skew 1.1
ONLINE_TRACE = {"duration_s": 4.0, "rate_per_s": 150.0,
                "popularity_skew": 1.1, "burst_factor": 2.0, "seed": 0}
ONLINE_TP_ROWS = (64, 128, 256)  # throughput trace: bulk requests
ONLINE_TP_MAX_ROWS = 2048
ONLINE_REPEATS = 5
ONLINE_LAT_ROWS = (16, 32, 64)  # latency trace: interactive requests
ONLINE_LAT_MAX_ROWS = 512
ONLINE_SLO_S = 0.25
ONLINE_BUDGET = 0.15  # residency budget, a fraction of the delta bytes
ONLINE_LIFE_USERS = 100  # benchmarks/recluster_bench.py's drifted fleet
ONLINE_LIFE_REQUESTS = 200  # sched_bench's lifecycle loop
ONLINE_LIFE_ROWS = 8
ONLINE_FAIL_BATCH = 1  # part (e): the micro-batch BatchFaults fails
ONLINE_FAIL_BATCHES = 6  # part (e): recorded batches it replays


def poisson_trace(user_ids, duration_s, rate_per_s, *,
                  rows_choices=(16, 32, 64), popularity_skew=1.1,
                  burst_factor=1.0, burst_period_s=2.0, burst_duty=0.25,
                  seed=0):
    """``benchmarks/common.py::poisson_trace`` (that module imports the
    reference): a seeded multi-tenant arrival trace, (t, user, rows)
    events — Poisson arrivals thinned to a bursty rate of mean
    ``rate_per_s``, tenants drawn Zipf-like, row counts uniform over
    ``rows_choices``."""
    rng = np.random.default_rng(seed)
    weights = np.arange(1, len(user_ids) + 1, dtype=np.float64) \
        ** -float(popularity_skew)
    weights /= weights.sum()
    bf = max(float(burst_factor), 1.0)
    duty = min(max(float(burst_duty), 0.0), 1.0)
    hi = rate_per_s * bf
    lo = (rate_per_s * (1.0 - bf * duty) / (1.0 - duty)
          if duty < 1.0 else rate_per_s)
    lo = max(lo, 0.0)

    def rate_at(t):
        if bf <= 1.0 or duty in (0.0, 1.0):
            return rate_per_s
        return hi if (t % burst_period_s) < duty * burst_period_s else lo

    events = []
    t = 0.0
    while True:
        t += rng.exponential(1.0 / hi)
        if t >= duration_s:
            break
        if rng.random() * hi > rate_at(t):
            continue  # thinned: candidate falls in the trough
        events.append((t, user_ids[int(rng.choice(len(user_ids), p=weights))],
                       int(rng.choice(rows_choices))))
    return events


def trace_requests(store, events, seed=0):
    """``sched_bench.trace_rows`` for every event: (user, rows block)."""
    out = []
    for t, user, n_rows in events:
        rng = np.random.default_rng((seed, int(t * 1e6), n_rows))
        out.append((user, rng.integers(
            0, 64, size=(n_rows, store.shared.n_features), dtype=np.int32)))
    return out


def record_batches(server, events, requests, max_rows):
    """The micro-batches a ``VirtualClock`` scheduler forms from the trace
    (``sched_bench.record_batches``), each a list of indices into
    ``requests``."""
    from repro_torch.sched import MicroBatcher, Scheduler, VirtualClock

    clock = VirtualClock()
    sched = Scheduler(server, clock=clock,
                      batcher=MicroBatcher(max_rows=max_rows), safe=False)
    tickets = []
    for (t, _, _), (u, x) in zip(events, requests):
        if clock.now() < t:
            clock.advance(t - clock.now())
        tickets.append(sched.submit(u, x))
        sched.pump()
    sched.close()
    by_batch = {}
    for i, ticket in enumerate(tickets):
        by_batch.setdefault(ticket.batch_seq, []).append(i)
    return [by_batch[k] for k in sorted(by_batch)]


def check_tickets(task, requests, tickets, want, what):
    """Every ticket ``ok``, not degraded, and equal to the CPU's answer."""
    assert len(tickets) == len(requests) == len(want), what
    for (u, _), ticket, ref in zip(requests, tickets, want):
        assert ticket.status == "ok" and not ticket.degraded, (
            what, u, ticket.status, ticket.detail)
        check_pred(task, ticket.prediction, ref, f"{what}: user {u}")


def check_executor(sched, server, pipelined_before, what):
    """No failed batch, a pre-plan for each overlapped run, and every
    batch served through ``pipelined`` (K1)."""
    ex = sched.executor.stats()
    assert ex["n_failed_batches"] == 0, (what, ex)
    if ex["overlap"]:
        assert ex["n_preplanned"] > 0, (what, ex)
    served = server.engine_counts["pipelined"] - pipelined_before
    assert served == ex["n_batches"], (what, served, ex)
    return ex


def online_throughput(server, events, requests, wants):
    """Part (a): the recorded micro-batches through the scheduler
    (``WallClock``, overlap on, ``safe=False``) and through direct
    ``serve``, warm and with the plan cache cleared, interleaved; the
    minimum of each over ``ONLINE_REPEATS``."""
    from repro_torch.sched import MicroBatcher, Scheduler

    task = server.store.shared.task
    order = record_batches(server, events, requests, ONLINE_TP_MAX_ROWS)
    batches = [[requests[i] for i in b] for b in order]
    flat = [r for b in batches for r in b]
    want = [wants[i] for b in order for i in b]
    n_rows = sum(len(x) for _, x in flat)
    sched = Scheduler(server, batcher=MicroBatcher(max_rows=1 << 30),
                      safe=False)

    def direct(cold=False):
        if cold:
            server.plan_cache.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        preds = [p for b in batches for p in server.serve(b)]
        return time.perf_counter() - t0, preds

    def scheduled(cold=False):
        if cold:
            server.plan_cache.clear()
        before = server.engine_counts["pipelined"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tickets = []
        for b in batches:
            tickets.extend(sched.submit(u, x) for u, x in b)
            sched.flush(drain=False)  # one micro-batch per recorded batch
        sched.executor.drain()
        dt = time.perf_counter() - t0
        served = server.engine_counts["pipelined"] - before
        assert served == len(batches), (served, len(batches))
        return dt, tickets

    _, preds = direct()
    check_fleet(task, flat, preds, want, "direct serve of the trace")
    scheduled()  # warm the scheduler's session
    best = {k: float("inf") for k in ("direct", "sched", "direct_cold",
                                      "sched_cold")}
    runs = {k: [] for k in best}
    for _ in range(ONLINE_REPEATS):
        for key, fn, cold in (("direct", direct, False),
                              ("sched", scheduled, False),
                              ("direct_cold", direct, True),
                              ("sched_cold", scheduled, True)):
            dt, out = fn(cold)
            runs[key].append(dt)
            best[key] = min(best[key], dt)
            if fn is scheduled:
                check_tickets(task, flat, out, want,
                              f"scheduled trace ({key})")
                for ticket, p in zip(out, preds):
                    assert np.array_equal(ticket.prediction, p), key
    sched.close()
    ex = sched.executor.stats()
    assert ex["n_failed_batches"] == 0 and ex["n_preplanned"] > 0, ex
    return order, {
        "requests": len(flat), "rows": n_rows, "batches": len(batches),
        "max_rows": ONLINE_TP_MAX_ROWS, "repeats": ONLINE_REPEATS,
        **{f"{k}_ms": v * 1e3 for k, v in best.items()},
        "runs_ms": {k: [v * 1e3 for v in vs] for k, vs in runs.items()},
        "direct_rows_per_s": n_rows / best["direct"],
        "sched_rows_per_s": n_rows / best["sched"],
        "sched_vs_direct": best["direct"] / best["sched"],
        "sched_vs_direct_coldplan": best["direct_cold"] / best["sched_cold"],
        "executor": ex, "equal_to_direct_and_cpu": True,
    }


def paced(sched, events, requests):
    """Open-loop replay on the wall clock: each request submitted at its
    trace time, the pump run after each; returns the tickets and the
    seconds from the first arrival to the drained close."""
    tickets = []
    start = time.monotonic()
    for (t, _, _), (u, x) in zip(events, requests):
        lag = t - (time.monotonic() - start)
        if lag > 0:
            time.sleep(lag)
        tickets.append(sched.submit(u, x))
        sched.pump()
    sched.close()
    return tickets, time.monotonic() - start


def online_latency(server, events, requests, want):
    """Part (b): ``sched_bench.bench_latency`` — the trace's batches
    served once to warm, then two paced passes through a ``WallClock``
    scheduler (overlap on, ``serve_safe``); the second is reported."""
    from repro_torch.sched import MicroBatcher, RequestQueue, Scheduler

    task = server.store.shared.task
    for b in record_batches(server, events, requests, ONLINE_LAT_MAX_ROWS):
        server.serve([requests[i] for i in b])
    passes = []
    for _ in range(2):
        before = server.engine_counts["pipelined"]
        sched = Scheduler(server, queue=RequestQueue(slo_s=ONLINE_SLO_S),
                          batcher=MicroBatcher(max_rows=ONLINE_LAT_MAX_ROWS))
        tickets, wall_s = paced(sched, events, requests)
        check_tickets(task, requests, tickets, want, "paced trace")
        ex = check_executor(sched, server, before, "paced trace")
        passes.append((sched, wall_s, ex))
    sched, wall_s, ex = passes[-1]
    lat = sched.latency_stats()
    lat2 = sched.latency_stats(slack_s=ONLINE_SLO_S)
    stats = sched.stats()
    return {
        "requests": len(requests), "slo_s": ONLINE_SLO_S,
        "max_rows": ONLINE_LAT_MAX_ROWS,
        "p50_ms": lat["p50_ms"], "p99_ms": lat["p99_ms"],
        "max_ms": lat["max_ms"],
        "slo_attainment": lat["slo_attainment"],
        "slo_attainment_2x": lat2["slo_attainment"],
        "trigger_counts": stats["batcher"]["trigger_counts"],
        "plan_hit_rate": server.plan_cache.stats()["plan_hit_rate"],
        "requests_per_s": len(requests) / wall_s, "wall_s": wall_s,
        "first_pass_p99_ms": passes[0][0].latency_stats()["p99_ms"],
        "executor": ex, "equal_to_cpu": True,
    }


def spy_threads(obj, names, calls):
    """Record (method, thread name) of every call of ``obj``'s methods."""
    import threading

    for name in names:
        real = getattr(obj, name)

        def spy(*a, _real=real, _name=name, **k):
            calls.append((_name, threading.current_thread().name))
            return _real(*a, **k)

        setattr(obj, name, spy)


def online_durable(dev, store, events, requests, want, root):
    """Part (c): the fleet on disk, opened lazily under a residency
    budget with a background ``Prefetcher``, served by a ``WallClock``
    scheduler (overlap on) with a ``LifecycleDriver`` that scrubs.  One
    user's shard is corrupted first; the driver's first tick, in the idle
    gap before the first arrival, scrubs the whole manifest and repairs
    it.  Every arena call is counted by thread, and every cold load by
    thread and by whether ``plan`` made it (ROADMAP R7)."""
    import threading

    from repro_torch.sched import (
        LifecycleDriver,
        MicroBatcher,
        RequestQueue,
        Scheduler,
        WallClock,
    )
    from repro_torch.serving import ForestServer
    from repro_torch.store import (
        DurableStore,
        Prefetcher,
        Scrubber,
        attach_residency,
    )

    path = os.path.join(root, "online")
    t0 = time.perf_counter()
    DurableStore.create(path, store)
    durable = DurableStore.open(path)
    delta_bytes = sum(e.length for e in durable.delta_entries())
    budget = int(ONLINE_BUDGET * delta_bytes)
    victim = requests[0][0]
    flip_shard_bits(durable, victim, seed=21)
    lazy = durable.load_store(device=dev)
    mgr = attach_residency(lazy, durable, budget, clock=time.perf_counter)
    server = ForestServer(lazy, device=dev)
    arena_calls, loads, in_plan = [], [], threading.local()
    spy_threads(lazy.arena, ("admit_many", "gather", "run_token",
                             "invalidate", "touch_users"), arena_calls)
    plan, notify = server.plan, mgr.notify_loaded

    def counted_plan(*a, **k):
        in_plan.on = True
        try:
            return plan(*a, **k)
        finally:
            in_plan.on = False

    def counted_load(user_id, *a, **k):
        loads.append((threading.current_thread().name,
                      getattr(in_plan, "on", False)))
        return notify(user_id, *a, **k)

    server.plan, mgr.notify_loaded = counted_plan, counted_load
    items = sum(len(s.shards) + 1 for s in durable.manifest.slabs)
    scrubber = Scrubber(durable)
    clock = WallClock()
    # one whole pass a minute: the gap's pass repairs, none runs mid-trace
    driver = LifecycleDriver(server, clock, scrubber=scrubber,
                             scrub_interval_s=60.0,
                             scrub_shards_per_tick=items)
    pf = Prefetcher(mgr, server=server, background=True)
    sched = Scheduler(server, clock=clock,
                      queue=RequestQueue(slo_s=ONLINE_SLO_S),
                      batcher=MicroBatcher(max_rows=ONLINE_LAT_MAX_ROWS),
                      lifecycle=driver, prefetcher=pf)
    t1 = time.perf_counter()
    sched.pump()  # the idle gap: the driver scrubs, then polls drift
    t2 = time.perf_counter()
    assert scrubber.repairs == 1, scrubber.stats()
    gap_loads = len(loads)
    before = server.engine_counts["pipelined"]
    tickets, wall_s = paced(sched, events, requests)
    task = store.shared.task
    check_tickets(task, requests, tickets, want, "durable online stack")
    ex = check_executor(sched, server, before, "durable online stack")
    st = mgr.stats()
    assert st["prefetch_errors"] == 0, st["prefetch_errors"]
    assert mgr.accounted_bytes() <= budget, (mgr.accounted_bytes(), budget)
    threads = {t for _, t in arena_calls}
    assert arena_calls and threads == {"sched-executor"}, sorted(
        {c for c in arena_calls if c[1] != "sched-executor"})
    assert driver.n_scrub_failures == 0 and scrubber.repairs == 1
    alive = {t.name for t in threading.enumerate()}
    assert not alive & {"sched-executor", "residency-prefetch"}, alive
    trace_loads = loads[gap_loads:]
    by_thread = {}
    for name, planned in trace_loads:
        key = f"{name}{' (plan)' if planned else ''}"
        by_thread[key] = by_thread.get(key, 0) + 1
    lat = sched.latency_stats()
    return {
        "users": len(store.user_ids), "budget_bytes": budget,
        "delta_bytes": delta_bytes, "budget_fraction": ONLINE_BUDGET,
        "victim": victim, "scrub": scrubber.stats(),
        "scrub_failures": driver.n_scrub_failures,
        "open_s": t1 - t0, "gap_tick_s": t2 - t1,
        "gap_cold_loads": gap_loads,
        "cold_loads_in_trace": len(trace_loads),
        "cold_loads_in_plan": sum(1 for _, p in trace_loads if p),
        "cold_loads_by_thread": by_thread,
        "prefetch_requested": st["prefetch_requested"],
        "prefetch_staged": st["prefetch_staged"],
        "prefetch_hits": st["prefetch_hits"],
        "prefetch_errors": st["prefetch_errors"],
        "demotions": st["demotions"], "reloads": st["reloads"],
        "over_budget_events": st["over_budget_events"],
        "cold_load_ms_p50": st["cold_load_ms_p50"],
        "cold_load_ms_p99": st["cold_load_ms_p99"],
        "requests_per_s": len(requests) / wall_s, "wall_s": wall_s,
        "p50_ms": lat["p50_ms"], "p99_ms": lat["p99_ms"],
        "slo_attainment": lat["slo_attainment"],
        "arena_calls": len(arena_calls), "arena_call_threads": sorted(threads),
        "driver_polls": driver.n_polls, "executor": ex,
        "budget_held": True, "equal_to_cpu": True,
    }


def online_lifecycle_run(dev, journal_path):
    """``sched_bench``'s lifecycle loop on ``dev``: the drifted fleet
    served under ``VirtualClock`` while a ``LifecycleDriver`` reclusters
    and migrates, rate-limited, with an RFJ1 journal on disk."""
    from repro_torch.sched import (
        LifecycleDriver,
        MicroBatcher,
        RequestQueue,
        Scheduler,
        VirtualClock,
    )
    from repro_torch.serving import ForestServer
    from repro_torch.store import build_store, drift_report, make_drifted_fleet

    initial, late = make_drifted_fleet(ONLINE_LIFE_USERS,
                                       late_fraction=LIFE_LATE,
                                       seed=CRASH_SEED)
    t0 = time.perf_counter()
    store = build_store(initial, device=dev)
    for u, f in late.items():
        store.add_user(u, f)
    t1 = time.perf_counter()
    assert drift_report(store)["recommend_recluster"]
    server = ForestServer(store, device=dev)
    clock = VirtualClock()
    driver = LifecycleDriver(server, clock, poll_interval_s=0.2,
                             low_load_rows=256, migrate_users_per_s=20.0,
                             max_users_per_tick=2, journal_path=journal_path)
    sched = Scheduler(server, clock=clock,
                      queue=RequestQueue(slo_s=ONLINE_SLO_S),
                      batcher=MicroBatcher(max_rows=128), lifecycle=driver)
    users = sorted({**initial, **late})
    rng = np.random.default_rng(CRASH_SEED + 9)
    gen0 = store.generation
    before = server.engine_counts["pipelined"]
    tickets, mid = [], 0
    for _ in range(ONLINE_LIFE_REQUESTS):
        u = users[int(rng.integers(len(users)))]
        x = rng.integers(0, 64, size=(ONLINE_LIFE_ROWS,
                                      store.shared.n_features),
                         dtype=np.int32)
        tickets.append((u, x, sched.submit(u, x)))
        clock.advance(0.05)
        sched.pump()
        mid += driver.state == "migrating"
    while driver.state == "migrating":
        clock.advance(0.1)
        sched.pump()
    sched.close()
    t2 = time.perf_counter()
    ex = check_executor(sched, server, before, f"lifecycle loop on {dev}")
    with open(journal_path, "rb") as f:
        journal = f.read()
    return store, tickets, journal, {
        "users": len(users), "late_users": len(late),
        "build_s": t1 - t0, "serve_s": t2 - t1,
        "generation": [gen0, store.generation],
        "n_reclusters": driver.n_reclusters,
        "n_migrated": driver.n_migrated,
        "n_migration_ticks": driver.n_migration_ticks,
        "served_mid_migration": mid,
        "journal_state": driver.stats()["journal"]["state"],
        "fallback_user_fraction_after":
            drift_report(store)["fallback_user_fraction"],
        "deadline_misses_beyond_slack":
            sched.latency_stats(slack_s=ONLINE_SLO_S)["deadline_misses"],
        "executor": ex,
    }


def online_lifecycle(dev, root):
    """Part (d): the lifecycle loop on the card and on the CPU; every
    card ticket held to per-user ``predict_compressed`` on the CPU store,
    and the card's RFT1 and RFJ1 bytes to the CPU's."""
    card, tickets, journal, row = online_lifecycle_run(
        dev, os.path.join(root, "card.rfj"))
    cpu, cpu_tickets, cpu_journal, cpu_row = online_lifecycle_run(
        "cpu", os.path.join(root, "cpu.rfj"))
    silent_wrong = 0
    for (u, x, t), (cu, cx, ct) in zip(tickets, cpu_tickets):
        assert u == cu and np.array_equal(x, cx)
        assert t.status == ct.status == "ok" and not t.degraded, (
            u, t.status, t.detail)
        if not np.array_equal(t.prediction, cpu.predict(u, x)):
            silent_wrong += 1
    assert row["n_reclusters"] >= 1, row
    assert row["served_mid_migration"] > 0, row
    assert row["journal_state"] == "committed", row
    assert row["fallback_user_fraction_after"] == 0.0, row
    assert silent_wrong == 0, silent_wrong
    rft1_equal = card.to_bytes() == cpu.to_bytes()
    rfj1_equal = journal == cpu_journal
    assert rft1_equal and rfj1_equal, (rft1_equal, rfj1_equal)
    for key in ("n_reclusters", "n_migrated", "n_migration_ticks",
                "served_mid_migration", "generation"):
        assert row[key] == cpu_row[key], (key, row[key], cpu_row[key])
    return {**row, "silent_wrong_total": silent_wrong,
            "rft1_equal_cpu": rft1_equal, "rfj1_equal_cpu": rfj1_equal,
            "rfj1_bytes": len(journal), "cpu_build_s": cpu_row["build_s"],
            "cpu_serve_s": cpu_row["serve_s"]}


def online_isolation(server, batches, wants):
    """Part (e): ``BatchFaults`` fails micro-batch ``ONLINE_FAIL_BATCH``
    of a ``WallClock`` scheduler run (overlap on); exactly its tickets are
    ``failed`` and every other ticket is ``ok`` and exact."""
    from repro_torch.runtime.chaos import BatchFaults
    from repro_torch.sched import MicroBatcher, Scheduler

    task = server.store.shared.task
    faults = BatchFaults(fail_batches=(ONLINE_FAIL_BATCH,))
    sched = Scheduler(server, batcher=MicroBatcher(max_rows=1 << 30),
                      fault_hook=faults)
    tickets = []
    for b in batches:
        tickets.append([sched.submit(u, x) for u, x in b])
        sched.flush(drain=False)
    sched.close()
    ex = sched.executor.stats()
    assert ex["n_failed_batches"] == 1, ex
    n_failed = 0
    for k, (b, ts, want) in enumerate(zip(batches, tickets, wants)):
        if k == ONLINE_FAIL_BATCH:
            for t in ts:
                assert t.status == "failed" and "InjectedCrash" in t.detail
                assert t.prediction is None
                n_failed += 1
        else:
            check_tickets(task, b, ts, want, f"isolation batch {k}")
    return {"batches": len(batches), "failed_batch": ONLINE_FAIL_BATCH,
            "failed_tickets": n_failed, "executor": ex}


def phase_online(dev, store):
    """Phase 12 (module docstring): online serving through
    ``repro_torch.sched`` on the card, over phase 10's classification
    store.  K1's count is set to 0 before and read after, and must be
    positive.  Returns the ``{"online": ...}`` row and the launch
    counts."""
    import shutil
    import tempfile

    from repro_torch.kernels.tree_predict import tree_predict as tp
    from repro_torch.serving import ForestServer

    build_dir = os.path.join(ROOT, "build")
    os.makedirs(build_dir, exist_ok=True)
    root = tempfile.mkdtemp(prefix="online_", dir=build_dir)
    clock = {"start": time.perf_counter()}
    users = sorted(store.user_ids)
    tp_events = poisson_trace(users, ONLINE_TRACE["duration_s"],
                              ONLINE_TRACE["rate_per_s"],
                              rows_choices=ONLINE_TP_ROWS,
                              **{k: ONLINE_TRACE[k] for k in (
                                  "popularity_skew", "burst_factor", "seed")})
    lat_events = poisson_trace(users, ONLINE_TRACE["duration_s"],
                               ONLINE_TRACE["rate_per_s"],
                               rows_choices=ONLINE_LAT_ROWS,
                               **{k: ONLINE_TRACE[k] for k in (
                                   "popularity_skew", "burst_factor",
                                   "seed")})
    tp_requests = trace_requests(store, tp_events)
    lat_requests = trace_requests(store, lat_events)
    tp_want, lat_want = cpu_answers(store.to_bytes(),
                                    [tp_requests, lat_requests])
    clock["cpu_answers"] = time.perf_counter()
    tp.reset_launches()
    row = {"card": smi_line(), "trace": dict(ONLINE_TRACE)}
    try:
        server = ForestServer(store, device=dev)
        order, row["throughput"] = online_throughput(
            server, tp_events, tp_requests, tp_want)
        clock["throughput"] = time.perf_counter()
        row["latency"] = online_latency(ForestServer(store, device=dev),
                                        lat_events, lat_requests, lat_want)
        clock["latency"] = time.perf_counter()
        row["durable"] = online_durable(dev, store, lat_events,
                                        lat_requests, lat_want, root)
        clock["durable"] = time.perf_counter()
        row["lifecycle"] = online_lifecycle(dev, root)
        clock["lifecycle"] = time.perf_counter()
        fail = order[:ONLINE_FAIL_BATCHES]
        row["isolation"] = online_isolation(
            ForestServer(store, device=dev),
            [[tp_requests[i] for i in b] for b in fail],
            [[tp_want[i] for i in b] for b in fail])
        clock["isolation"] = time.perf_counter()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    launches = dict(tp.LAUNCHES)
    assert launches[K1["name"]] > 0, "K1 was not launched by phase 12"
    row["launches"] = launches
    marks = list(clock.items())
    row["phase_s"] = {b[0]: b[1] - a[1] for a, b in zip(marks, marks[1:])}
    row["total_s"] = marks[-1][1] - marks[0][1]
    return row, launches


def online_main() -> None:
    """``--online``: phase 12 alone, over phase 10's 500-user
    classification fleet built here."""
    from repro_torch.kernels import build
    from repro_torch.store import build_store, make_synthetic_fleet

    dev = phase_environment()
    build.build(["tree_predict"])
    fleet = make_synthetic_fleet(FLEET_SERVE_USERS["classification"],
                                 "classification", seed=0)
    t0 = time.perf_counter()
    store = build_store(fleet, device=dev)
    log(json.dumps({"fleet_build_s": time.perf_counter() - t0}))
    row, _ = phase_online(dev, store)
    log(json.dumps({"online": row}))
    print(json.dumps({"ok": True}), flush=True)


# ---------------------------------------------------------------------------
# phase 13: the LM substrate's other families (Hymba, Granite-MoE,
# DeepSeek-V3) served on the card
# ---------------------------------------------------------------------------

# (arch, (layers, d_model, dtype) as served, batch, prompt, max_len, decode
# steps, K7 launches per prefill, layers profiled, check prompt): bf16,
# random weights from seed 0.  hymba-1.5b and granite-moe-3b-a800m are
# uncut; deepseek-v3-671b keeps its full width but is cut to one dense and
# one MoE layer (FAMILY_DSV3_CUT): 61 layers would be ~1.3 TB in bf16.
# Hymba's prefill is profiled over its first 4 layers (the scan's ~4,400
# launches a layer make a whole-model trace too long to read back); its
# check prompt is the main path's, since its ring buffer needs window | S.
# DeepSeek-V3's check prompt is 1 x 2,047: ``forward`` on S + 1 tokens
# then stays below the chunked path, which needs chunk | S (4,097 is
# refused in both packages), and its float32 dense MLA scores fit the card.
FAMILY_DSV3_CUT = {"n_layers": 2, "n_dense_layers": 1}
# Each serves 8 decode steps (cut from 32, DeepSeek-V3's from 16, to pay
# for phase 15 (g)).
FAMILY_RUNS = [
    ("hymba-1.5b", (32, 1600, "bfloat16"), 2, 4096, 4128, 8, 32, 4,
     (2, 4096)),
    ("granite-moe-3b-a800m", (32, 1536, "bfloat16"), 4, 2048, 2080, 8, 32,
     None, (4, 2048)),
    ("deepseek-v3-671b", (2, 7168, "bfloat16"), 1, 4096, 4112, 8, 0, None,
     (1, 2047)),
]
# the float32 and bf16 checks of DeepSeek-V3 run on a copy with its routed
# experts cut from 256 to 32 (top-8 kept): at 256, float32 weights beside
# the bf16 ones would need ~87 GB
FAMILY_DSV3_CHECK_EXPERTS = 32
# bf16 differences are held to this factor over their witness, bf16's own
# rounding floor read in the same run (phase 9's rule)
FAMILY_BF16_OVER_FLOOR = 1.5
# timed prefills per model after the warm-up: the median is reported with
# its min and max (a prefill is host-bound where the plain scan runs)
FAMILY_PREFILL_REPS = 2  # timed prefills a model (5 -> 3 for phase 15 (f),
# 3 -> 2 for (g))
# the labelled regions of a profiled prefill: (label, module, function)
FAMILY_REGIONS = (
    ("ssm.selective_scan", "ssm", "selective_scan"),
    ("moe.moe_apply", "model", "moe_apply"),
    ("moe.experts", "moe", "_experts"),
    ("mla.prefill", "model", "mla_prefill"),
    ("mla.attend_chunked", "mla", "_attend_chunked"),
    ("mla.attend_dense", "mla", "_attend_dense"),
)


def family_config(name, **changes):
    import dataclasses

    from repro_torch.configs import get_config

    cfg = get_config(name)
    if name == "deepseek-v3-671b":
        cfg = dataclasses.replace(cfg, **FAMILY_DSV3_CUT)
    return dataclasses.replace(cfg, **changes) if changes else cfg


def dropless(cfg):
    """The config with no capacity drop (capacity_factor E / k, as the
    reference's decode test runs MoE): a (B, S) batch and a (B, 1) one
    then route alike.  Other configs unchanged."""
    import dataclasses

    if cfg.mlp_type != "moe":
        return cfg
    return dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.top_k)


def profile_regions(fn) -> dict:
    """``torch.profiler`` over one call of ``fn`` with FAMILY_REGIONS
    labelled (``record_function`` around each function, put back after):
    per label, the device ms of the kernels launched inside it, the
    device span its annotation covers, and its calls; the device ms of
    every kernel of the call."""
    import importlib

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    saved = []
    for label, mod_name, fn_name in FAMILY_REGIONS:
        mod = importlib.import_module(f"repro_torch.models.{mod_name}")
        orig = getattr(mod, fn_name)

        def wrapped(*a, _orig=orig, _label=label, **kw):
            with record_function(_label):
                return _orig(*a, **kw)

        saved.append((mod, fn_name, orig))
        setattr(mod, fn_name, wrapped)
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    finally:
        for mod, fn_name, orig in saved:
            setattr(mod, fn_name, orig)
    labels = {label for label, _, _ in FAMILY_REGIONS}
    regions = {}
    kernel_us = 0.0
    for e in prof.events():
        if e.name not in labels:
            if e.device_type == DeviceType.CUDA:
                kernel_us += e.time_range.elapsed_us()
            continue
        r = regions.setdefault(e.name, {"device_ms": 0.0,
                                        "device_span_ms": 0.0, "calls": 0})
        if e.device_type == DeviceType.CUDA:
            r["device_span_ms"] += e.time_range.elapsed_us() / 1e3
        else:
            r["device_ms"] += e.device_time_total / 1e3
            r["calls"] += 1
    return {"regions": regions, "device_ms": kernel_us / 1e3}


def family_shares(prof, name) -> dict:
    """The plain device work's shares of the profiled prefill's device
    time: the selective scan (Hymba), MoE dispatch plus combine
    (everything in ``moe_apply`` but the three expert products) and the
    expert products, MLA's attention core and the whole MLA prefill."""
    reg = prof["regions"]
    total = prof["device_ms"]

    def ms(label):
        return reg.get(label, {}).get("device_ms", 0.0)

    out = {"device_ms": total}
    if name == "hymba-1.5b":
        out["selective_scan_ms"] = ms("ssm.selective_scan")
    if "moe.moe_apply" in reg:
        out["moe_dispatch_combine_ms"] = (ms("moe.moe_apply")
                                          - ms("moe.experts"))
        out["moe_experts_ms"] = ms("moe.experts")
    if "mla.prefill" in reg:
        out["mla_attention_ms"] = (ms("mla.attend_chunked")
                                   + ms("mla.attend_dense"))
        out["mla_prefill_ms"] = ms("mla.prefill")
    for key in [k for k in out if k.endswith("_ms") and k != "device_ms"]:
        out[key[:-3] + "_share"] = out[key] / total if total else None
    return out


def family_main_path(dev, run):
    """One family's main path: ``init_params`` (bf16, seed 0),
    ``make_prefill_step(cfg, use_flash=True)`` over seeded prompts (a
    warm-up, then FAMILY_PREFILL_REPS timed prefills, the last one's cache
    decoded), greedy ``make_decode_step`` steps.
    K7's count is set to 0 before each prefill and read after it: one
    launch per attention layer (Hymba, Granite), none for MLA; decode adds
    none.  Then one profiled prefill (``profile_regions``)."""
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import init_params

    (name, shape, batch, prompt, max_len, steps, k7_per_prefill,
     profile_layers, _) = run
    cfg = family_config(name)
    assert (cfg.n_layers, cfg.d_model, cfg.dtype) == shape, cfg
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    host = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (batch, prompt),
                           generator=host).to(dev)
    prefill_step = make_prefill_step(cfg, use_flash=True)
    decode = make_decode_step(cfg)

    fa.reset_launches()
    t0 = time.perf_counter()
    _, warm_cache = prefill_step(params, tokens, max_len=max_len)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    assert fa.LAUNCHES["flash"] == k7_per_prefill, (name, fa.LAUNCHES)
    del warm_cache

    prefill_times = []
    for _ in range(FAMILY_PREFILL_REPS):
        cache = None
        fa.reset_launches()
        t0 = time.perf_counter()
        logits, cache = prefill_step(params, tokens, max_len=max_len)
        torch.cuda.synchronize()
        prefill_times.append(time.perf_counter() - t0)
        launches = fa.LAUNCHES["flash"]
        assert launches == k7_per_prefill, (name, fa.LAUNCHES)
    t_prefill = float(np.median(prefill_times))
    assert logits.shape == (batch, cfg.vocab_size)
    assert bool(torch.isfinite(logits).all()), f"{name} prefill not finite"
    tok = logits.argmax(-1)
    out = [tok]
    t0 = time.perf_counter()
    for _ in range(steps):
        logits, cache = decode(params, tok, cache)
        tok = logits.argmax(-1)
        out.append(tok)
    torch.cuda.synchronize()
    t_decode = time.perf_counter() - t0
    assert fa.LAUNCHES["flash"] == launches, (name, fa.LAUNCHES)
    assert bool(torch.isfinite(logits).all()), f"{name} decode not finite"
    assert int(cache["pos"].min()) == int(cache["pos"].max()) == (
        prompt + steps)
    gen = torch.stack(out, 1)
    assert gen.shape == (batch, steps + 1)
    assert 0 <= int(gen.min()) and int(gen.max()) < cfg.vocab_size
    peak = torch.cuda.max_memory_allocated(dev)
    del cache

    full = params.layers
    if profile_layers:
        params.layers = full[:profile_layers]
    try:
        prof = profile_regions(
            lambda: prefill_step(params, tokens, max_len=max_len))
    finally:
        params.layers = full
    row = {
        "model": name, "layers": cfg.n_layers,
        "dense_layers": len(params.layers_dense), "d_model": cfg.d_model,
        "heads": cfg.n_heads, "kv_heads": cfg.n_kv_heads,
        "params": sum(p.numel() for p in params.parameters()),
        "dtype": cfg.dtype, "batch": batch, "prompt": prompt,
        "max_len": max_len, "init_s": init_s, "warm_prefill_s": warm_s,
        "prefill_s": t_prefill, "prefill_s_min": min(prefill_times),
        "prefill_s_max": max(prefill_times), "prefill_s_all": prefill_times,
        "prefill_tok_s": batch * prompt / t_prefill,
        "decode_steps": steps,
        "decode_ms_per_step": t_decode / steps * 1e3,
        "decode_tok_s": batch * steps / t_decode,
        "max_memory_allocated": peak,
        "k7_launches_per_prefill": launches,
        "sample_tokens": gen[0, :8].tolist(),
        "profiled_layers": profile_layers or cfg.n_layers,
        "profile": family_shares(prof, name),
        "regions": prof["regions"],
    }
    return cfg, params, tokens, row


def family_pair_checks(cfg, params, tokens, nxt, max_len):
    """For one set of weights: the K7 prefill against the plain one
    (``use_flash=False``; skipped for MLA, which never takes K7), both at
    the served capacity factor, since both route the same (B, S) batch;
    and decode after prefill(S) against ``forward`` on the prompt plus the
    token (its last logits), an MoE config dropless (``dropless``): a
    (B, S) batch and a (B, 1) one legitimately drop different
    assignments."""
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import forward

    flash = make_prefill_step(cfg, use_flash=True)
    lf, cache = flash(params, tokens, max_len=max_len)
    out = {"flash": lf}
    if cfg.attn_type != "mla":
        out["plain"], _ = make_prefill_step(cfg, use_flash=False)(
            params, tokens, max_len=max_len)
    dcfg = dropless(cfg)
    if dcfg is not cfg:
        del cache
        out["flash_dropless"], cache = make_prefill_step(
            dcfg, use_flash=True)(params, tokens, max_len=max_len)
    out["decode"], _ = make_decode_step(dcfg)(params, nxt, cache)
    del cache
    full, _ = forward(dcfg, params, torch.cat([tokens, nxt[:, None]], 1),
                      use_flash=True)
    out["forward"] = full[:, -1]
    del full
    for key, t in out.items():
        assert bool(torch.isfinite(t).all()), f"{cfg.name} {key} not finite"
    return out


def family_seed_checks(dev, cfg, params, tokens, nxt, max_len):
    """``family_pair_checks`` in bf16 and in float32 (the same weights
    upcast).  Float32: K7 against plain (served capacity), and decode
    against forward (dropless), within F32_MODEL_REL_L2 (and decode at
    DECODE_RTOL).  bf16: the same gaps within FAMILY_BF16_OVER_FLOOR
    times their witness, the bf16 plain prefill's (resp. forward's)
    distance from the float32 run."""
    import dataclasses

    from repro_torch.models import TransformerLM

    bf = family_pair_checks(cfg, params, tokens, nxt, max_len)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params32 = TransformerLM(cfg32, dev)
    with torch.no_grad():
        for p32, p in zip(params32.parameters(), params.parameters()):
            p32.copy_(p.float())
    f32 = family_pair_checks(cfg32, params32, tokens, nxt, max_len)
    r32 = {
        "decode_vs_forward_rel_l2": rel_l2(f32["decode"], f32["forward"]),
        "decode_vs_forward_allclose_5e-2": bool(torch.allclose(
            f32["decode"].float(), f32["forward"].float(),
            rtol=DECODE_RTOL, atol=DECODE_ATOL)),
    }
    rbf = {
        "decode_vs_forward_rel_l2": rel_l2(bf["decode"], bf["forward"]),
        "forward_vs_f32_rel_l2": rel_l2(bf["forward"], f32["forward"]),
        "flash_vs_f32_rel_l2": rel_l2(bf["flash"], f32["flash"]),
    }
    if "plain" in f32:
        r32["flash_vs_plain_rel_l2"] = rel_l2(f32["flash"], f32["plain"])
        rbf["flash_vs_plain_rel_l2"] = rel_l2(bf["flash"], bf["plain"])
        rbf["plain_vs_f32_rel_l2"] = rel_l2(bf["plain"], f32["flash"])
    return {"float32": r32, "bfloat16": rbf}, params32


def mla_layer0_check(cfg32, params32, tokens) -> dict:
    """DeepSeek-V3's layer 0 (float32) at S = 4,096: ``_attend_chunked``
    (the online softmax over live blocks) against the dense MLA formula
    (``_attend_dense``, 16 heads at a time) on the same q / k / v."""
    from repro_torch.models import mla
    from repro_torch.models.layers import rms_norm
    from repro_torch.models.model import _positions, embed_inputs

    blk = params32.layers_dense[0]
    x = rms_norm(embed_inputs(cfg32, params32, tokens), blk.norm1,
                 cfg32.rms_eps)
    b, s, _ = x.shape
    pos = _positions(b, s, x.device)
    h, qk_n = cfg32.n_heads, cfg32.qk_nope_dim
    q_nope, q_rope = mla._queries(blk.attn, cfg32, x, pos)
    c_kv, k_rope = mla._latents(blk.attn, cfg32, x, pos)
    k_nope = (c_kv @ blk.attn.w_uk).reshape(b, s, h, qk_n)
    v = (c_kv @ blk.attn.w_uv).reshape(b, s, h, cfg32.v_head_dim)
    scale = (qk_n + cfg32.qk_rope_dim) ** -0.5
    with torch.no_grad():
        got = mla._attend_chunked(q_nope, q_rope, k_nope, k_rope, v, scale)
        want = torch.cat([
            mla._attend_dense(q_nope[:, :, i:i + 16], q_rope[:, :, i:i + 16],
                              k_nope[:, :, i:i + 16], k_rope,
                              v[:, :, i:i + 16], scale, torch.float32)
            for i in range(0, h, 16)], -1)
    assert got.shape == want.shape == (b, s, h * cfg32.v_head_dim)
    return {"s": s, "chunked_vs_dense_rel_l2": rel_l2(got, want)}


def capture_moe_input(prefill_step, params, tokens, max_len):
    """The (N, d) input of the first MoE layer in one prefill of the
    served model (``model.moe_apply`` wrapped for the call)."""
    from repro_torch.models import model

    seen = []
    orig = model.moe_apply

    def wrapped(p, cfg, x):
        if not seen:
            seen.append(x.reshape(-1, x.shape[-1]).clone())
        return orig(p, cfg, x)

    model.moe_apply = wrapped
    try:
        prefill_step(params, tokens, max_len=max_len)
    finally:
        model.moe_apply = orig
    return seen[0]


def moe_route_check(cfg, moe, xf) -> dict:
    """The card's ``_route`` at the served capacity factor over the served
    model's first MoE input ``xf`` (N, d): each (token, slot)'s position
    and keep flag against the reference's formula, a one-hot cumsum in
    token-major order computed in numpy on the host from the card's own
    expert ids: equal.  And the CPU's ``_route`` on the same inputs and
    router: the shares of expert ids and keep flags that agree (reported,
    not held: float32 matmuls on the two devices may split a near-tie
    differently)."""
    import types

    from repro_torch.models import moe as moe_mod

    ids, pos, keep, _, _, cap = moe_mod._route(moe, cfg, xf)
    ids_h = ids.cpu().numpy()
    nk = ids_h.size
    onehot = np.zeros((nk, cfg.n_experts), np.int64)
    onehot[np.arange(nk), ids_h] = 1
    ref_pos = (np.cumsum(onehot, 0) - onehot)[np.arange(nk), ids_h]
    ref_keep = ref_pos < cap
    keep_h = keep.cpu().numpy()
    pos_h = pos.cpu().numpy()
    assert np.array_equal(keep_h, ref_keep), "keep mask differs"
    assert np.array_equal(pos_h, np.where(ref_keep, ref_pos, 0)), (
        "positions differ")
    cpu_router = types.SimpleNamespace(router=moe.router.detach().cpu())
    ids_c, _, keep_c, _, _, cap_c = moe_mod._route(cpu_router, cfg,
                                                   xf.cpu())
    assert cap_c == cap
    return {"n_tokens": xf.shape[0], "capacity": cap,
            "dropped": int(nk - keep_h.sum()),
            "positions_equal": True,
            "cpu_ids_agree": float((ids_c.numpy() == ids_h).mean()),
            "cpu_keep_agree": float((keep_c.numpy() == keep_h).mean())}


def moe_dispatch_check(cfg, moe, xf) -> dict:
    """``_moe_apply_dense`` (float32, served capacity factor) over ``xf``
    (N, d) against a plain version on the same routing: each expert's
    kept tokens through its SwiGLU, weighted by their gates and added
    back per token, then the shared expert."""
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.layers import swiglu

    with torch.no_grad():
        got, _ = moe_mod._moe_apply_dense(moe, cfg, xf[None])
        ids, _, keep, gates, _, cap = moe_mod._route(moe, cfg, xf)
        token = torch.arange(ids.numel(), device=xf.device) // cfg.top_k
        want = torch.zeros_like(xf)
        for e in range(cfg.n_experts):
            sel = (ids == e) & keep
            t = token[sel]
            y = swiglu(xf[t], moe.w1[e], moe.w3[e], moe.w2[e])
            want.index_add_(0, t, y * gates[sel][:, None])
        if moe.shared is not None:
            sp = moe.shared
            want = want + swiglu(xf, sp.w1, sp.w3, sp.w2)
    return {"n_tokens": xf.shape[0], "capacity": cap,
            "n_experts": cfg.n_experts,
            "dropped": int(keep.numel() - int(keep.sum())),
            "rel_l2": rel_l2(got[0], want)}


def family_checks(dev, run, params, tokens, moe_in):
    """The whole-model checks of one family (see ``family_seed_checks``)
    at the served capacity factor (decode dropless), on the main path's
    weights and the first (B, S) of its prompts given in the run.
    DeepSeek-V3's run on a fresh model with FAMILY_DSV3_CHECK_EXPERTS
    routed experts instead (``params`` None: the caller frees the served
    one first), plus ``mla_layer0_check`` on the main path's prompt.  An
    MoE config's first MoE layer, upcast, also takes
    ``moe_dispatch_check`` on ``moe_in``.  Returns the row; raises on a
    gap out of bounds."""
    from repro_torch.models import init_params

    name, _, _, _, max_len, _, _, _, (cb, cs) = run
    host = torch.Generator().manual_seed(2)
    extra = {}
    if params is None:
        cfg = family_config(name, n_experts=FAMILY_DSV3_CHECK_EXPERTS)
        params = init_params(cfg, seed=0, device=dev)
        max_len = cs + 1
    else:
        cfg = params.cfg
    nxt = torch.randint(0, cfg.vocab_size, (cb,), generator=host).to(dev)
    readings, params32 = family_seed_checks(dev, cfg, params,
                                            tokens[:cb, :cs], nxt, max_len)
    del params
    if cfg.attn_type == "mla":
        extra = mla_layer0_check(params32.cfg, params32, tokens)
    dispatch = None
    if cfg.mlp_type == "moe":
        dispatch = moe_dispatch_check(params32.cfg, params32.layers[0].mlp,
                                      moe_in.float())
    del params32
    torch.cuda.empty_cache()
    f32, bf = readings["float32"], readings["bfloat16"]
    row = {"model": name, "check_prompt": [cb, cs],
           "capacity_factor": cfg.capacity_factor,
           "decode_capacity_factor": dropless(cfg).capacity_factor,
           "n_experts": cfg.n_experts, **readings,
           "bounds": {"float32_rel_l2": F32_MODEL_REL_L2,
                      "bfloat16_over_witness": FAMILY_BF16_OVER_FLOOR,
                      "decode_rtol_atol": DECODE_RTOL}}
    if extra:
        row["mla_layer0"] = extra
        assert extra["chunked_vs_dense_rel_l2"] <= F32_MODEL_REL_L2, extra
    if dispatch:
        row["moe_dispatch"] = dispatch
        assert dispatch["rel_l2"] <= F32_MODEL_REL_L2, dispatch
    assert f32["decode_vs_forward_rel_l2"] <= F32_MODEL_REL_L2, row
    assert f32["decode_vs_forward_allclose_5e-2"], row
    assert bf["decode_vs_forward_rel_l2"] <= (
        FAMILY_BF16_OVER_FLOOR * bf["forward_vs_f32_rel_l2"]), row
    if "flash_vs_plain_rel_l2" in f32:
        assert f32["flash_vs_plain_rel_l2"] <= F32_MODEL_REL_L2, row
        assert bf["flash_vs_plain_rel_l2"] <= (
            FAMILY_BF16_OVER_FLOOR * bf["plain_vs_f32_rel_l2"]), row
    return row


def family_flash_timing(cfg, params, tokens, errs) -> dict:
    """K7 at one family's layer-0 launch (the grouped call the model
    makes) against its plain version, timed beside its bound, its plain
    version and ``scaled_dot_product_attention`` on the KV heads repeated
    (with the window as a boolean mask where there is one; a dense mask
    keeps SDPA off its flash backend, so with a window SDPA's
    ``is_causal`` call at the same shape is timed too, as
    ``library_causal_ms``: the flash backend over the causal triangle,
    more work than the window leaves)."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention.ops import bh_layout

    q, k, v, n_rep = bh_layout(*lm_flash_args(cfg, params, tokens))
    window = cfg.sliding_window or None
    got = fa._flash_attention_grouped(q, k, v, n_rep, True, window)
    torch.cuda.synchronize()
    err = close_err(got, fa._flash_plain(q, k, v, True, window, n_rep=n_rep),
                    FLASH_TOL[q.dtype])
    errs.append(err)
    bms, by, work = flash_bound(q, k, window=window)
    kr, vr = k.repeat_interleave(n_rep, 0), v.repeat_interleave(n_rep, 0)
    s = q.shape[1]
    causal = lambda: F.scaled_dot_product_attention(  # noqa: E731
        q[None], kr[None], vr[None], is_causal=True)
    library = causal
    if window:
        idx = torch.arange(s, device=q.device)
        mask = ((idx[:, None] >= idx[None, :])
                & (idx[:, None] - idx[None, :] < window))
        library = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q[None], kr[None], vr[None], attn_mask=mask)
    return {
        "launch": {"bh": q.shape[0], "kv_heads": k.shape[0], "n_rep": n_rep,
                   "s": s, "hd": q.shape[2], "window": window,
                   "dtype": str(q.dtype)},
        "max_abs_err": err,
        "ms": time_ms(lambda: fa._launch_flash(q, k, v, True, window,
                                               n_rep)),
        "plain_ms": time_ms(lambda: fa._flash_plain(q, k, v, True, window,
                                                    n_rep=n_rep)),
        "bound_ms": bms, "bound_by": by, "work": work,
        "library_ms": time_ms(library),
        "library_causal_ms": time_ms(causal) if window else None,
    }


def phase_families(dev, flash_errs):
    """Phase 13: hymba-1.5b, granite-moe-3b-a800m and the cut
    deepseek-v3-671b through ``family_main_path``, ``family_checks`` and,
    for the two that run K7, ``family_flash_timing``.  Returns the
    ``{"families"}`` row and the K7 launches of the main paths (the count
    set to 0 just before each prefill, read just after)."""
    from repro_torch.launch.steps import make_prefill_step

    t_phase = time.perf_counter()
    row = {"card": smi_line(), "models": []}
    launches = 0
    for run in FAMILY_RUNS:
        t0 = time.perf_counter()
        cfg, params, tokens, main = family_main_path(dev, run)
        launches += main["k7_launches_per_prefill"]
        moe_in = None
        if cfg.mlp_type == "moe":
            moe_in = capture_moe_input(make_prefill_step(cfg, use_flash=True),
                                       params, tokens, run[4])
            main["moe_route"] = moe_route_check(cfg, params.layers[0].mlp,
                                                moe_in)
        if main["k7_launches_per_prefill"]:
            main["k7"] = family_flash_timing(cfg, params, tokens, flash_errs)
            main["k7_share_of_prefill"] = (
                main["k7"]["ms"] * main["k7_launches_per_prefill"]
                / (main["prefill_s"] * 1e3))
        log(json.dumps({"family": main}))
        if cfg.attn_type == "mla":  # its checks run on a smaller copy
            del params
            torch.cuda.empty_cache()
            params = None
        main["checks"] = family_checks(dev, run, params, tokens, moe_in)
        del params, tokens, moe_in
        torch.cuda.empty_cache()
        main["phase_s"] = time.perf_counter() - t0
        row["models"].append(main)
    row["phase_s"] = time.perf_counter() - t_phase
    return row, launches


def families_main() -> None:
    """``--families``: K7's parity cases and phase 13 alone."""
    from repro_torch.kernels import build

    dev = phase_environment()
    build.build(["flash_attention"])
    errs = []
    phase_flash_parity(dev, errs)
    row, launches = phase_families(dev, errs)
    log(json.dumps({"families": row}))
    log(json.dumps({"k7_launches": launches, "k7_max_abs_err": max(errs)}))
    print(json.dumps({"ok": True}), flush=True)


# ---------------------------------------------------------------------------
# phase 14: LM training
# ---------------------------------------------------------------------------

TRAIN_ARCH = "qwen3-4b"
# layers, d_model, vocab, dtype, tied head: uncut
TRAIN_SHAPE = (36, 2560, 151936, "bfloat16", False)
TRAIN_BATCH = 2
TRAIN_SEQ = 2048  # >= 2,048: loss_fn takes chunked_ce_loss
TRAIN_STEPS = 8  # timed, after one warm-up step (cut from 10 for phase 15 (f))
TRAIN_OPT = {"lr": 3e-4, "warmup_steps": 2, "total_steps": 10}
TRAIN_DET_OFF_STEPS = 1  # timed with deterministic algorithms off (cut from 2)
BF16_FLOPS_PER_S = 989e12  # H100 SXM dense bf16 (NVIDIA's data sheet)
TRAIN_CHECK_BATCH = (2, 32)  # (b): every family's smoke config, 8-bit
TRAIN_CHECK_STEPS = 2  # compression, for 2 steps
TRAIN_CHECK_LAYERS = 2  # (b): qwen3-4b at full width cut to 2 layers ...
TRAIN_CHECK_WIDE = (1, 256)  # ... over 1 x 256 tokens ...
TRAIN_CHECK_WIDE_STEPS = 3  # ... for 3 steps with 8-bit compression
TRAIN_GRAD_TOL = 1e-4  # relative L2, card against CPU, float32
# (d): the float32 first moments the codec entropy-codes: wq's of layer 0
# (10.5 M values; cut from all seven of its weights', 101 M values and ~30
# s of host encode and decode, to pay for phase 15 (g))
TRAIN_CODEC_MOMENTS = ("attn.wq",)
TRAIN_RESTART = {"archs": ("qwen3-4b", "granite-moe-3b-a800m"), "steps": 12,
                 "save_every": 4, "fail_at": (5,), "batch": 2, "seq": 64}
TRAIN_CLI = ["--arch", "qwen3-4b", "--smoke", "--steps", "20",
             "--ckpt-codec", "lossless"]


def train_cfg():
    from repro_torch.configs import get_config

    cfg = get_config(TRAIN_ARCH)
    shape = (cfg.n_layers, cfg.d_model, cfg.vocab_size, cfg.dtype,
             cfg.tie_embeddings)
    assert shape == TRAIN_SHAPE, shape
    return cfg


def train_batch(data_cfg, step, dev):
    from repro_torch.data.tokens import synth_batch

    return {k: torch.from_numpy(v).to(dev)
            for k, v in synth_batch(data_cfg, step).items()}


class StepSplit:
    """CUDA events around ``loss_fn`` and ``adamw_update`` as
    ``launch.steps`` calls them (its module names swapped for timed
    wrappers while installed): forward = the loss, backward = from the
    loss to the update (``autograd.grad``), optimizer = the update."""

    def __init__(self):
        self.marks = []
        self.peaks = []  # max_memory_allocated of each window

    def _peak(self) -> None:
        self.peaks.append(torch.cuda.max_memory_allocated())
        torch.cuda.reset_peak_memory_stats()

    def wrap(self, fn):
        def timed(*a, **kw):
            self._peak()
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            out = fn(*a, **kw)
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            self._peak()
            self.marks.append((ev, end))
            return out

        return timed

    def __enter__(self):
        from repro_torch.launch import steps

        self._saved = (steps.loss_fn, steps.adamw_update)
        steps.loss_fn = self.wrap(steps.loss_fn)
        steps.adamw_update = self.wrap(steps.adamw_update)
        return self

    def __exit__(self, *exc):
        from repro_torch.launch import steps

        steps.loss_fn, steps.adamw_update = self._saved

    def split_ms(self) -> dict:
        """The last step's forward / backward / optimizer ms."""
        (f0, f1), (o0, o1) = self.marks[-2:]
        return {"forward": f0.elapsed_time(f1),
                "backward": f1.elapsed_time(o0),
                "optimizer": o0.elapsed_time(o1)}

    def split_peaks(self) -> dict:
        """The last step's peak allocated bytes in its forward, its
        backward (the loss's end to the update) and its optimizer."""
        fwd, bwd, opt = self.peaks[-3:]
        return {"forward": fwd, "backward": bwd, "optimizer": opt}


def kernel_launch_counts() -> dict:
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan as ws

    return {"k7": fa.LAUNCHES["flash"], "k8": ws.LAUNCHES["wkv6"]}


def reset_kernel_launches() -> None:
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan as ws

    fa.reset_launches()
    ws.reset_launches()


def stats(xs) -> dict:
    return {"median": float(np.median(xs)), "min": float(min(xs)),
            "max": float(max(xs))}


def train_main_path(dev):
    """(a): qwen3-4b at full width and depth (bf16, seeded weights),
    ``make_train_step(cfg, AdamWConfig(lr=3e-4, warmup_steps=2,
    total_steps=10), remat="full")`` on ``synth_batch`` of 2 x 2,048: one
    warm-up step, then TRAIN_STEPS timed steps on the host clock (each
    ends in a synchronise), split by CUDA events; then
    TRAIN_DET_OFF_STEPS with deterministic algorithms off (their cost).  K7's and K8's counts are set to 0 just
    before and read just after: training launches neither.  Returns the
    row and the state (for (d))."""
    from repro_torch.data.tokens import TokenDataConfig
    from repro_torch.launch import steps
    from repro_torch.launch.train import build_state
    from repro_torch.optim.adamw import AdamWConfig

    cfg = train_cfg()
    opt_cfg = AdamWConfig(**TRAIN_OPT)
    data = TokenDataConfig(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=0)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    state = build_state(cfg, opt_cfg, 0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in state["params"].parameters())
    step_fn = steps.make_train_step(cfg, opt_cfg, remat="full")
    params, opt = state.pop("params"), state.pop("opt")  # the step's only
    losses, norms, step_s, splits, peaks = [], [], [], [], []
    reset_kernel_launches()
    with StepSplit() as split:
        for step in range(TRAIN_STEPS + 1):
            batch = train_batch(data, step, dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt, m = step_fn(params, opt, batch)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
            tail = torch.cuda.max_memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            peaks.append(max(split.peaks[-4:] + [tail]))
            if step == 0:
                warm_s = dt
                continue
            step_s.append(dt)
            splits.append(split.split_ms())
            split_peaks = split.split_peaks()
    launches = kernel_launch_counts()
    assert launches == {"k7": 0, "k8": 0}, launches
    assert all(np.isfinite(losses)) and all(np.isfinite(norms)), (
        losses, norms)
    assert np.mean(losses[-3:]) < losses[0], losses
    det_off = []
    saved = steps.deterministic_algorithms
    steps.deterministic_algorithms = contextlib.nullcontext
    try:
        for step in range(TRAIN_DET_OFF_STEPS):
            batch = train_batch(data, TRAIN_STEPS + 1 + step, dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt, m = step_fn(params, opt, batch)
            torch.cuda.synchronize()
            det_off.append(time.perf_counter() - t0)
            assert np.isfinite(float(m["loss"]))
    finally:
        steps.deterministic_algorithms = saved
    tokens = TRAIN_BATCH * TRAIN_SEQ
    med = float(np.median(step_s))
    profile = train_step_profile(
        lambda: step_fn(params, opt, train_batch(data, 0, dev)), med)
    row = {
        "model": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
        "vocab": cfg.vocab_size, "params": n_params, "dtype": cfg.dtype,
        "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "remat": "full",
        "optimizer": TRAIN_OPT, "init_s": init_s, "warmup_step_s": warm_s,
        "step_s": stats(step_s), "tokens_per_s": tokens / med,
        "split_ms": {k: stats([s[k] for s in splits]) for k in splits[0]},
        "max_memory_allocated": max(peaks[1:]),
        "max_memory_allocated_warmup": peaks[0],
        "max_memory_allocated_by_part": split_peaks,
        "profile": profile,
        "mfu": 6 * n_params * tokens / med / BF16_FLOPS_PER_S,
        "losses": losses, "grad_norms": norms,
        "deterministic_off_step_s": stats(det_off),
        "deterministic_cost": med / float(np.median(det_off)) - 1,
        "k7_launches": launches["k7"], "k8_launches": launches["k8"],
    }
    return row, {"params": params, "opt": opt}


def train_step_profile(step, step_s: float) -> dict:
    """``torch.profiler`` over one train step: the device's kernel ms and
    its busy share of the unprofiled step (``step_s``), kernel launches,
    and the kernels with the most device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    device_us = launches = 0
    kernels = []
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            device_us += e.self_device_time_total
            kernels.append((e.self_device_time_total / 1e3, e.count,
                            e.key[:80]))
        if e.key in ("cudaLaunchKernel", "cuLaunchKernel", "cuLaunchKernelEx",
                     "cudaLaunchKernelExC"):
            launches += e.count
    kernels.sort(reverse=True)
    return {"device_ms": device_us / 1e3,
            "busy_share": device_us / 1e6 / step_s,
            "launches": launches,
            "top_kernels": [{"ms": ms, "count": n, "name": k}
                            for ms, n, k in kernels[:12]]}


def codec_leaves(state) -> dict:
    """(d)'s leaves, copied to the host: layer 0's seven bf16 weights, the
    float32 first moments after (a)'s steps of TRAIN_CODEC_MOMENTS among
    them, and the embedding."""
    lm = state["params"]
    out = {}
    for name, p in lm.layers[0].named_parameters():
        if p.dim() == 2:
            out[f"layers.0.{name}"] = p.detach().cpu()
            if name in TRAIN_CODEC_MOMENTS:
                out[f"m/layers.0.{name}"] = (
                    state["opt"]["m"][f"layers.0.{name}"].cpu())
    out["embed"] = lm.embed.detach().cpu()
    return out


def train_grads(cfg, params, batch):
    """(loss, {name: gradient}) with remat "full", as the train step
    computes them."""
    from repro_torch.launch.steps import (
        deterministic_algorithms,
        loss_and_grads,
    )

    with deterministic_algorithms():
        loss, grads = loss_and_grads(cfg, params, batch, remat="full")
    return float(loss.detach()), grads


def train_card_vs_cpu(dev):
    """(b): card against CPU, float32, TF32 off, 8-bit gradient
    compression, from the same weights and batches.  Every family's smoke
    config for 2 steps: each step's loss and every gradient leaf at 1e-4
    relative L2 (a leaf past it is held to a float64 run instead: the
    card no farther from it than the CPU, plus 1e-4 — RWKV6's token-shift
    mix ``mu``, whose gradient sums terms that cancel, reads ~1e-3 apart
    between two float32 runs); then the update (compression and AdamW)
    applied on each device to the CPU's gradients, bit for bit equal on
    both (parameters, moments, error feedback), which keeps the two in
    lockstep.  (The
    parameters after a whole step on each device's own gradients cannot
    be held to 1e-4: a leaf whose gradient is zero but for rounding, as
    a key bias is under softmax's shift invariance, moves by lr |noise| /
    (|noise| + eps) in Adam's first steps.)  Then qwen3-4b at full width
    cut to 2 layers over 1 x 256 tokens for 3 steps: loss and gradients
    each step, the update made on the card from the CPU's gradients and
    its parameters copied to the CPU (AdamW over 0.98 B float32
    parameters takes the host ~10 s a step; the smoke configs hold the
    update's arithmetic)."""
    import copy
    import dataclasses

    from repro_torch.configs import ARCHITECTURES, get_config
    from repro_torch.data.tokens import TokenDataConfig
    from repro_torch.models import init_params
    from repro_torch.optim.adamw import (
        AdamWConfig,
        adamw_update,
        init_opt_state,
    )
    from repro_torch.optim.compression import (
        GradCompressionConfig,
        compress_gradients,
        init_error_feedback,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    assert torch.get_float32_matmul_precision() == "highest"
    cpu = torch.device("cpu")
    opt_cfg = AdamWConfig(lr=3e-4, warmup_steps=1, total_steps=10)
    gc = GradCompressionConfig(bits=8)

    def fresh(params):
        """A train state with zero moments and error feedback, on the
        parameters' device."""
        opt = init_opt_state(params)
        opt["ef"] = init_error_feedback(params)
        return {"params": params, "opt": opt}

    def gaps(a: dict, b: dict) -> dict:
        """Each leaf's relative L2 gap (absolute where the CPU's leaf is
        0, as an unused parameter's gradient is)."""
        out = {}
        for n, want in b.items():
            got = a[n].detach().cpu().float()
            want = want.detach().float()
            den = float(want.norm())
            out[n] = float((got - want).norm()) / (den if den else 1.0)
        return out

    def unequal(a: dict, b: dict) -> list:
        return [n for n in b if not torch.equal(a[n].detach().cpu(),
                                                b[n].detach())]

    def update(side, grads, d):
        g = {n: t.to(d) for n, t in grads.items()}
        g, ef = compress_gradients(gc, g, side["opt"]["ef"])
        side["params"], side["opt"], _ = adamw_update(
            opt_cfg, side["params"], g, side["opt"])
        side["opt"]["ef"] = ef

    def witness(cfg, params, batch, g_c, g_h, leaves) -> dict:
        """For leaves past the tolerance: each gradient's gap to a float64
        run on the CPU (the model's float32 casts stay float32), the card's
        and the CPU's."""
        from repro_torch.models.moe import MoE

        c64 = dataclasses.replace(cfg, dtype="float64")
        p64 = copy.deepcopy(params).double()
        for mod in p64.modules():  # the router is float32 in any model
            if isinstance(mod, MoE):
                mod.router.data = mod.router.data.float()
        _, g64 = train_grads(c64, p64, batch)
        return {n: {"card": rel(g_c[n], g64[n]), "cpu": rel(g_h[n], g64[n])}
                for n in leaves}

    def rel(a, b) -> float:
        b = b.detach().double()
        return float((a.detach().cpu().double() - b).norm() / b.norm())

    def run(cfg, steps, batch_shape, cpu_update):
        weights = init_params(cfg, 0, device=dev)  # drawn on the card
        host_weights = copy.deepcopy(weights).to(cpu)
        card = fresh(weights)
        host = fresh(host_weights) if cpu_update else {
            "params": host_weights}
        data = TokenDataConfig(cfg.vocab_size, batch_shape[1],
                               batch_shape[0], seed=0)
        out = {"losses_card": [], "losses_cpu": [], "grad_rel_l2": [],
               "worst_leaf": [], "witness": [], "unequal_after_update": [],
               "card_s": 0.0, "cpu_s": 0.0}
        for i in range(steps):
            t0 = time.perf_counter()
            loss_c, g_c = train_grads(cfg, card["params"],
                                      train_batch(data, i, dev))
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            loss_h, g_h = train_grads(cfg, host["params"],
                                      train_batch(data, i, cpu))
            t2 = time.perf_counter()
            out["card_s"] += t1 - t0
            out["cpu_s"] += t2 - t1
            out["losses_card"].append(loss_c)
            out["losses_cpu"].append(loss_h)
            by_leaf = gaps(g_c, g_h)
            leaf = max(by_leaf, key=by_leaf.get)
            out["grad_rel_l2"].append(by_leaf[leaf])
            out["worst_leaf"].append(leaf)
            past = [n for n, x in by_leaf.items() if x > TRAIN_GRAD_TOL]
            if past:
                out["witness"].append(witness(cfg, host["params"],
                                              train_batch(data, i, cpu),
                                              g_c, g_h, past))
            del g_c
            update(card, g_h, dev)
            if not cpu_update:
                for p, q in zip(host["params"].parameters(),
                                card["params"].parameters()):
                    p.copy_(q)
                continue
            update(host, g_h, cpu)
            bad = unequal(dict(card["params"].named_parameters()),
                          dict(host["params"].named_parameters()))
            for key in ("m", "v", "ef"):
                bad += [f"{key}/{n}" for n in unequal(card["opt"][key],
                                                      host["opt"][key])]
            out["unequal_after_update"].append(bad)
        out["loss_rel"] = max(abs(a - b) / abs(b) for a, b in zip(
            out["losses_card"], out["losses_cpu"]))
        return out

    rows = [{"model": name, **run(get_config(name).smoke(),
                                  TRAIN_CHECK_STEPS, TRAIN_CHECK_BATCH, True)}
            for name in sorted(ARCHITECTURES)]
    wide = dataclasses.replace(get_config(TRAIN_ARCH),
                               n_layers=TRAIN_CHECK_LAYERS, dtype="float32")
    wide_row = {
        "model": f"{TRAIN_ARCH} x {TRAIN_CHECK_LAYERS} layers, float32",
        "tokens": TRAIN_CHECK_WIDE,
        **run(wide, TRAIN_CHECK_WIDE_STEPS, TRAIN_CHECK_WIDE, False),
    }
    for row in (*rows, wide_row):
        assert row["loss_rel"] <= TRAIN_GRAD_TOL, row
        # a leaf past the tolerance passes only when the card is no
        # farther from the float64 gradient than the CPU is (+ the
        # tolerance): its float32 gradient is that ill-conditioned
        for w in row["witness"]:
            for n, gaps in w.items():
                assert gaps["card"] <= gaps["cpu"] + TRAIN_GRAD_TOL, row
        assert not any(row["unequal_after_update"]), row
    return {"grad_bits": gc.bits, "smoke": rows, "wide": wide_row}


def train_restart(dev, root):
    """(c): ``TrainLoop`` with ``CheckpointManager(codec="lossless")``
    over qwen3-4b's and granite-moe-3b-a800m's smoke configs on the card:
    12 steps (remat "full", the batch of step k ``synth_batch(k)``), a
    checkpoint every 4, preempted at step 5 (cut from 5 and 9: each
    restart decodes a checkpoint on the host, ~10 s); the final state
    equal
    to an uninterrupted run's bit for bit, every loss equal, and (for the
    first model) the last checkpoint, in the reference's layout, decoded
    equal to the final state.  Deterministic-algorithm alerts other than
    cuBLAS's are recorded."""
    import warnings

    from repro_torch.checkpoint import (
        CheckpointConfig,
        CheckpointManager,
        load_checkpoint,
    )
    from repro_torch.configs import get_config
    from repro_torch.convert import (
        train_state_from_arrays,
        train_state_to_arrays,
    )
    from repro_torch.core.tensor_codec import flatten_pytree
    from repro_torch.data.tokens import TokenDataConfig
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import build_state
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime import PreemptionSchedule, TrainLoop

    spec = TRAIN_RESTART
    rows = []
    for name in spec["archs"]:
        cfg = get_config(name).smoke()
        opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=2,
                              total_steps=spec["steps"])
        data = TokenDataConfig(cfg.vocab_size, spec["seq"], spec["batch"])
        raw = make_train_step(cfg, opt_cfg, remat="full")

        def step_fn(state, step):
            state = train_state_from_arrays(cfg, state, dev)
            p, o, m = raw(state["params"], state["opt"],
                          train_batch(data, step, dev))
            return {"params": p, "opt": o}, {k: float(v)
                                             for k, v in m.items()}

        finals, logs, times = {}, {}, {}
        for run, fail_at in (("straight", ()), ("preempted",
                                                spec["fail_at"])):
            mgr = CheckpointManager(CheckpointConfig(
                os.path.join(root, name, run), codec="lossless"), device=dev)
            loop = TrainLoop(step_fn, mgr, save_every=spec["save_every"],
                             preemption=PreemptionSchedule(fail_at=fail_at))
            t0 = time.perf_counter()
            with warnings.catch_warnings(record=True) as alerts:
                warnings.simplefilter("always")
                finals[run] = loop.run(build_state(cfg, opt_cfg, 0,
                                                   device=dev),
                                       spec["steps"])
            torch.cuda.synchronize()
            times[run] = time.perf_counter() - t0
            logs[run] = {m["step"]: m["loss"] for m in loop.metrics_log}
            restarts = loop.restarts
        a = flatten_pytree(finals["straight"])
        b = flatten_pytree(finals["preempted"])
        assert sorted(a) == sorted(b)
        unequal = [k for k in a if not (a[k].dtype == b[k].dtype
                                        and torch.equal(a[k], b[k]))]
        step, undecoded, decode_s = spec["steps"], [], None
        if name == spec["archs"][0]:  # ~10 s of host decode a model
            t0 = time.perf_counter()
            saved, step = load_checkpoint(
                os.path.join(root, name, "preempted"), device=dev)
            decode_s = time.perf_counter() - t0
            c = flatten_pytree(saved)
            ref_layout = flatten_pytree(
                train_state_to_arrays(finals["preempted"]))
            undecoded = [k for k in ref_layout
                         if not torch.equal(c[k].cpu(), ref_layout[k])]
        row = {"model": name, "restarts": restarts, "leaves": len(a),
               "unequal_leaves": unequal,
               "losses_equal": logs["straight"] == logs["preempted"],
               "checkpoint_step": step, "undecoded_leaves": undecoded,
               "straight_s": times["straight"],
               "preempted_s": times["preempted"], "decode_s": decode_s,
               "alerts": sorted({str(w.message)[:160] for w in alerts})}
        log(json.dumps({"train_restart": row}))
        assert restarts == len(spec["fail_at"]), row
        assert not unequal and row["losses_equal"], row
        assert step == spec["steps"] and not undecoded, row
        rows.append(row)
    return rows


def train_codec(leaves, dev) -> dict:
    """(d): ``compress_tensors`` lossless on (a)'s trained layer 0 (seven
    bf16 weights, ~101 M values; the codec passes bf16 through, ROADMAP
    R9), the float32 first moments of TRAIN_CODEC_MOMENTS (entropy-coded)
    and the bf16 embedding; exact decode; bytes against raw, host
    seconds."""
    from repro_torch.core.tensor_codec import (
        compress_tensors,
        decompress_tensors,
    )

    groups = {
        "layer0_bf16": {k: v for k, v in leaves.items()
                        if k.startswith("layers.")},
        "layer0_m_f32": {k: v for k, v in leaves.items()
                         if k.startswith("m/")},
        "embed_bf16": {"embed": leaves["embed"]},
    }
    out = {}
    for name, tree in groups.items():
        t0 = time.perf_counter()
        comp = compress_tensors(tree, device=dev)
        blob = comp.to_bytes()
        t1 = time.perf_counter()
        back = decompress_tensors(type(comp).from_bytes(blob))
        t2 = time.perf_counter()
        exact = all(back[k].dtype == v.dtype and torch.equal(back[k], v)
                    for k, v in tree.items())
        raw = sum(v.numel() * v.element_size() for v in tree.values())
        out[name] = {
            "values": sum(v.numel() for v in tree.values()),
            "raw_bytes": raw, "payload_bytes": len(blob),
            "ratio": len(blob) / raw, "clusters": comp.n_clusters,
            "encode_s": t1 - t0, "decode_s": t2 - t1, "exact": exact,
        }
        assert exact, name
    return out


def train_cli_start(root):
    """(e): ``python -m repro_torch.launch.train`` on qwen3-4b's smoke
    config, 20 steps with lossless checkpoints, started in the background
    (it shares the card with (b)-(d), which are not timed)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    argv = [sys.executable, "-m", "repro_torch.launch.train", *TRAIN_CLI,
            "--ckpt-dir", os.path.join(root, "cli")]
    return subprocess.Popen(argv, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def train_cli_result(proc, root) -> dict:
    out, _ = proc.communicate(timeout=300)
    lines = out.strip().splitlines()
    from repro_torch.checkpoint import latest_step

    row = {"rc": proc.returncode, "tail": lines[-4:],
           "latest_step": latest_step(os.path.join(root, "cli"))}
    assert proc.returncode == 0, out
    assert any(ln.startswith("final loss") for ln in lines), out
    assert row["latest_step"] == 20, row
    return row


def phase_train(dev):
    """Phase 14: LM training, (a)-(e), in one ``{"train": ...}`` row with
    the card's name and power limit."""
    import tempfile

    t_phase = time.perf_counter()
    row = {"card": smi_line()}
    clock = {}
    torch.cuda.empty_cache()  # (a) needs ~70 GB in one piece or another
    t0 = time.perf_counter()
    row["main"], state = train_main_path(dev)
    log(json.dumps({"train_main": row["main"]}))
    leaves = codec_leaves(state)
    del state
    torch.cuda.empty_cache()
    clock["a"] = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as root:
        cli = train_cli_start(root)
        try:
            t0 = time.perf_counter()
            row["card_vs_cpu"] = train_card_vs_cpu(dev)
            log(json.dumps({"train_card_vs_cpu": row["card_vs_cpu"]}))
            clock["b"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            row["restart"] = train_restart(dev, root)
            clock["c"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            row["codec"] = train_codec(leaves, dev)
            clock["d"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            row["cli"] = train_cli_result(cli, root)
            clock["e_wait"] = time.perf_counter() - t0
        finally:
            if cli.poll() is None:
                cli.kill()
                cli.wait()
    row["part_s"] = clock
    row["phase_s"] = time.perf_counter() - t_phase
    return row


def train_main() -> None:
    """``--train``: phase 14 alone."""
    dev = phase_environment()
    row = phase_train(dev)
    log(json.dumps({"train": row}))
    print(json.dumps({"ok": True}), flush=True)


# ---------------------------------------------------------------------------
# phase 15: the mesh
# ---------------------------------------------------------------------------

MESH_RANKS = 4
# (a) granite-moe-3b-a800m uncut, on two meshes tensor-parallel on both,
# and with whole parameters on every rank on (1, 4) (the path of an MoE
# model that tensor parallelism does not cut); each run's warm-up prefill
# is checked, and the "timed" mesh's tensor-parallel run times a second
# one (cut from all three runs).  4 x 512 tokens (cut from phase 13's 4 x
# 2,048 to pay for (i))
MESH_MOE = {"arch": "granite-moe-3b-a800m", "meshes": ((1, 4), (2, 2)),
            "whole_meshes": ((1, 4),), "timed": (1, 4),
            "batch": 4, "prompt": 512, "max_len": 544}
# (b) hymba-1.5b at full width cut to 2 layers, phase 13's prompts (the
# ring buffer needs window | S): 25 / 5 heads pad to 36 / 6 on (1, 4)
MESH_HYMBA = {"arch": "hymba-1.5b", "layers": 2, "mesh": (1, 4),
              "batch": 2, "prompt": 4096, "max_len": 4128, "pads": (6, 6)}
# (c) the wire train step: qwen3-4b at full width cut to 2 layers (phase
# 14's (b) cut), 4-bit codes, 1 x 1,024 tokens a rank, 2 steps (cut from
# 3 to pay for (f))
MESH_WIRE = {"arch": "qwen3-4b", "layers": 2, "mesh": (4, 1), "bits": 4,
             "seq": 1024, "steps": 2,
             "opt": {"lr": 3e-4, "warmup_steps": 1, "total_steps": 3}}
MESH_CKPT_ARCH = "qwen3-4b"  # (d): its smoke config
# (e) tensor-parallel serving of qwen3-4b, seeded weights cut leaf by leaf
# on each rank (``shard_params``): (name, mesh, layers (None: all 36),
# dtype, batch).  A 4 x 2,048 prefill (the float32 run's 1 x 2,048, cut
# from 4 rows to pay for (h)), then 2 decode steps (cut from 8 to pay for
# (f)) fed the one-process run's greedy tokens; held to the one-process
# prefill and decode of the same weights (bf16: within 1.5x the bf16
# floor read against float32; float32: 1e-4 relative L2)
MESH_TP = {"arch": "qwen3-4b", "prompt": 2048, "max_len": 2056,
           "steps": 2, "warm_prompt": 64,
           "runs": (("full", (1, 4), None, "bfloat16", 4),
                    ("cut4", (2, 2), 4, "bfloat16", 4),
                    ("f32", (1, 4), 2, "float32", 1))}
MESH_TP_F32_TOL = 1e-4
# (g) tensor-parallel serving of the recurrent families, seeded weights cut
# leaf by leaf on each rank as in (e): (name, arch, mesh, layers (None:
# all), dtype, batch, prompt, max_len), each a prefill then MESH_TP's
# decode steps fed the one-process run's greedy tokens.  rwkv6-1.6b uncut
# and hymba-1.5b at full width cut to 8 of its 32 layers, bf16 on (1, 4):
# a 4 x 2,048 prefill (K8 on each rank's 8 heads) and a 2 x 4,096 one (K7
# on each rank's 9 padded heads, one KV head each, with the window of
# 2,048, which binds; decode then writes the ring of 2,048 slots, cut 512
# a rank); float32 runs of both cut to 2 layers (Hymba at 1 x 4,096, its
# ring cut over time); rwkv6 bf16 cut to 4 layers on (2, 2) (ZeRO-3 over
# data).  Held to one process of the port as (e) is.  "launch": the
# kernel each bf16 (1, 4) run's prefill launches once a layer a rank, and
# the shape the spy must see (K8: r's (B, S, H, hd); K7: q's and k's
# heads, n_rep, S, window)
MESH_RECURRENT = {
    "runs": (("rwkv6", "rwkv6-1.6b", (1, 4), None, "bfloat16", 4, 2048,
              2056),
             ("hymba", "hymba-1.5b", (1, 4), 8, "bfloat16", 2, 4096, 4128),
             ("rwkv6_f32", "rwkv6-1.6b", (1, 4), 2, "float32", 2, 256, 264),
             ("hymba_f32", "hymba-1.5b", (1, 4), 2, "float32", 1, 4096,
              4104),
             ("rwkv6_2x2", "rwkv6-1.6b", (2, 2), 4, "bfloat16", 4, 512,
              520)),
    "launch": {"rwkv6": ("wkv6", [4, 2048, 8, 64]),
               "hymba": ("flash", [18, 18, 1, 4096, 2048])},
}
# (h) tensor-parallel serving of deepseek-v3-671b at full width, cut as
# phase 13 cuts it (FAMILY_DSV3_CUT: 1 dense and 1 MoE layer, the MTP
# head carried), seeded weights cut leaf by leaf on each rank as in (e):
# (name, routed experts (None: all 256), mesh, dtype, batch, prompt,
# max_len, dropless), each a prefill then MESH_TP's decode steps fed the
# one-process run's greedy tokens.  dsv3: bf16 on (1, 4), 32 of 128 MLA
# heads and 64 of 256 experts a rank, 1 x 4,096 (the chunked MLA route;
# at B = 1 the default capacity routes as one process does), the latent
# cache of 4,112 cut 1,028 slots a rank (positions 4,096-4,097 on rank
# 3's); its bf16 floor is read on the FAMILY_DSV3_CHECK_EXPERTS copy
# (float32 beside bf16 at 256 experts would need ~88 GB) at the same
# prompt.  dsv3_f32: that copy in float32, 1 x 256 (the dense route).
# dsv3_2x2: that copy in bf16 on (2, 2), ZeRO-3 over data, 2 x 512,
# dropless (``dropless``): at the default factor the capacity is taken per
# data shard, so other tokens drop than in one process
MESH_DSV3 = {
    "arch": "deepseek-v3-671b",
    "runs": (("dsv3", None, (1, 4), "bfloat16", 1, 4096, 4112, False),
             ("dsv3_f32", FAMILY_DSV3_CHECK_EXPERTS, (1, 4), "float32", 1,
              256, 264, False),
             ("dsv3_2x2", FAMILY_DSV3_CHECK_EXPERTS, (2, 2), "bfloat16", 2,
              512, 520, True)),
}
MESH_TIMEOUT_S = 600  # a rank stuck in a collective fails the phase


def mesh_backend(ranks: int, cards: int) -> str:
    """NCCL refuses two ranks on one card ("duplicate GPU"): ranks that
    share a card talk through gloo carrying CUDA tensors; one card a rank
    takes NCCL."""
    return "gloo" if ranks > cards else "nccl"


def mesh_prompt(cfg, batch, prompt, dev):
    """Phase 13's seeded prompts."""
    host = torch.Generator().manual_seed(1)
    return torch.randint(0, cfg.vocab_size, (batch, prompt),
                         generator=host).to(dev)


def sha(t: torch.Tensor) -> str:
    import hashlib

    t = t.detach().contiguous()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()


def ep_spy(records, xs):
    """``_moe_ep_partial`` wrapped where tensor-parallel serving calls it
    (``models.model``) and where ``moe_apply`` reaches it under a mesh
    (``models.moe``, through ``_moe_apply_ep``): after each call, the
    (token, slot) ids this rank dropped (``_ep_route`` on its rows, the function the
    dispatch ran) and a hash of the layer's whole input (the ranks' rows
    gathered over ``data``); ``xs`` keeps those inputs when it is a list.
    Returns a function that puts the originals back."""
    import torch.nn.functional as F

    from repro_torch.models import model as model_mod
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.sharding import all_gather, axis_index

    orig = model_mod._moe_ep_partial

    def spy(p, cfg, x, mesh, *args, **kw):
        out = orig(p, cfg, x, mesh, *args, **kw)
        bl, s, d = x.shape
        e_pad, e_loc, cap = moe_mod._ep_layout(cfg, bl, s, mesh)
        di = axis_index("data", mesh)
        lo = axis_index("model", mesh) * e_loc
        router = F.pad(p.router, (0, e_pad - cfg.n_experts))
        _, _, mine, keep, _ = moe_mod._ep_route(cfg, x.reshape(-1, d), router,
                                                e_pad, lo, e_loc, cap)
        drop = torch.nonzero(mine & ~keep)[:, 0] + di * bl * s * cfg.top_k
        whole = all_gather(x, "data", dim=0, mesh=mesh)
        records.append({"dropped": drop.cpu().numpy(), "x": sha(whole),
                        "cap": cap})
        if xs is not None:
            xs.append(whole)
        return out

    model_mod._moe_ep_partial = spy
    moe_mod._moe_ep_partial = spy

    def restore():
        model_mod._moe_ep_partial = orig
        moe_mod._moe_ep_partial = orig

    return restore


def mesh_granite(dev, rank, root, cfg, tokens, shape, whole=False) -> dict:
    """(a) on one mesh, tensor-parallel (each rank its shards of the
    seeded weights, ``shard_params``) or, with ``whole``, with the whole
    seeded model on every rank (``init_params``; whole activations, the
    MoE through ``moe_apply``'s expert-parallel dispatch): a warm-up
    prefill (its dropped sets recorded), then, on ``MESH_MOE["timed"]``'s
    tensor-parallel run, a timed one, K7's count set to 0 before each and
    read after; rank 0 replays each MoE layer's
    routing on the captured inputs with the dense ``_route``, per data
    shard, and holds the ranks' dropped sets, together, equal to it."""
    import torch.distributed as dist

    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.shardings import shard_params
    from repro_torch.launch.steps import make_prefill_step, whole_logits
    from repro_torch.models import init_leaves, init_params
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.sharding import logical_sharding, single_pod_rules

    tag = f"{shape[0]}x{shape[1]}" + ("_whole" if whole else "")
    mesh = make_host_mesh(*shape, device=dev)
    if whole:
        params = init_params(cfg, 0, dev)
    else:
        params = shard_params(cfg, init_leaves(cfg, 0, dev), mesh, dev)
    step = make_prefill_step(cfg, use_flash=True)
    records, xs = [], [] if rank == 0 else None
    restore = ep_spy(records, xs)
    row = {"mesh": list(shape), "params": "whole" if whole else "shards"}
    try:
        with logical_sharding(mesh, single_pod_rules()):
            fa.reset_launches()
            t0 = time.perf_counter()
            logits, _ = step(params, tokens, max_len=MESH_MOE["max_len"])
            torch.cuda.synchronize()
            row["warm_prefill_s"] = time.perf_counter() - t0
            row["k7_launches_warm"] = fa.LAUNCHES["flash"]
    finally:
        restore()
    row["k7_launches"] = row["k7_launches_warm"]
    if tuple(shape) == MESH_MOE["timed"] and not whole:
        with logical_sharding(mesh, single_pod_rules()):
            fa.reset_launches()
            t0 = time.perf_counter()
            logits, _ = step(params, tokens, max_len=MESH_MOE["max_len"])
            torch.cuda.synchronize()
            row["prefill_s"] = time.perf_counter() - t0
            row["k7_launches"] = fa.LAUNCHES["flash"]
    with logical_sharding(mesh, single_pod_rules()):
        logits = whole_logits(cfg, logits, tokens.shape[0])
    del params
    assert row["k7_launches"] == row["k7_launches_warm"] == cfg.n_layers, row
    assert logits.shape == (tokens.shape[0], cfg.vocab_size)
    assert bool(torch.isfinite(logits).all()), "EP prefill not finite"
    assert len(records) == cfg.n_layers, (tag, len(records))
    np.savez(os.path.join(root, f"drop_{tag}_{rank}.npz"),
             *[r["dropped"] for r in records])
    with open(os.path.join(root, f"xhash_{tag}_{rank}.json"), "w") as fh:
        json.dump([r["x"] for r in records], fh)
    row["logits"] = sha(logits)
    if rank == 0:
        torch.save(logits.cpu(), os.path.join(root, f"granite_{tag}.pt"))
    dist.barrier()
    if rank != 0:
        return row
    # the replay: one process, the dense routing per data shard, over
    # the seeded routers (whole on every rank)
    routers = [types.SimpleNamespace(router=t) for n, t in
               init_leaves(cfg, 0, dev) if n.endswith(".mlp.router")]
    drops = [np.load(os.path.join(root, f"drop_{tag}_{r}.npz"))
             for r in range(MESH_RANKS)]
    hashes = [json.load(open(os.path.join(root, f"xhash_{tag}_{r}.json")))
              for r in range(MESH_RANKS)]
    assert all(h == hashes[0] for h in hashes), "ranks' MoE inputs differ"
    b, s = tokens.shape
    nb = shape[0]
    bl = b // nb
    n_dropped = []
    for i, x in enumerate(xs):
        got = np.sort(np.concatenate([d[f"arr_{i}"] for d in drops]))
        want = []
        for di in range(nb):
            xf = x[di * bl:(di + 1) * bl].reshape(bl * s, -1)
            _, _, keep, _, _, cap = moe_mod._route(routers[i], cfg, xf)
            assert cap == records[i]["cap"], (cap, records[i]["cap"])
            want.append(torch.nonzero(~keep)[:, 0].cpu().numpy()
                        + di * bl * s * cfg.top_k)
        want = np.sort(np.concatenate(want))
        assert np.array_equal(got, want), (tag, i, got.size, want.size)
        n_dropped.append(int(got.size))
    row["dropped_per_layer"] = n_dropped
    row["capacity"] = records[0]["cap"]
    row["dropped_equal_replay"] = True
    return row


def mesh_hymba(dev, rank, root) -> dict:
    """(b): Hymba's 2-layer prefill under (1, 4): its heads padded to 36 /
    6, K7 launched at 36 query heads over 6 KV heads (a spy records each
    launch's shape)."""
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import attention, init_params
    from repro_torch.models.sharding import logical_sharding, single_pod_rules

    h = MESH_HYMBA
    cfg = family_config(h["arch"], n_layers=h["layers"])
    params = init_params(cfg, seed=0, device=dev)
    tokens = mesh_prompt(cfg, h["batch"], h["prompt"], dev)
    mesh = make_host_mesh(*h["mesh"], device=dev)
    seen = []
    orig = fa._launch_flash

    def spy(q, k, v, causal=True, window=None, n_rep=1):
        seen.append([q.shape[0], k.shape[0], n_rep, q.shape[1], window])
        return orig(q, k, v, causal, window, n_rep)

    fa._launch_flash = spy
    try:
        with logical_sharding(mesh, single_pod_rules()):
            pads = attention._head_padding(cfg)
            fa.reset_launches()
            t0 = time.perf_counter()
            logits, _ = make_prefill_step(cfg, use_flash=True)(
                params, tokens, max_len=h["max_len"])
            torch.cuda.synchronize()
            prefill_s = time.perf_counter() - t0
            launches = fa.LAUNCHES["flash"]
    finally:
        fa._launch_flash = orig
    assert tuple(pads) == h["pads"], pads
    kv, rep = pads
    want = [h["batch"] * kv * rep, h["batch"] * kv, rep, h["prompt"],
            cfg.sliding_window]
    assert launches == cfg.n_layers and all(sh_ == want for sh_ in seen), seen
    assert bool(torch.isfinite(logits).all()), "padded prefill not finite"
    if rank == 0:
        torch.save(logits.cpu(), os.path.join(root, "hymba.pt"))
    return {"pads": list(pads), "k7_launches": launches, "k7_launch": want,
            "prefill_s": prefill_s, "logits": sha(logits)}


def mesh_wire(dev, rank, root) -> dict:
    """(c): the wire train step on (4, 1) from seed-0 weights (each rank
    keeps its data shard of every leaf), MESH_WIRE["steps"] steps over this rank's row of
    ``synth_batch``; each step's loss, grad norm and host s; the wire
    bytes a step (int8 codes against bf16 gradients); a hash of every
    final shard."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenDataConfig, synth_batch
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.shardings import param_pspecs
    from repro_torch.launch.steps import make_wire_train_step
    from repro_torch.models import init_params
    from repro_torch.models.sharding import single_pod_rules
    from repro_torch.optim.adamw import AdamWConfig, init_opt_state
    from repro_torch.optim.compression import _groups

    w = MESH_WIRE
    cfg = dataclasses.replace(get_config(w["arch"]), n_layers=w["layers"])
    mesh = make_host_mesh(*w["mesh"], device=dev)
    d_size = w["mesh"][0]
    pspecs = param_pspecs(cfg, mesh)
    dims = {n: next((i for i, a in enumerate(sp) if a == "data"), None)
            for n, sp in pspecs.items()}
    full = init_params(cfg, seed=0, device=dev)
    shards = {}
    for n, p in full.named_parameters():
        d = dims[n]
        k = p.shape[d] // d_size if d is not None else None
        shards[n] = (p.detach().clone() if d is None
                     else p.detach().narrow(d, rank * k, k).clone())
    numel = sum(p.numel() for p in full.parameters())
    groups = len(_groups(dict(full.named_parameters())))
    del full
    torch.cuda.empty_cache()
    opt = init_opt_state(shards)
    step = make_wire_train_step(cfg, AdamWConfig(**w["opt"]), mesh, pspecs,
                                bits=w["bits"], remat=None,
                                rules=single_pod_rules())
    data = TokenDataConfig(cfg.vocab_size, w["seq"], d_size, seed=0)
    rows = []
    for i in range(w["steps"]):
        batch = {k: torch.from_numpy(v[rank:rank + 1]).to(dev)
                 for k, v in synth_batch(data, i).items()}
        t0 = time.perf_counter()
        shards, opt, met = step(shards, opt, batch)
        torch.cuda.synchronize()
        rows.append({"loss": float(met["loss"]),
                     "grad_norm": float(met["grad_norm"]),
                     "s": time.perf_counter() - t0})
    return {"steps": rows, "numel": numel,
            "wire_bytes_per_step": {"int8_codes": numel + 4 * groups,
                                    "bf16_gradients": 2 * numel},
            "shards": {n: sha(t) for n, t in shards.items()},
            "dims": {n: d for n, d in dims.items()}}


def mesh_ckpt(dev, rank, root) -> dict:
    """(d): qwen3-4b's smoke train state saved by rank 0, loaded by every
    rank onto (4, 1) with ``shardings``: each leaf's local shard equal,
    bit for bit, to its slice of the saved leaf; the shards tile it."""
    import torch.distributed as dist

    from repro_torch.checkpoint import load_checkpoint, save_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.shardings import (
        opt_pspecs,
        param_pspecs,
        reference_pspecs,
        to_named,
    )
    from repro_torch.launch.train import build_state
    from repro_torch.models.sharding import PartitionSpec, axis_index, axis_size
    from repro_torch.optim.adamw import AdamWConfig

    cfg = get_config(MESH_CKPT_ARCH).smoke()
    mesh = make_host_mesh(4, 1, device=dev)
    d = os.path.join(root, "ckpt")
    if rank == 0:
        save_checkpoint(d, 1, build_state(cfg, AdamWConfig(), 0, device=dev),
                        device=dev)
    dist.barrier()
    pspecs = param_pspecs(cfg, mesh)
    opt = opt_pspecs(cfg, mesh, pspecs)
    shardings = to_named(mesh, {
        "params": reference_pspecs(pspecs),
        "opt": {"m": reference_pspecs(opt["m"]),
                "v": reference_pspecs(opt["v"]), "step": PartitionSpec()}})
    state, _ = load_checkpoint(d, shardings=shardings, device=dev)
    saved = np.load(os.path.join(d, "step_00000001", "state.npz"))
    flat, specs = flat_tree(state), flat_tree(shardings)
    assert set(flat) == set(saved.files)
    n_cut = 0
    for k, t in flat.items():
        want = torch.from_numpy(saved[k])
        for dim, axis in enumerate(specs[k].spec):
            if axis is not None:
                n = want.shape[dim] // axis_size(axis, mesh)
                want = want.narrow(dim, axis_index(axis, mesh) * n, n)
                n_cut += 1
        local = t.to_local().cpu()
        assert local.shape == want.shape and torch.equal(local, want), k
    return {"leaves": len(flat), "sharded_leaves": n_cut}


def flat_tree(tree, prefix=""):
    """{"/"-joined path: leaf} of nested dicts."""
    if not isinstance(tree, dict):
        return {prefix.rstrip("/"): tree}
    out = {}
    for k, v in tree.items():
        out.update(flat_tree(v, f"{prefix}{k}/"))
    return out


@contextlib.contextmanager
def mesh_group(rank, root, device):
    """This rank's process group of MESH_RANKS on ``device`` (the parent's
    card), through a rendezvous file in ``root``; yields (the device, the
    backend) and destroys the group after."""
    import datetime

    import torch.distributed as dist

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = mesh_backend(MESH_RANKS, torch.cuda.device_count())
    dist.init_process_group(
        backend, init_method=f"file://{os.path.join(root, 'rendezvous')}",
        rank=rank, world_size=MESH_RANKS,
        timeout=datetime.timedelta(seconds=MESH_TIMEOUT_S))
    try:
        yield dev, backend
    finally:
        dist.destroy_process_group()


def mesh_rank(rank, root, device, train_ref):
    """One of the MESH_RANKS ranks of phase 15, all on ``device`` (the
    parent's card); ``train_ref``: (f)'s one-process gradients and
    scalars (``mesh_train_reference``)."""
    import torch.distributed as dist

    from repro_torch.models.sharding import TRANSPORTS

    with mesh_group(rank, root, device) as (dev, backend):
        out = {"rank": rank, "backend": backend}
        clock = {}
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        cfg = family_config(MESH_MOE["arch"])
        tokens = mesh_prompt(cfg, MESH_MOE["batch"], MESH_MOE["prompt"], dev)
        out["granite"] = [mesh_granite(dev, rank, root, cfg, tokens, sh_)
                          for sh_ in MESH_MOE["meshes"]]
        torch.cuda.empty_cache()
        out["granite"] += [mesh_granite(dev, rank, root, cfg, tokens, sh_,
                                        whole=True)
                           for sh_ in MESH_MOE["whole_meshes"]]
        torch.cuda.empty_cache()
        clock["a"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["hymba"] = mesh_hymba(dev, rank, root)
        torch.cuda.empty_cache()
        clock["b"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["wire"] = mesh_wire(dev, rank, root)
        torch.cuda.empty_cache()
        clock["c"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["ckpt"] = mesh_ckpt(dev, rank, root)
        clock["d"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
        peak = torch.cuda.max_memory_allocated(dev)  # (e) resets the stat
        t0 = time.perf_counter()
        out["tp"] = [mesh_tp(dev, rank, root, *run)
                     for run in serve_runs("e")]
        clock["e"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["train_tp"] = mesh_train(dev, root, train_ref)
        clock["f"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["rec"] = [mesh_tp(dev, rank, root, *run)
                      for run in serve_runs("g")]
        clock["g"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["mla"] = [mesh_tp(dev, rank, root, *run)
                      for run in serve_runs("h")]
        clock["h"] = time.perf_counter() - t0
        out["part_s"] = clock
        out["transports"] = dict(TRANSPORTS)
        out["max_memory_allocated"] = max(
            [peak] + [t["peak_abs"]
                      for t in out["tp"] + out["rec"] + out["mla"]])
        with open(os.path.join(root, f"rank{rank}.json"), "w") as fh:
            json.dump(out, fh)
        dist.barrier()


def mesh_mla_rank(rank, root, device):
    """``--mesh-mla``'s rank: phase 15 (h) alone."""
    import torch.distributed as dist

    with mesh_group(rank, root, device) as (dev, backend):
        t0 = time.perf_counter()
        out = {"rank": rank, "backend": backend,
               "mla": [mesh_tp(dev, rank, root, *run)
                       for run in serve_runs("h")]}
        out["part_s"] = {"h": time.perf_counter() - t0}
        with open(os.path.join(root, f"rank{rank}.json"), "w") as fh:
            json.dump(out, fh)
        dist.barrier()


def mesh_mla_rows(ranks) -> dict:
    """(h)'s part of the ``{"mesh"}`` row from the ranks' outputs: the runs
    on rank 0 (logits hashes left out), every rank's peak a run, and (h)'s
    seconds on the ranks; the ranks' logits must agree."""
    for rk in ranks[1:]:
        for a, b in zip(rk["mla"], ranks[0]["mla"]):
            assert a["logits"] == b["logits"], "ranks' MLA logits differ"
    return {"mla": [{k: v for k, v in t.items() if k != "logits"}
                    for t in ranks[0]["mla"]],
            "mla_peak_bytes_per_rank": [[t["peak_bytes"] for t in rk["mla"]]
                                        for rk in ranks],
            "mla_ranks_s": ranks[0]["part_s"]["h"]}


def mesh_tp_config(layers, dtype):
    return family_config(MESH_TP["arch"], dtype=dtype,
                         **({} if layers is None else {"n_layers": layers}))


def serve_runs(part: str) -> list:
    """(e)'s, (g)'s or (h)'s runs, each (name, config, mesh, batch, prompt,
    max_len)."""
    t = MESH_TP
    if part == "e":
        return [(name, mesh_tp_config(layers, dtype), shape, batch,
                 t["prompt"], t["max_len"])
                for name, shape, layers, dtype, batch in t["runs"]]
    if part == "h":
        runs = []
        for name, experts, shape, dtype, batch, prompt, max_len, free in \
                MESH_DSV3["runs"]:
            cfg = family_config(MESH_DSV3["arch"], dtype=dtype,
                                **({} if experts is None
                                   else {"n_experts": experts}))
            runs.append((name, dropless(cfg) if free else cfg, shape, batch,
                         prompt, max_len))
        return runs
    return [(name, family_config(
                arch, dtype=dtype,
                **({} if layers is None else {"n_layers": layers})),
             shape, batch, prompt, max_len)
            for name, arch, shape, layers, dtype, batch, prompt, max_len
            in MESH_RECURRENT["runs"]]


def f32_copy(cfg, params, dev):
    """(the float32 config, the same weights upcast), ``params`` left."""
    import dataclasses

    from repro_torch.models import TransformerLM

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params32 = TransformerLM(cfg32, dev)
    with torch.no_grad():
        for p32, p in zip(params32.parameters(), params.parameters()):
            p32.copy_(p.float())
    return cfg32, params32


def mesh_serve(cfg, params, tokens, max_len, feed=None):
    """One process: the prefill through the kernels, then MESH_TP's decode
    steps, greedy or fed ``feed`` (B, steps); (each step's logits on the
    host, the tokens fed)."""
    from repro_torch.launch.steps import make_decode_step, make_prefill_step

    logits, cache = make_prefill_step(cfg, use_flash=True)(
        params, tokens, max_len=max_len)
    out, fed = [logits.float().cpu()], []
    decode = make_decode_step(cfg)
    for i in range(MESH_TP["steps"]):
        tok = (logits.argmax(-1) if feed is None
               else feed[:, i].to(tokens.device))
        fed.append(tok.cpu())
        logits, cache = decode(params, tok, cache)
        out.append(logits.float().cpu())
    return out, torch.stack(fed, 1)


def floor_config(cfg):
    """The config whose bf16 floor stands for ``cfg``'s: ``cfg`` itself, or
    for a DeepSeek-V3 of more than FAMILY_DSV3_CHECK_EXPERTS routed
    experts, that copy (phase 13's rule: float32 weights beside the bf16
    ones would not fit the card)."""
    import dataclasses

    if cfg.attn_type == "mla" and cfg.n_experts > FAMILY_DSV3_CHECK_EXPERTS:
        return dataclasses.replace(cfg, n_experts=FAMILY_DSV3_CHECK_EXPERTS)
    return cfg


def mesh_tp_reference(dev, root, runs) -> dict:
    """(e)'s, (g)'s or (h)'s one-process runs, before the ranks start: each
    run's model whole (``init_params``, seed 0), its prefill through the
    kernels and the greedy decode (bf16: the tokens the ranks are fed);
    for a bf16 run, the bf16 floor: the same prompt and tokens through
    ``floor_config``'s model (the run's own, or a fresh one of that
    config) in bf16 and its weights upcast to float32, their distance a
    step.  Saved to ``root``; every model freed before the next."""
    from repro_torch.models import init_params

    row = {}
    for name, cfg, _, batch, prompt, max_len in runs:
        t0 = time.perf_counter()
        params = init_params(cfg, seed=0, device=dev)
        tokens = mesh_prompt(cfg, batch, prompt, dev)
        runs_ = {}
        runs_[cfg.dtype], fed = mesh_serve(cfg, params, tokens, max_len)
        if cfg.dtype == "bfloat16":
            witness, wcfg = runs_["bfloat16"], floor_config(cfg)
            if wcfg is not cfg:
                del params
                torch.cuda.empty_cache()
                params = init_params(wcfg, seed=0, device=dev)
                witness, _ = mesh_serve(wcfg, params, tokens, max_len, fed)
            cfg32, params32 = f32_copy(wcfg, params, dev)
            del params
            torch.cuda.empty_cache()
            runs_["float32"], _ = mesh_serve(cfg32, params32, tokens,
                                             max_len, fed)
            runs_["floor"] = [rel_l2(a, b) for a, b in zip(witness,
                                                           runs_["float32"])]
            runs_["floor_experts"] = wcfg.n_experts
            del params32
        else:
            del params
        torch.cuda.empty_cache()
        torch.save({"tokens": fed, **runs_},
                   os.path.join(root, f"tp_{name}_ref.pt"))
        row[name] = {"s": time.perf_counter() - t0}
    return row


def mesh_tp(dev, rank, root, name, cfg, shape, batch, prompt,
            max_len) -> dict:
    """(e), (g) or (h), one run on this rank: its shards of the seeded
    weights cut leaf by leaf (``shard_params(init_leaves(...))``; the
    stored bytes held to the sum of ``shard_shape`` bytes and the peak of
    the init below the whole model's; where MESH_RANKS ranks each holding
    the largest block whole beside their shards would fill most of the
    card, one rank at a time), a short warm-up, the timed prefill (K7's
    and K8's counts set to 0 just before and read after, a spy recording
    each launch's shape; the family's kernel launched once a layer, and
    none for MLA, whose route, dense or chunked, is recorded), then the
    decode steps fed the one-process tokens, each step's logits gathered
    whole; rank 0 saves them for the parent's check.  The timed prefill
    and decode steps run under ``collective_timing`` (each collective
    behind a sync of the card and a barrier of its group): calls, bytes,
    barrier and collective seconds per kind, and their shares of the
    timed wall time."""
    import torch.distributed as dist

    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan as ws
    from repro_torch.models import mla
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.shardings import (
        NamedSharding,
        param_pspecs,
        shard_params,
    )
    from repro_torch.launch.steps import (
        make_decode_step,
        make_prefill_step,
        whole_logits,
    )
    from repro_torch.models import TransformerLM, init_leaves
    from repro_torch.models.sharding import (
        collective_timing,
        logical_sharding,
        single_pod_rules,
    )

    t = MESH_TP
    mesh = make_host_mesh(*shape, device=dev)
    meta = dict(TransformerLM(cfg, "meta").named_parameters())
    specs = param_pspecs(cfg, mesh)
    whole_bytes = sum(p.numel() * p.element_size() for p in meta.values())
    shard_bytes = sum(
        int(np.prod(NamedSharding(mesh, specs[n]).shard_shape(p.shape)))
        * p.element_size() for n, p in meta.items())
    blocks: dict[str, int] = {}
    for n, p in meta.items():
        key = ".".join(n.split(".")[:2])
        blocks[key] = blocks.get(key, 0) + p.numel() * p.element_size()
    turns = (MESH_RANKS * (max(blocks.values()) + shard_bytes) > 0.5
             * torch.cuda.get_device_properties(dev).total_memory)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    for turn in range(MESH_RANKS if turns else 1):
        if not turns or turn == rank:
            params = shard_params(cfg, init_leaves(cfg, 0, dev), mesh, dev)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()  # the whole blocks go back to the card
        if turns:
            dist.barrier()
    row = {"run": name, "arch": cfg.name, "mesh": list(shape),
           "layers": cfg.n_layers, "dtype": cfg.dtype, "batch": batch,
           "prompt": prompt, "max_len": max_len, "init_in_turns": turns,
           "init_s": time.perf_counter() - t0,
           "param_bytes": sum(p.numel() * p.element_size()
                              for p in params.parameters()),
           "shard_shape_bytes": shard_bytes, "whole_bytes": whole_bytes,
           "init_peak_bytes": torch.cuda.max_memory_allocated(dev) - base}
    assert row["param_bytes"] == shard_bytes, row
    assert row["init_peak_bytes"] < whole_bytes, row
    torch.cuda.reset_peak_memory_stats(dev)  # the serving peak from here
    ref = torch.load(os.path.join(root, f"tp_{name}_ref.pt"))
    tokens = mesh_prompt(cfg, batch, prompt, dev)
    prefill = make_prefill_step(cfg, use_flash=True)
    decode = make_decode_step(cfg)
    seen = {"flash": [], "wkv6": []}
    orig = (fa._launch_flash, ws._launch_wkv6)
    routes = {"dense": 0, "chunked": 0}
    orig_routes = (mla._attend_dense, mla._attend_chunked)

    def route_spy(kind, fn):
        def spy(*args, **kw):
            routes[kind] += 1
            return fn(*args, **kw)
        return spy

    def flash_spy(q, k, v, causal=True, window=None, n_rep=1):
        seen["flash"].append([q.shape[0], k.shape[0], n_rep, q.shape[1],
                              window])
        return orig[0](q, k, v, causal, window, n_rep)

    def wkv6_spy(r, k, v, w, u, state):
        seen["wkv6"].append(list(r.shape))
        return orig[1](r, k, v, w, u, state)

    got = []
    with logical_sharding(mesh, single_pod_rules()):
        prefill(params, tokens[:, :t["warm_prompt"]], max_len=max_len)
        torch.cuda.synchronize()
        dist.barrier()
        fa.reset_launches()
        ws.reset_launches()
        fa._launch_flash, ws._launch_wkv6 = flash_spy, wkv6_spy
        mla._attend_dense = route_spy("dense", orig_routes[0])
        mla._attend_chunked = route_spy("chunked", orig_routes[1])
        try:
            with collective_timing() as coll:
                t0 = time.perf_counter()
                logits, cache = prefill(params, tokens, max_len=max_len)
                torch.cuda.synchronize()
                row["prefill_s"] = time.perf_counter() - t0
        finally:
            fa._launch_flash, ws._launch_wkv6 = orig
            mla._attend_dense, mla._attend_chunked = orig_routes
        row["prefill_collectives"] = coll
        row["k7_launches"] = fa.LAUNCHES["flash"]
        row["k8_launches"] = ws.LAUNCHES["wkv6"]
        row["launch_shapes"] = {k: sorted(map(list, {tuple(x) for x in v}))
                                for k, v in seen.items() if v}
        if cfg.attn_type == "mla":
            slots = cache["layers"][0]["c_kv"].shape[1]
            row["mla_route"] = {k: n for k, n in routes.items() if n}
            row["latent_cache"] = {"slots_a_rank": slots,
                                   "cut": "time" if slots < max_len
                                   else "whole"}
            assert routes == {"dense": 0, "chunked": 0, **{
                "chunked" if prompt >= mla.MLA_CHUNKED_THRESHOLD
                else "dense": cfg.n_layers}}, routes
        got.append(whole_logits(cfg, logits, batch).float().cpu())
        step_ms = []
        decode_coll = {}
        for i in range(t["steps"]):
            with collective_timing() as coll:
                t0 = time.perf_counter()
                logits, cache = decode(params, ref["tokens"][:, i].to(dev),
                                       cache)
                torch.cuda.synchronize()
                step_ms.append((time.perf_counter() - t0) * 1e3)
            for kind, c in coll.items():
                acc = decode_coll.setdefault(kind, dict.fromkeys(c, 0))
                for k, v in c.items():
                    acc[k] += v
            got.append(whole_logits(cfg, logits, batch).float().cpu())
    row["decode_collectives"] = decode_coll
    for part, coll, wall in (("prefill", row["prefill_collectives"],
                              row["prefill_s"]),
                             ("decode", decode_coll, sum(step_ms) / 1e3)):
        row[f"{part}_collective_share"] = sum(
            c["s"] for c in coll.values()) / wall
        row[f"{part}_wait_share"] = sum(
            c["wait_s"] for c in coll.values()) / wall
    row["decode_ms"] = step_ms
    row["decode_ms_per_step"] = float(np.median(step_ms))
    row["serve_peak_bytes"] = torch.cuda.max_memory_allocated(dev) - base
    row["peak_bytes"] = max(row["init_peak_bytes"], row["serve_peak_bytes"])
    row["peak_abs"] = base + row["peak_bytes"]
    row["logits"] = [sha(g) for g in got]
    # the family's kernel once a layer and no other; MLA reaches none
    kernel = {"rwkv6": "wkv6", "mla": None}.get(cfg.attn_type, "flash")
    counts = {"flash": row["k7_launches"], "wkv6": row["k8_launches"]}
    if kernel is not None:
        assert counts[kernel] == cfg.n_layers == len(seen[kernel]), row
    assert all(n == 0 for k, n in counts.items() if k != kernel), row
    assert all(bool(torch.isfinite(g).all()) for g in got), name
    if rank == 0:
        torch.save(got, os.path.join(root, f"tp_{name}_rank.pt"))
    del params, cache
    torch.cuda.empty_cache()
    return row


def mesh_tp_check(root, runs) -> dict:
    """(e)'s, (g)'s or (h)'s logits against the one-process runs: bf16 runs
    within FAMILY_BF16_OVER_FLOOR times the bf16 floor (``mesh_tp_
    reference``'s: the one-process bf16 logits' distance from float32 on
    the same weights and tokens, or on ``floor_config``'s), step by step;
    float32 runs within MESH_TP_F32_TOL."""
    out = {}
    for name, cfg, *_ in runs:
        ref = torch.load(os.path.join(root, f"tp_{name}_ref.pt"))
        got = torch.load(os.path.join(root, f"tp_{name}_rank.pt"))
        errs = [rel_l2(g, w) for g, w in zip(got, ref[cfg.dtype])]
        row = {"rel_l2": errs}
        if cfg.dtype == "bfloat16":
            floors = ref["floor"]
            row["floor"] = floors
            row["floor_experts"] = ref["floor_experts"]
            row["bound"] = FAMILY_BF16_OVER_FLOOR
            row["ok"] = all(e <= FAMILY_BF16_OVER_FLOOR * f
                            for e, f in zip(errs, floors))
        else:
            row["bound"] = MESH_TP_F32_TOL
            row["ok"] = all(e <= MESH_TP_F32_TOL for e in errs)
        out[name] = row
    assert all(r["ok"] for r in out.values()), out
    return out


def k7_launch_timing(dev, bh, n_rep, s, hd, window, seed) -> dict:
    """K7 at one launch (``bh`` query heads over bh / n_rep KV heads, S
    ``s``, causal, ``window``, bf16, seeded inputs) against its plain
    version, timed beside its bound, its plain version and SDPA (the KV
    heads repeated; ``is_causal``, or the window as a boolean mask)."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash_attention as fa

    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((bh, s, hd), generator=gen, device=dev).bfloat16()
    k, v = (torch.randn((bh // n_rep, s, hd), generator=gen,
                        device=dev).bfloat16() for _ in range(2))
    got = fa._flash_attention_grouped(q, k, v, n_rep, True, window)
    err = close_err(got, fa._flash_plain(q, k, v, True, window,
                                         n_rep=n_rep), FLASH_TOL[q.dtype])
    bms, by, work = flash_bound(q, k, window=window)
    kr, vr = k.repeat_interleave(n_rep, 0), v.repeat_interleave(n_rep, 0)
    if window is None:
        sdpa = {"is_causal": True}
    else:
        idx = torch.arange(s, device=dev)
        sdpa = {"attn_mask": (idx[:, None] >= idx[None, :])
                & (idx[:, None] - idx[None, :] < window)}
    return {
        "launch": {"bh": bh, "kv_heads": bh // n_rep, "n_rep": n_rep,
                   "s": s, "hd": hd, "window": window, "dtype": "bfloat16"},
        "max_abs_err": err,
        "ms": time_ms(lambda: fa._launch_flash(q, k, v, True, window,
                                               n_rep)),
        "plain_ms": time_ms(lambda: fa._flash_plain(q, k, v, True, window,
                                                    n_rep=n_rep)),
        "bound_ms": bms, "bound_by": by, "work": work,
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
            q[None], kr[None], vr[None], **sdpa)),
    }


def mesh_k7_tp_timing(dev) -> dict:
    """K7 at (e)'s launch on a rank of (1, 4): 4 x 8 query heads over 4 x
    2 KV heads (n_rep 4), S 2,048, hd 128, causal."""
    cfg = mesh_tp_config(None, "bfloat16")
    _, (_, model), _, _, batch = MESH_TP["runs"][0]
    rep = cfg.n_heads // cfg.n_kv_heads
    return k7_launch_timing(dev, batch * cfg.n_heads // model,
                            rep, MESH_TP["prompt"], cfg.head_dim_, None, 26)


def mesh_k7_rec_timing(dev) -> dict:
    """K7 at (g)'s Hymba launch on a rank of (1, 4): 2 x 9 padded query
    heads, each over its own KV head (n_rep 1), S 4,096, hd 64, window
    2,048."""
    bh, _, n_rep, s, window = MESH_RECURRENT["launch"]["hymba"][1]
    return k7_launch_timing(dev, bh, n_rep, s, 64, window, 28)


def mesh_k8_rec_timing(dev) -> dict:
    """K8 at (g)'s RWKV6 launch on a rank of (1, 4): r, k, v (4, 2,048, 8,
    64) bf16 in the model's layout, w float32 in (0, 1), u (8, 64), a zero
    float32 state, seeded; against its plain version (WKV_TOL), timed
    beside its bound and its plain version.  No single PyTorch call
    computes the WKV6 recurrence."""
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan as ws

    b, s, h, hd = MESH_RECURRENT["launch"]["rwkv6"][1]
    gen = torch.Generator(device=dev).manual_seed(29)
    r, k, v = (torch.randn((b, s, h, hd), generator=gen,
                           device=dev).bfloat16() * 0.5 for _ in range(3))
    w = torch.exp(-torch.exp(torch.randn((b, s, h, hd), generator=gen,
                                         device=dev) - 5.0))
    u = torch.randn((h, hd), generator=gen, device=dev) * 0.1
    state = torch.zeros((b, h, hd, hd), device=dev)
    args = (r, k, v, w, u, state)
    err = wkv_err(ws._launch_wkv6(*args), ws._wkv6_model_plain(*args))
    bms, by, work = wkv_bound(args)
    return {
        "launch": {"b": b, "s": s, "h": h, "hd": hd, "dtype": "bfloat16"},
        "max_abs_err": err,
        "ms": time_ms(lambda: ws._launch_wkv6(*args)),
        "plain_ms": time_ms(lambda: ws._wkv6_model_plain(*args)),
        "bound_ms": bms, "bound_by": by, "work": work, "library_ms": None,
    }


def mesh_granite_check(dev, root) -> dict:
    """(a)'s (1, 4) logits, tensor-parallel and with whole parameters,
    each against a single-process dense prefill on the
    card (no mesh installed: ``_moe_apply_dense``), in bf16, within
    FAMILY_BF16_OVER_FLOOR times the witness, the dense bf16 prefill's
    distance from the float32 one on the same weights upcast."""
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import init_params

    cfg = family_config(MESH_MOE["arch"])
    params = init_params(cfg, seed=0, device=dev)
    tokens = mesh_prompt(cfg, MESH_MOE["batch"], MESH_MOE["prompt"], dev)
    dense, _ = make_prefill_step(cfg, use_flash=True)(
        params, tokens, max_len=MESH_MOE["max_len"])
    cfg32, params32 = f32_copy(cfg, params, dev)
    del params
    torch.cuda.empty_cache()
    dense32, _ = make_prefill_step(cfg32, use_flash=True)(
        params32, tokens, max_len=MESH_MOE["max_len"])
    del params32
    torch.cuda.empty_cache()
    row = {"dense_vs_f32_rel_l2": rel_l2(dense, dense32),
           "bound": FAMILY_BF16_OVER_FLOOR}
    for tag in ("1x4", "1x4_whole"):
        ep = torch.load(os.path.join(root, f"granite_{tag}.pt")).to(dev)
        row[tag] = {"ep_vs_dense_rel_l2": rel_l2(ep, dense),
                    "ep_vs_f32_rel_l2": rel_l2(ep, dense32)}
        assert row[tag]["ep_vs_dense_rel_l2"] <= (
            FAMILY_BF16_OVER_FLOOR * row["dense_vs_f32_rel_l2"]), row
    return row


def mesh_hymba_check(dev, root) -> dict:
    """(b)'s padded prefill against the unpadded one in one process (no
    mesh): K7 at 25 / 5 heads there, 36 / 6 on the ranks; the logits
    within K7's bf16 tolerance."""
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import init_params

    h = MESH_HYMBA
    cfg = family_config(h["arch"], n_layers=h["layers"])
    params = init_params(cfg, seed=0, device=dev)
    tokens = mesh_prompt(cfg, h["batch"], h["prompt"], dev)
    plain, _ = make_prefill_step(cfg, use_flash=True)(params, tokens,
                                                      max_len=h["max_len"])
    padded = torch.load(os.path.join(root, "hymba.pt")).to(dev)
    err = close_err(padded, plain, FLASH_TOL[torch.bfloat16])
    return {"max_abs_err": err, "tol": FLASH_TOL[torch.bfloat16],
            "bit_equal": bool(torch.equal(padded, plain)),
            "rel_l2": rel_l2(padded, plain)}


def mesh_wire_replay(dev, ranks) -> dict:
    """(c) in one process: the 4 ranks' gradients from the whole model,
    their 4-bit codes with each rank's Generator (seeded step * 4 + rank,
    drawn in the step's order), the integer sum, the decode, the clip and
    AdamW on whole tensors; each step's mean loss within 2 float32 ulps
    of the ranks' (gloo's four-way sum has its own order) and every final
    shard's hash equal to the rank's.  The gradients are taken in the
    step's ``manual_region``, as the ranks take theirs."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenDataConfig, synth_batch
    from repro_torch.launch.steps import deterministic_algorithms, loss_and_grads
    from repro_torch.models import init_params
    from repro_torch.models.sharding import manual_region
    from repro_torch.optim import compression
    from repro_torch.optim.adamw import (
        AdamWConfig,
        adamw_update,
        clip_by_global_norm,
        init_opt_state,
    )

    w = MESH_WIRE
    d_size = w["mesh"][0]
    cfg = dataclasses.replace(get_config(w["arch"]), n_layers=w["layers"])
    opt_cfg = AdamWConfig(**w["opt"])
    no_clip = dataclasses.replace(opt_cfg, clip_norm=float("inf"))
    params = init_params(cfg, seed=0, device=dev)
    opt = init_opt_state(params)
    data = TokenDataConfig(cfg.vocab_size, w["seq"], d_size, seed=0)
    qmax = (1 << (w["bits"] - 1)) - 1
    one = torch.ones((), device=dev)
    losses = []
    for i in range(w["steps"]):
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in synth_batch(data, i).items()}
        with deterministic_algorithms(), manual_region():
            per_rank, local = [], []
            for r in range(d_size):
                loss, g = loss_and_grads(
                    cfg, params, {k: v[r:r + 1] for k, v in batch.items()},
                    remat=None)
                per_rank.append(g)
                local.append(loss.detach())
            gens = [torch.Generator(device=dev).manual_seed(i * d_size + r)
                    for r in range(d_size)]
            grads = {}
            for members in compression._groups(per_rank[0]).values():
                scale = torch.clamp(torch.stack([
                    g[m].float().abs().max() for g in per_rank
                    for m in members]).max(), min=1e-30)
                for m in members:
                    total = sum(compression._wire_codes(
                        per_rank[r][m], scale, qmax, torch.int32, gen=gens[r])
                        for r in range(d_size))
                    grads[m] = total.float().mul_(scale).mul_(one / qmax).mul_(
                        one / d_size).to(per_rank[0][m].dtype)
            del per_rank
            grads, _ = clip_by_global_norm(grads, opt_cfg.clip_norm)
            params, opt, _ = adamw_update(no_clip, params, grads, opt)
        losses.append(float(torch.stack(local).sum() / d_size))
    out = {"losses": losses}
    for i, want in enumerate(losses):
        got = ranks[0]["wire"]["steps"][i]["loss"]
        assert abs(got - want) <= 2 * np.spacing(np.float32(want)), (
            i, got, want)
    named = dict(params.named_parameters())
    n_rep = 0
    for r, rk in enumerate(ranks):
        for n, h in rk["wire"]["shards"].items():
            d = rk["wire"]["dims"][n]
            t = named[n]
            if d is None:
                n_rep += r == 0
                assert h == ranks[0]["wire"]["shards"][n], (n, r)
            else:
                k = t.shape[d] // d_size
                t = t.narrow(d, r * k, k)
            assert sha(t) == h, (n, r)
    out["replicated_leaves"] = n_rep
    out["shards_equal_replay"] = True
    return out


def mesh_k7_timing(dev) -> dict:
    """K7 at (b)'s padded launch: 72 query heads over 12 KV heads, n_rep
    6, S 4,096, hd 64, window 2,048."""
    h = MESH_HYMBA
    kv, rep = h["pads"]
    return k7_launch_timing(dev, h["batch"] * kv * rep, rep, h["prompt"],
                            64, 2048, 15)


# (f) tensor-parallel training of qwen3-4b on the 4 ranks, after (a)-(e):
# float32 cut to 2 layers held to a one-process step of the same weights
# (TF32 off); bf16 cut to 4 layers, remat
# "full", 2 x 2,048 tokens (the chunked vocab-parallel cross entropy), a
# warm-up step and MESH_TRAIN["bf16"]["timed"] timed steps on each mesh
# (3 -> 2 to pay for (i)); the smoke config on (2, 2) preempted at step 3
# and resumed from its step-2 checkpoint; "comp": the float32 2-layer
# model's first step with 4-bit gradient compression on (2, 2), held to
# the one-process compressed step by the code-flip rule, and the same
# step uncompressed beside it for its time and peak
MESH_TRAIN = {
    "arch": "qwen3-4b", "seed": 0,
    "opt": {"lr": 3e-4, "warmup_steps": 1, "total_steps": 10},
    "f32": {"layers": 2, "mesh": (1, 4), "batch": 2, "seq": 256,
            "steps": 2},
    "comp": {"mesh": (2, 2), "bits": 4},
    "bf16": {"layers": 4, "meshes": ((1, 4), (2, 2)), "batch": 2,
             "seq": 2048, "timed": 2},
    "resume": {"mesh": (2, 2), "batch": 4, "seq": 64, "steps": 5,
               "save_every": 2, "fail_at": 3},
}
MESH_TRAIN_TOL = {"loss": 1e-5, "grad": 1e-4, "update": 1e-5}
#: elements (f)'s compressed-step check takes at a time
MESH_COMP_CHUNK = 1 << 22
# an updated element is "near" when Adam's denominator sqrt(v^) (on the
# first step the clipped gradient's magnitude) is within this many eps of
# zero on both sides (the test suite's rule, tests/test_torch_mesh_train.py;
# its bound on the near share is for the smoke configs' 512-token vocab:
# at 151,936, most of the head's columns get gradients of a few eps)
MESH_NEAR_EPS = 300


def mesh_train_batch(cfg, batch, seq, step, dev) -> dict:
    """(f)'s seeded next-token batch of a step, the same on every rank."""
    host = torch.Generator().manual_seed(1000 + step)
    tok = torch.randint(0, cfg.vocab_size, (batch, seq + 1), generator=host)
    return {"tokens": tok[:, :-1].to(dev), "labels": tok[:, 1:].to(dev)}


@contextlib.contextmanager
def tf32_off():
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def mesh_train_reference(dev) -> tuple[dict, dict]:
    """(f)'s one-process runs, in this process before the ranks start.
    float32, 2 layers (TF32 off): the first step's gradients, then its
    ``make_train_step``, then the second step's loss and grad norm at the
    updated weights; the gradients are kept on the card and handed to
    the ranks (CUDA IPC through spawn's arguments), each of which
    recomputes the one-process step's update of its slices from them
    (AdamW is elementwise but for the norm, which is passed).  bf16, 4
    layers: the first step's loss and grad norm, and those of the same
    weights in float32 (bf16's floor).  The float32 step compressed
    (``MESH_TRAIN["comp"]``): each leaf group's lo and hi of the first
    gradients (the error feedback is zero) and the compressed gradients'
    norm, from which the ranks recompute the one-process compressed
    update of their slices."""
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import TransformerLM, init_params
    from repro_torch.optim import compression as comp
    from repro_torch.optim.adamw import AdamWConfig, _global_norm
    from repro_torch.optim.adamw import init_opt_state

    t = MESH_TRAIN
    f = t["f32"]
    scalars = {}
    with tf32_off():
        cfg = mesh_tp_config(f["layers"], "float32")
        params = init_params(cfg, seed=t["seed"], device=dev)
        step = make_train_step(cfg, AdamWConfig(**t["opt"]), remat="full")
        batches = [mesh_train_batch(cfg, f["batch"], f["seq"], i, dev)
                   for i in range(f["steps"])]
        _, grads = train_grads(cfg, params, batches[0])
        groups = comp._groups(grads)
        bounds = comp._bounds({g: [grads[n] for n in members]
                               for g, members in groups.items()})
        total = torch.zeros((), dtype=torch.float64, device=dev)
        for g, members in groups.items():
            for n in members:
                recon = comp._quantize_in(grads[n], *bounds[g],
                                          t["comp"]["bits"])
                total += torch.sum(torch.square(recon), dtype=torch.float64)
                del recon
        scalars["comp_bounds"] = {g: [float(lo), float(hi)]
                                  for g, (lo, hi) in bounds.items()}
        scalars["comp_grad_norm"] = float(torch.sqrt(total).float())
        params, _, met = step(params, init_opt_state(params), batches[0])
        scalars["f32_loss"] = [float(met["loss"])]
        scalars["f32_grad_norm"] = [float(met["grad_norm"])]
        loss, g1 = train_grads(cfg, params, batches[1])
        scalars["f32_loss"].append(loss)
        scalars["f32_grad_norm"].append(float(_global_norm(g1)))
        del g1, params
        torch.cuda.empty_cache()
    b = t["bf16"]
    cfg = mesh_tp_config(b["layers"], "bfloat16")
    batch = mesh_train_batch(cfg, b["batch"], b["seq"], 0, dev)
    params = init_params(cfg, seed=t["seed"], device=dev)
    loss, g = train_grads(cfg, params, batch)
    scalars["bf16_loss"], scalars["bf16_grad_norm"] = (
        loss, float(_global_norm(g)))
    del g
    cfg32 = mesh_tp_config(b["layers"], "float32")
    params32 = TransformerLM(cfg32, dev)
    with torch.no_grad():
        for p32, p in zip(params32.parameters(), params.parameters()):
            p32.copy_(p.float())
    del params
    torch.cuda.empty_cache()
    with tf32_off():
        loss, g = train_grads(cfg32, params32, batch)
    scalars["f32_4_loss"], scalars["f32_4_grad_norm"] = (
        loss, float(_global_norm(g)))
    del g, params32
    torch.cuda.empty_cache()
    return grads, scalars


def adam_near(got, want, v_pair, step, opt_cfg):
    """An AdamW step's updated shard ``got`` against ``want`` from the same
    state: (the elements ``near``, a bool tensor, and {"near", "off",
    "size", "rel_l2"}).  Near: Adam's denominator sqrt(v^) within
    MESH_NEAR_EPS eps of zero on both sides (``v_pair``), not zero on
    both, where the gradient's last bits can flip the step; off: a gap
    past 1e-6 relative plus 1e-7; ``rel_l2``: the other elements'
    relative L2, held to MESH_TRAIN_TOL["update"] (the test suite's rule,
    ``tests/test_torch_mesh_train.py``)."""
    c2 = 1 - opt_cfg.beta2 ** step
    denom = torch.maximum(*((v.double() / c2).sqrt() for v in v_pair))
    near = (denom > 0) & (denom <= MESH_NEAR_EPS * opt_cfg.eps)
    want = want.double()
    diff = got.double() - want
    off = diff.abs() > 1e-6 * want.abs() + 1e-7
    rest = ~near
    rel = diff[rest].norm() / want[rest].norm().clamp(min=1e-30)
    return near, {"near": int(near.sum()), "off": int(off.sum()),
                  "size": want.numel(), "rel_l2": float(rel)}


def mesh_train_f32(dev, mesh, grads_ref, scalars) -> dict:
    """(f) float32 on this rank: its shards of the 2-layer model's seeded
    weights; the first step's gradient shards against the one-process
    gradients' slices (``grads_ref``), its updated parameter and moment
    shards against the one-process step's update of the same slices
    (``adamw_update`` from the initial shard and the clipped one-process
    gradient slice, the one-process norm's clip scale: the update is
    elementwise; ``adam_near``), both steps' losses and grad norms
    against the one-process ones, and the digests of the leaves every
    rank holds whole.  Where the near elements lie: their count, the off
    ones' and the size a leaf kind (the layer index dropped), and the
    head's near elements in the columns of labels the batch has against
    the others."""
    import dataclasses

    from repro_torch.launch.shardings import local_shard, shard_train_state
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import init_leaves
    from repro_torch.models.sharding import logical_sharding, single_pod_rules
    from repro_torch.optim.adamw import AdamWConfig, _clip_scale, adamw_update

    t = MESH_TRAIN
    f = t["f32"]
    tol = MESH_TRAIN_TOL
    opt_cfg = AdamWConfig(**t["opt"])
    cfg = mesh_tp_config(f["layers"], "float32")
    row = {"mesh": list(f["mesh"]), "layers": f["layers"],
           "tokens": [f["batch"], f["seq"]]}
    with tf32_off(), logical_sharding(mesh, single_pod_rules()):
        state = shard_train_state(cfg, init_leaves(cfg, t["seed"], dev), mesh,
                                  dev)
        params, opt = state["params"], state["opt"]
        specs = params.pspecs
        initial = {n: p.detach().clone() for n, p in params.named_parameters()}
        step = make_train_step(cfg, opt_cfg, remat="full")
        batches = [mesh_train_batch(cfg, f["batch"], f["seq"], i, dev)
                   for i in range(f["steps"])]
        _, grads = train_grads(cfg, params, batches[0])
        row["grad_rel_l2_max"] = max(
            rel_l2(g, local_shard(grads_ref[n], specs[n], mesh))
            for n, g in grads.items())
        del grads
        losses, norms = [], []
        for i, batch in enumerate(batches):
            params, opt, met = step(params, opt, batch)
            losses.append(float(met["loss"]))
            norms.append(float(met["grad_norm"]))
            if i:
                continue
            scale = _clip_scale(torch.tensor(scalars["f32_grad_norm"][0],
                                             device=dev), opt_cfg.clip_norm)
            no_clip = dataclasses.replace(opt_cfg, clip_norm=float("inf"))
            checks = {}
            labels = torch.zeros(cfg.vocab_size, dtype=torch.bool,
                                 device=dev)
            labels[batch["labels"].reshape(-1)] = True
            for n, p in params.named_parameters():
                g = local_shard(grads_ref[n], specs[n], mesh)
                want, st, _ = adamw_update(
                    no_clip, {n: initial.pop(n)}, {n: g * scale},
                    {"m": {n: torch.zeros_like(g)},
                     "v": {n: torch.zeros_like(g)},
                     "step": torch.zeros((), dtype=torch.int32, device=dev)})
                near, checks[n] = adam_near(p, want[n],
                                            [opt["v"][n], st["v"][n]], 1,
                                            opt_cfg)
                if n == "lm_head":
                    mine = local_shard(labels[None], specs[n], mesh)[0]
                    row["head_near"] = {
                        "label_cols": int(mine.sum()),
                        "near_in_label_cols": int(near[:, mine].sum()),
                        "near_in_other_cols": int(near[:, ~mine].sum())}
                for k in ("m", "v"):
                    checks[n][f"{k}_rel_l2"] = rel_l2(opt[k][n], st[k][n])
                del want, st, g
        row["losses"], row["grad_norms"] = losses, norms
        row["one_process"] = {"losses": scalars["f32_loss"],
                              "grad_norms": scalars["f32_grad_norm"]}
        row["loss_rel"] = max(abs(a / b - 1) for a, b in
                              zip(losses, scalars["f32_loss"]))
        row["grad_norm_rel"] = max(abs(a / b - 1) for a, b in
                                   zip(norms, scalars["f32_grad_norm"]))
        row["update"] = {
            "rel_l2_max": max(c["rel_l2"] for c in checks.values()),
            "m_rel_l2_max": max(c["m_rel_l2"] for c in checks.values()),
            "v_rel_l2_max": max(c["v_rel_l2"] for c in checks.values()),
            "near": sum(c["near"] for c in checks.values()),
            "off": sum(c["off"] for c in checks.values()),
            "size": sum(c["size"] for c in checks.values())}
        by_kind = {}
        for n, c in checks.items():
            kind = re.sub(r"^layers\.\d+\.", "", n)
            acc = by_kind.setdefault(kind, [0, 0, 0])
            for j, k in enumerate(("near", "off", "size")):
                acc[j] += c[k]
        row["near_by_leaf"] = by_kind
        row["replicated"] = {
            n: [sha(p), sha(opt["m"][n]), sha(opt["v"][n])]
            for n, p in params.named_parameters()
            if all(a is None for a in specs[n])}
    u = row["update"]
    row["ok"] = (row["loss_rel"] <= tol["loss"]
                 and row["grad_norm_rel"] <= tol["loss"]
                 and row["grad_rel_l2_max"] <= tol["grad"]
                 and u["rel_l2_max"] <= tol["update"]
                 and u["m_rel_l2_max"] <= tol["update"]
                 and u["v_rel_l2_max"] <= tol["update"]
                 and u["off"] <= u["near"])
    assert row["ok"], row
    del params, opt, state
    torch.cuda.empty_cache()
    return row


def mesh_train_comp(dev, mesh, grads_ref, scalars) -> dict:
    """(f) compressed on this rank of (2, 2): the float32 2-layer model's
    seeded shards, one state stepped uncompressed and one with
    ``MESH_TRAIN["comp"]``'s gradient compression (the error feedback cut
    like the gradients, ``shard_train_state(..., grad_comp=...)``), from
    the same weights.  Each side's first step is its warm-up, and its
    peak device memory is read there, over what was allocated before its
    state was built (less the check's copies).  The compressed first step
    is then held to the one-process compressed step of the same slices,
    recomputed from the parent's gradients (``grads_ref``), lo, hi and
    norm (``scalars``):

    * the inputs of the rule: each leaf group's lo and hi (this rank's:
      one ``pmax`` over the mesh) within the largest gap between the two
      sides' gradients over the group (one ``pmax`` more), as the min and
      max of the global leaf are; the compressed grad norm within
      MESH_TRAIN_TOL["loss"] relative of the one process's plus what the
      decoded values can move it by: each element's decoded value moves
      by at most d = d_dec + |d q| step (below), so the norm by at most
      sum(d (2 |recon| + d)) / norm (one ``psum``);
    * an element whose bin differs between the sides is ``near``.
      Elsewhere both decode one bin q, and the midpoints differ by at
      most d_dec = |d lo| + (q + 1/2) |d step|, the clipped ones by d_clip
      = s d_dec + |d s| |mid| (s the clip scales, mid the one process's
      midpoint, all from the scalars): the parameters are held to
      MESH_TRAIN_TOL["update"] relative L2, ``m`` to that plus the L2 of
      (1 - b1) d_clip, ``v`` of (1 - b2) d_clip (2 |s mid| + d_clip), the
      error feedback of |d g| + d_dec; an element is off past its
      allowance plus 1e-6 relative plus 1e-7, and the elements off are
      at most 4 a near one (the test suite's rule,
      ``tests/test_torch_mesh_train.py``);
    * the control: ``m``, ``v`` and the error feedback as this rank's
      midpoints moved to their bins' lower edges would make them fail
      the same rule, in every leaf;
    * the rank's error feedback bit-equal to its corrected gradient less
      its decoded gradient.

    Then two timed steps a side, plain, compressed, compressed, plain
    (host s around a synchronised step)."""
    import dataclasses

    from repro_torch.launch.shardings import local_shard, shard_train_state
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import init_leaves
    from repro_torch.models.model import reference_path
    from repro_torch.models.sharding import (
        logical_sharding,
        mesh_axis_names,
        pmax,
        psum,
        single_pod_rules,
    )
    from repro_torch.optim import compression as comp_mod
    from repro_torch.optim.adamw import AdamWConfig, _clip_scale, adamw_update
    from repro_torch.optim.compression import GradCompressionConfig

    t = MESH_TRAIN
    f, c = t["f32"], t["comp"]
    tol = MESH_TRAIN_TOL["update"]
    opt_cfg = AdamWConfig(**t["opt"])
    no_clip = dataclasses.replace(opt_cfg, clip_norm=float("inf"))
    b1, b2 = opt_cfg.beta1, opt_cfg.beta2
    cfg = mesh_tp_config(f["layers"], "float32")
    comp = GradCompressionConfig(bits=c["bits"])
    row = {"mesh": list(c["mesh"]), "bits": c["bits"],
           "layers": f["layers"], "tokens": [f["batch"], f["seq"]]}
    scale1 = _clip_scale(torch.tensor(scalars["comp_grad_norm"], device=dev),
                         opt_cfg.clip_norm)
    sides = {}
    with tf32_off(), logical_sharding(mesh, single_pod_rules()):
        batch = mesh_train_batch(cfg, f["batch"], f["seq"], 0, dev)
        for name, gc in (("plain", None), ("compressed", comp)):
            torch.cuda.synchronize(dev)
            base = torch.cuda.memory_allocated(dev)
            state = shard_train_state(cfg, init_leaves(cfg, t["seed"], dev),
                                      mesh, dev, grad_comp=gc)
            params, opt = state["params"], state["opt"]
            del state
            step = make_train_step(cfg, opt_cfg, remat="full", grad_comp=gc)
            copies = 0
            if gc is not None:
                specs = params.pspecs
                initial = {n: p.detach().clone()
                           for n, p in params.named_parameters()}
                _, grads = train_grads(cfg, params, batch)
                groups = comp_mod._groups(grads)
                bounds = comp_mod._bounds(
                    {g: [grads[n] for n in m] for g, m in groups.items()},
                    mesh)
                row["ef_bytes"] = sum(e.numel() * 4
                                      for e in opt["ef"].values())
                copies = sum(x.numel() * x.element_size() for d in
                             (initial, grads) for x in d.values())
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            params, opt, met = step(params, opt, batch)
            torch.cuda.synchronize(dev)
            row[f"{name}_first_step_s"] = time.perf_counter() - t0
            row[f"{name}_peak_bytes"] = (torch.cuda.max_memory_allocated(dev)
                                         - base - copies)
            row[f"{name}_loss"] = float(met["loss"])
            row[f"{name}_grad_norm"] = float(met["grad_norm"])
            sides[name] = [params, opt, step]
        near = off = size = 0
        kinds = ("p", "m", "v", "ef")
        worst = dict.fromkeys(kinds, -float("inf"))
        norm_gap = 0.0  # bounds |sum of dec^2 - sum of recon1^2|
        control = dict.fromkeys(kinds[1:], float("inf"))
        gap_max = dict.fromkeys(groups, 0.0)
        ok = True
        s1 = float(scale1)
        s_r = float(_clip_scale(met["grad_norm"], opt_cfg.clip_norm))
        d_s = abs(s_r - s1)
        for n, p in params.named_parameters():
            group = reference_path(n)[0]
            lo1, hi1 = (torch.tensor(x, dtype=torch.float32, device=dev)
                        for x in scalars["comp_bounds"][group])
            lo_r, hi_r = bounds[group]
            _, step1 = comp_mod._codes(lo1[None], lo1, hi1, c["bits"])
            _, step_r = comp_mod._codes(lo_r[None], lo_r, hi_r, c["bits"])
            d_lo = abs(float(lo_r) - float(lo1))
            d_step = abs(float(step_r) - float(step1))
            # ranks holding each element of the leaf (replicated leaves)
            copies_n = mesh.size() * p.numel() / grads_ref[n].numel()
            flat = {"g1": local_shard(grads_ref[n], specs[n],
                                      mesh).reshape(-1),
                    "g": grads[n].reshape(-1), "p": p.reshape(-1),
                    "p0": initial.pop(n).reshape(-1),
                    **{k: opt[k][n].reshape(-1) for k in ("m", "v", "ef")}}
            # per kind: [gap, allowance, want] squared sums over the kept
            # elements, the rule's and the control's
            sq = {k: [0.0, 0.0, 0.0] for k in kinds}
            sq_ctl = {k: [0.0, 0.0, 0.0] for k in control}
            # a chunk at a time: the checks' float64 scratch of a whole
            # embedding shard, on four ranks, outgrew the card
            for a0 in range(0, flat["g"].numel(), MESH_COMP_CHUNK):
                part = {k: t[a0:a0 + MESH_COMP_CHUNK] for k, t in flat.items()}
                g1, g = part["g1"], part["g"]
                q1, _ = comp_mod._codes(g1, lo1, hi1, c["bits"])
                recon1 = comp_mod._quantize_in(g1, lo1, hi1, c["bits"])
                q_r, _ = comp_mod._codes(g, lo_r, hi_r, c["bits"])
                dec_r = comp_mod._quantize_in(g, lo_r, hi_r, c["bits"])
                ok &= bool(torch.equal(part["ef"], g - dec_r))
                d_g = (g.double() - g1.double()).abs()
                gap_max[group] = max(gap_max[group],
                                     float((g - g1).abs().max()))
                keep = q_r == q1
                zero = torch.zeros_like(g1)
                want, st, _ = adamw_update(
                    no_clip, {n: part["p0"].clone()}, {n: recon1 * scale1},
                    {"m": {n: zero}, "v": {n: zero.clone()},
                     "step": torch.zeros((), dtype=torch.int32, device=dev)})
                mid1 = q1.double().add_(0.5).mul_(float(step1)).add_(
                    float(lo1))
                d_dec = q1.double().add_(0.5).mul_(d_step).add_(d_lo)
                d_clip = s_r * d_dec + d_s * mid1.abs()
                d_any = d_dec + (q_r - q1).abs().double() * float(step_r)
                norm_gap += float((d_any * (2 * recon1.double().abs()
                                            + d_any)).sum()) / copies_n
                allowed = {"p": torch.zeros_like(d_dec),
                           "m": (1 - b1) * d_clip,
                           "v": (1 - b2) * d_clip * (2 * s1 * mid1.abs()
                                                     + d_clip),
                           "ef": d_g + d_dec}
                edge = dec_r.double() - 0.5 * float(step_r)
                wrong = {"m": (1 - b1) * s_r * edge,
                         "v": (1 - b2) * (s_r * edge).square(),
                         "ef": g.double() - edge}
                ys = {"p": want[n], "m": st["m"][n], "v": st["v"][n],
                      "ef": g1 - recon1}
                for kind, x in (("p", part["p"]), ("m", part["m"]),
                                ("v", part["v"]), ("ef", part["ef"])):
                    y = ys[kind].double()
                    gap = (x.double() - y).abs()
                    pairs = [(sq[kind], gap)]
                    if kind in wrong:
                        pairs.append((sq_ctl[kind], (wrong[kind] - y).abs()))
                    for acc, d in pairs:
                        acc[0] += float(d[keep].square().sum())
                        acc[1] += float(allowed[kind][keep].square().sum())
                        acc[2] += float(y[keep].square().sum())
                    off += int((gap > 1e-6 * y.abs() + 1e-7
                                + allowed[kind]).sum())
                    size += x.numel()
                near += 4 * int((~keep).sum())
                del want, st, allowed, wrong, d_dec, d_clip, mid1, edge, d_g
                del d_any
                del q1, q_r, recon1, dec_r
            for table, acc in ((worst, sq), (control, sq_ctl)):
                for kind, (g2, a2, y2) in acc.items():
                    excess = (g2 ** 0.5 - a2 ** 0.5) / max(y2 ** 0.5, 1e-30)
                    table[kind] = (max if table is worst else min)(
                        table[kind], excess)
            del flat
        axes = mesh_axis_names(mesh)
        gaps = pmax(torch.tensor([gap_max[g] for g in groups],
                                 dtype=torch.float32, device=dev), axes, mesh)
        one = scalars["comp_grad_norm"]
        norm_room = float(psum(torch.tensor(norm_gap, dtype=torch.float64,
                                            device=dev), axes, mesh)) / one
        row["grad_norm"] = {"one_process": one,
                            "rel": abs(row["compressed_grad_norm"] / one - 1),
                            "room_rel": norm_room / one}
        norm_ok = (abs(row["compressed_grad_norm"] - one)
                   <= MESH_TRAIN_TOL["loss"] * one + norm_room)
        bound_ok = True
        ratio = 0.0
        for g, gap in zip(groups, gaps.tolist()):
            for got, one in zip(bounds[g], scalars["comp_bounds"][g]):
                # float32, as the gaps: rounding keeps the order
                d = float((got - torch.tensor(one, device=dev)).abs())
                bound_ok &= d <= gap
                ratio = max(ratio, d / gap if gap else float(d > 0))
        row["bounds"] = {"ok": bound_ok, "gap_share_max": ratio}
        row["update"] = {"excess_rel_l2_max": worst,
                         "control_excess_rel_l2_min": control,
                         "near": near, "off": off, "size": size}
        row["ef_equals_corrected_less_decoded"] = ok
        times = {"plain": [], "compressed": []}
        for name in ("plain", "compressed", "compressed", "plain"):
            params, opt, step = sides[name]
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            params, opt, _ = step(params, opt, batch)
            torch.cuda.synchronize(dev)
            times[name].append(time.perf_counter() - t0)
            sides[name] = [params, opt, step]
        row["plain_step_s"] = times["plain"]
        row["compressed_step_s"] = times["compressed"]
    row["ok"] = (ok and bound_ok and norm_ok
                 and max(worst.values()) <= tol
                 and min(control.values()) > tol
                 and off <= near and near <= 0.05 * size)
    assert row["ok"], row
    del params, opt, grads, initial, sides
    torch.cuda.empty_cache()
    return row


def mesh_train_bf16(dev, mesh) -> dict:
    """(f) bf16 on this rank of ``shape``: its shards of the 4-layer
    model's seeded weights and zero moments (the stored bytes held to the
    sum of ``shard_shape`` bytes), a warm-up step (the first step, whose
    loss and grad norm the parent holds to the one-process ones), then
    the timed steps under ``collective_timing`` (each collective behind a
    sync of the card and a barrier of its group; the backward's kinds end
    in `` bwd``), split into forward / backward / optimizer by CUDA
    events (``StepSplit``), with the peak memory."""
    from repro_torch.launch.shardings import (
        NamedSharding,
        opt_pspecs,
        shard_train_state,
    )
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import TransformerLM, init_leaves
    from repro_torch.models.sharding import (
        collective_timing,
        logical_sharding,
        single_pod_rules,
    )
    from repro_torch.optim.adamw import AdamWConfig

    t = MESH_TRAIN
    b = t["bf16"]
    cfg = mesh_tp_config(b["layers"], "bfloat16")
    shape = tuple(mesh.shape)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    state = shard_train_state(cfg, init_leaves(cfg, t["seed"], dev), mesh,
                              dev)
    torch.cuda.synchronize()
    params, opt = state.pop("params"), state.pop("opt")
    specs = opt_pspecs(cfg, mesh, params.pspecs)
    step = make_train_step(cfg, AdamWConfig(**t["opt"]), remat="full")
    row = {"mesh": list(shape), "layers": b["layers"], "dtype": "bfloat16",
           "tokens": [b["batch"], b["seq"]], "remat": "full",
           "init_s": time.perf_counter() - t0}
    losses, norms, step_s, splits = [], [], [], []
    coll = {}
    with logical_sharding(mesh, single_pod_rules()), StepSplit() as split:
        for i in range(1 + b["timed"]):
            batch = mesh_train_batch(cfg, b["batch"], b["seq"], i, dev)
            timing = (collective_timing() if i else contextlib.nullcontext())
            torch.cuda.synchronize()
            with timing as times:
                t0 = time.perf_counter()
                params, opt, met = step(params, opt, batch)
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
            losses.append(float(met["loss"]))
            norms.append(float(met["grad_norm"]))
            if i == 0:
                row["warmup_step_s"] = dt
                continue
            step_s.append(dt)
            splits.append(split.split_ms())
            for kind, c in times.items():
                acc = coll.setdefault(kind, dict.fromkeys(c, 0))
                for k, v in c.items():
                    acc[k] += v
    meta = dict(TransformerLM(cfg, "meta").named_parameters())
    stored = sum(p.numel() * p.element_size() for p in params.parameters())
    stored += sum(t_.numel() * t_.element_size() for k in ("m", "v")
                  for t_ in opt[k].values())
    want = sum(
        int(np.prod(NamedSharding(mesh, specs["m"][n]).shard_shape(p.shape)))
        * (p.element_size() + 8) for n, p in meta.items())
    wall = sum(step_s)
    tokens = b["batch"] * b["seq"]
    med = float(np.median(step_s))
    row.update({
        "losses": losses, "grad_norms": norms, "step_s": stats(step_s),
        "tokens_per_s": tokens / med,
        "split_ms": {k: stats([s[k] for s in splits]) for k in splits[0]},
        "collectives": coll,
        "collective_share": {k: c["s"] / wall for k, c in coll.items()},
        "collective_share_total": sum(c["s"] for c in coll.values()) / wall,
        "wait_share_total": sum(c["wait_s"] for c in coll.values()) / wall,
        "backward_kinds": sorted(k for k in coll if k.endswith(" bwd")),
        "state_bytes": stored, "shard_shape_bytes": want,
        "peak_bytes": torch.cuda.max_memory_allocated(dev) - base,
        "peak_abs": torch.cuda.max_memory_allocated(dev),
    })
    assert all(np.isfinite(losses)) and all(np.isfinite(norms)), row
    assert stored == want, (stored, want)
    assert row["backward_kinds"], coll
    del params, opt
    torch.cuda.empty_cache()
    return row


def mesh_train_resume(dev, mesh, root) -> dict:
    """(f) the smoke config's train state of shards on (2, 2) through
    ``TrainLoop`` with a checkpoint every 2 steps, uninterrupted and
    preempted at step 3 then resumed from the step-2 checkpoint (gathered
    whole and written by rank 0, restored onto the mesh as DTensors and
    cut again): whether the final shards are bit-equal, and whether the
    last checkpoint's leaves equal the final shards gathered whole."""
    import dataclasses

    from repro_torch.checkpoint import (
        CheckpointConfig,
        CheckpointManager,
        load_checkpoint,
    )
    from repro_torch.configs import get_config
    from repro_torch.convert import train_state_shards_from_arrays
    from repro_torch.core.tensor_codec import flatten_pytree
    from repro_torch.launch.shardings import (
        gather_whole,
        opt_pspecs,
        param_pspecs,
        reference_pspecs,
        shard_train_state,
        to_named,
    )
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import TransformerLM, init_leaves
    from repro_torch.models.sharding import (
        PartitionSpec,
        logical_sharding,
        single_pod_rules,
    )
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime.fault_tolerance import (
        PreemptionSchedule,
        TrainLoop,
    )

    t = MESH_TRAIN
    r = t["resume"]
    cfg = dataclasses.replace(get_config(t["arch"]).smoke(), dtype="float32")
    step = make_train_step(cfg, AdamWConfig(**t["opt"]), remat="full")
    pspecs = param_pspecs(cfg, mesh)
    ospecs = opt_pspecs(cfg, mesh, pspecs)
    shardings = to_named(mesh, {
        "params": reference_pspecs(pspecs),
        "opt": {"m": reference_pspecs(ospecs["m"]),
                "v": reference_pspecs(ospecs["v"]), "step": PartitionSpec()}})

    def step_fn(state, i):
        if not isinstance(state["params"], TransformerLM):
            state = train_state_shards_from_arrays(cfg, state, mesh, dev)
        batch = mesh_train_batch(cfg, r["batch"], r["seq"], i, dev)
        with logical_sharding(mesh, single_pod_rules()):
            params, opt, met = step(state["params"], state["opt"], batch)
        return {"params": params, "opt": opt}, {"loss": float(met["loss"])}

    t0 = time.perf_counter()
    runs = {}
    for tag, fail in (("whole", ()), ("preempted", (r["fail_at"],))):
        loop = TrainLoop(step_fn, CheckpointManager(
            CheckpointConfig(os.path.join(root, f"resume_{tag}")),
            device=dev), save_every=r["save_every"],
            preemption=PreemptionSchedule(fail_at=fail))
        state = shard_train_state(cfg, init_leaves(cfg, t["seed"], dev), mesh,
                                  dev)
        runs[tag] = (loop.run(state, r["steps"], shardings=shardings), loop)
    (a, la), (b, lb) = runs["whole"], runs["preempted"]

    def leaves(s):
        out = [p for _, p in s["params"].named_parameters()]
        return out + [s["opt"][k][n] for k in ("m", "v") for n in s["opt"][k]]

    bit_equal = all(torch.equal(x, y) for x, y in zip(leaves(a), leaves(b)))
    ckpt, saved = load_checkpoint(os.path.join(root, "resume_preempted"),
                                  device=dev)
    whole = {"params": {}, "opt": {"m": {}, "v": {}, "step": b["opt"]["step"]}}
    for n, p in b["params"].named_parameters():
        whole["params"][n] = gather_whole(p, pspecs[n], mesh)
        for k in ("m", "v"):
            whole["opt"][k][n] = gather_whole(b["opt"][k][n], pspecs[n], mesh)
    got, want = flatten_pytree(ckpt), flatten_pytree(whole)
    ckpt_equal = set(got) == set(want) and all(
        torch.equal(got[k], want[k]) for k in got)
    row = {"mesh": list(r["mesh"]), "steps": r["steps"],
           "fail_at": r["fail_at"], "restarts": lb.restarts,
           "bit_equal": bit_equal, "ckpt_step": saved,
           "ckpt_equal": ckpt_equal,
           "losses": [m["loss"] for m in la.metrics_log],
           "s": time.perf_counter() - t0}
    assert lb.restarts == 1 and bit_equal and ckpt_equal, row
    assert saved == r["steps"], row
    return row


def mesh_train(dev, root, ref) -> dict:
    """(f) on this rank: float32 against one process, bf16 timed on each
    mesh, the preempted run resumed; K7's and K8's counts set to 0 before
    and read after (training launches neither).  ``ref``: the parent's
    one-process float32 gradients (shared through CUDA IPC) and
    scalars."""
    from repro_torch.launch.mesh import make_host_mesh

    grads_ref, scalars = ref
    meshes = {}

    def mesh_of(shape):
        if shape not in meshes:
            meshes[shape] = make_host_mesh(*shape, device=dev)
        return meshes[shape]

    reset_kernel_launches()
    out, clock = {}, {}
    t0 = time.perf_counter()
    out["f32"] = mesh_train_f32(dev, mesh_of(MESH_TRAIN["f32"]["mesh"]),
                                grads_ref, scalars)
    clock["f32"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["comp"] = mesh_train_comp(dev, mesh_of(MESH_TRAIN["comp"]["mesh"]),
                                  grads_ref, scalars)
    clock["comp"] = time.perf_counter() - t0
    out["bf16"] = []
    for shape in MESH_TRAIN["bf16"]["meshes"]:
        t0 = time.perf_counter()
        out["bf16"].append(mesh_train_bf16(dev, mesh_of(shape)))
        clock[f"bf16_{shape[0]}x{shape[1]}"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["resume"] = mesh_train_resume(dev, mesh_of(MESH_TRAIN["resume"]["mesh"]),
                                      root)
    clock["resume"] = time.perf_counter() - t0
    out["kernel_launches"] = kernel_launch_counts()
    out["part_s"] = clock
    return out


def mesh_train_check(root, scalars) -> dict:
    """(f) across the ranks: every rank's losses and grad norms equal (the
    metrics are global), the replicated leaves' digests equal, the bf16
    first step's loss and grad norm within FAMILY_BF16_OVER_FLOOR times
    bf16's floor (the one-process bf16 value's distance from float32's on
    the same weights) of the one-process bf16 step's, K7 and K8 launched
    0 times.  Returns the ``train_tp`` row (rank 0's figures, each rank's
    peak, the near elements' places summed over the ranks: [near, off,
    size] a leaf kind with any, and the head's split)."""
    ranks = []
    for r in range(MESH_RANKS):
        with open(os.path.join(root, f"rank{r}.json")) as fh:
            ranks.append(json.load(fh)["train_tp"])
    r0 = ranks[0]
    for rk in ranks[1:]:
        assert rk["f32"]["losses"] == r0["f32"]["losses"]
        assert rk["f32"]["grad_norms"] == r0["f32"]["grad_norms"]
        assert rk["f32"]["replicated"] == r0["f32"]["replicated"]
        for a, b in zip(rk["bf16"], r0["bf16"]):
            assert (a["losses"], a["grad_norms"]) == (b["losses"],
                                                      b["grad_norms"])
        assert rk["resume"]["losses"] == r0["resume"]["losses"]
        for k in ("plain_loss", "compressed_loss", "compressed_grad_norm"):
            assert rk["comp"][k] == r0["comp"][k], k
    for rk in ranks:
        assert rk["kernel_launches"] == {"k7": 0, "k8": 0}, rk
    floor = {"loss": abs(scalars["bf16_loss"] - scalars["f32_4_loss"]),
             "grad_norm": abs(scalars["bf16_grad_norm"]
                              - scalars["f32_4_grad_norm"])}
    first = []
    for b in r0["bf16"]:
        row = {"mesh": b["mesh"], "loss": b["losses"][0],
               "grad_norm": b["grad_norms"][0]}
        for k in ("loss", "grad_norm"):
            row[f"{k}_gap"] = abs(row[k] - scalars[f"bf16_{k}"])
            row[f"{k}_bound"] = FAMILY_BF16_OVER_FLOOR * floor[k]
        row["ok"] = all(row[f"{k}_gap"] <= row[f"{k}_bound"]
                        for k in ("loss", "grad_norm"))
        first.append(row)
    assert all(r["ok"] for r in first), first
    near = {}
    for rk in ranks:
        for kind, counts in rk["f32"]["near_by_leaf"].items():
            near[kind] = [a + b for a, b in zip(near.get(kind, [0, 0, 0]),
                                                counts)]
    head = {k: sum(rk["f32"]["head_near"][k] for rk in ranks)
            for k in r0["f32"]["head_near"]}
    return {
        "f32": {k: v for k, v in r0["f32"].items()
                if k not in ("replicated", "near_by_leaf", "head_near")},
        "f32_near_by_leaf": {k: v for k, v in near.items() if v[0] or v[1]},
        "f32_head_near": head,
        "replicated_leaves_equal": len(r0["f32"]["replicated"]),
        "bf16": [{k: v for k, v in b.items()} for b in r0["bf16"]],
        "bf16_one_process": {k: scalars[k] for k in (
            "bf16_loss", "bf16_grad_norm", "f32_4_loss", "f32_4_grad_norm")},
        "bf16_floor": floor, "bf16_first_step": first,
        "bf16_peak_bytes_per_rank": [[b["peak_abs"] for b in rk["bf16"]]
                                     for rk in ranks],
        "resume": r0["resume"],
        "comp": {**r0["comp"], "update": {
            "near": sum(rk["comp"]["update"]["near"] for rk in ranks),
            "off": sum(rk["comp"]["update"]["off"] for rk in ranks),
            "size": sum(rk["comp"]["update"]["size"] for rk in ranks),
            "excess_rel_l2_max": {
                k: max(rk["comp"]["update"]["excess_rel_l2_max"][k]
                       for rk in ranks)
                for k in r0["comp"]["update"]["excess_rel_l2_max"]},
            "control_excess_rel_l2_min": {
                k: min(rk["comp"]["update"]["control_excess_rel_l2_min"][k]
                       for rk in ranks)
                for k in r0["comp"]["update"]["control_excess_rel_l2_min"]}},
            "bounds_gap_share_max": max(rk["comp"]["bounds"]["gap_share_max"]
                                        for rk in ranks),
            "one_process_grad_norm": scalars["comp_grad_norm"],
            **{f"{k}_per_rank": [rk["comp"][k] for rk in ranks] for k in (
                "plain_first_step_s", "compressed_first_step_s",
                "plain_step_s", "compressed_step_s", "plain_peak_bytes",
                "compressed_peak_bytes", "ef_bytes")}},
        "kernel_launches": [rk["kernel_launches"] for rk in ranks],
        "part_s": r0["part_s"],
    }


# (i) tensor-parallel training of the recurrent families and DeepSeek-V3 on
# (1, 4), bf16, seeded weights cut leaf by leaf on each rank: (name, arch,
# config changes, batch, sequence), each 1 + "timed" make_train_step steps
# (AdamW, remat "full").  rwkv6-1.6b cut to 4 layers, 4 x 2,048 (the
# chunked WKV on a rank's 8 of 32 heads); hymba-1.5b cut to 2 layers, 2 x
# 4,096 (the window of 2,048 binds; 25 / 5 heads padded to 36 / 6, 9 a
# rank; more token rows than d_model: the weights route);
# deepseek-v3-671b at full width with phase 13's layer cut (1 dense, 1 MoE
# layer, the MTP head carried) and its routed experts cut to 16 (4 a rank,
# top 8 kept), 1 x 4,096 (the chunked MLA route), plus one
# tensor-parallel mtp_loss gradient at its seeded weights on 1 x 2,048
# ("mtp_tokens": mtp_loss runs no remat, and one process's float32
# chunked scores of 128 heads at 4,096 tokens, kept for the backward,
# outgrow the card).  Each first
# step (and DeepSeek-V3's mtp_loss) is held to one process of the same
# weights within FAMILY_BF16_OVER_FLOOR times bf16's floor.  "f32": the
# float32 first step (gradients only) of a cut of each against the port's
# one process at MESH_TRAIN_TOL: 2 layers, 2 x 256 (RWKV6's on the chunked
# WKV, its gradients held to a float64 witness, FAMILY_F32_WITNESS);
# DeepSeek-V3's with 8 routed experts (top 8) and a vocab of 16,384, whose
# one-process gradients (2.1 B values) go to the ranks through a file.
# Every run draws RWKV6's decay leaves (``rwkv6_decay_draw``)
MESH_TRAIN_FAMILIES = {
    "seed": 0, "mesh": (1, 4), "timed": 2,
    "opt": {"lr": 3e-4, "warmup_steps": 1, "total_steps": 10},
    "mtp_tokens": (1, 2048),
    "runs": (("rwkv6", "rwkv6-1.6b", {"n_layers": 4}, 4, 2048),
             ("hymba", "hymba-1.5b", {"n_layers": 2}, 2, 4096),
             ("dsv3", "deepseek-v3-671b", {"n_experts": 16}, 1, 4096)),
    "f32": (("rwkv6_f32", "rwkv6-1.6b", {"n_layers": 2}, 2, 256),
            ("hymba_f32", "hymba-1.5b", {"n_layers": 2}, 2, 256),
            ("dsv3_f32", "deepseek-v3-671b",
             {"n_experts": 8, "vocab_size": 16384}, 1, 256)),
}


# (i)'s float32 runs held to a float64 witness of the one-process step
# (``float64_arithmetic``) instead of MESH_TRAIN_TOL's gradient bound:
# RWKV6's gradient of the bonus u sums terms that cancel, so every float32
# computation of it lies far from the exact value (the CPU tests read the
# reference's own 1.6e-5 to 1.2e-4 away, tests/mesh_cases.py
# TRAIN_FAMILY_F32_GAPS).  The tensor-parallel gradients pass when no
# farther from the float64 ones than F32_WITNESS_FACTOR times the
# one-process float32 gradients are (the CPU tests' factor)
FAMILY_F32_WITNESS = ("rwkv6_f32",)
F32_WITNESS_FACTOR = 3.0


@contextlib.contextmanager
def float64_arithmetic():
    """The port's float32 arithmetic carried out in float64 inside:
    ``torch.float32`` and ``Tensor.float`` name float64, so the explicit
    float32 casts of the WKV, the norms and the products widen instead.
    What a float32 computation of the same step rounds: a witness, not a
    route of the port."""
    f32, flt = torch.float32, torch.Tensor.float
    torch.float32, torch.Tensor.float = torch.float64, torch.Tensor.double
    try:
        yield
    finally:
        torch.float32, torch.Tensor.float = f32, flt


def rwkv6_decay_draw(name: str, t: torch.Tensor, seed: int) -> torch.Tensor:
    """RWKV6's decay leaves drawn in place of their init values, as the CPU
    tests draw them (``tests/mesh_cases.py`` ``rwkv6_draws``): the bonus u
    (0 at init, where a fault that depends on it could not show) 0.1
    N(0, 1), w0 uniform in [-3, -0.5], the LoRA factors 0.1 N(0, 1); each
    from a generator seeded by ``seed`` and the leaf's name.  Other
    leaves unchanged."""
    import zlib

    leaf = name.rpartition(".")[2]
    if ".attn." not in name or leaf not in ("u", "w0", "w_lora_a",
                                            "w_lora_b"):
        return t
    gen = torch.Generator(device=t.device).manual_seed(
        seed * 1_000_003 + zlib.crc32(name.encode()))
    out = torch.empty(t.shape, dtype=torch.float32, device=t.device)
    if leaf == "w0":
        out.uniform_(-3.0, -0.5, generator=gen)
    else:
        out.normal_(0.0, 0.1, generator=gen)
    return out.to(t.dtype)


def family_leaves(cfg, dev):
    """(i)'s weights, leaf by leaf: ``init_leaves`` of its seed, RWKV6's
    decay leaves drawn (``rwkv6_decay_draw``)."""
    from repro_torch.models import init_leaves

    seed = MESH_TRAIN_FAMILIES["seed"]
    for name, t in init_leaves(cfg, seed, dev):
        yield name, rwkv6_decay_draw(name, t, seed)


def family_params(cfg, dev):
    """``family_leaves`` as one whole ``TransformerLM``."""
    from repro_torch.models import TransformerLM

    params = TransformerLM(cfg, dev)
    own = dict(params.named_parameters())
    with torch.no_grad():
        for name, t in family_leaves(cfg, dev):
            own[name].copy_(t)
    return params


def family_train_batch(cfg, batch, seq, dev) -> dict:
    """(i)'s seeded next-token batch, the same on every rank: tokens,
    labels and, for ``mtp_loss``, the tokens two places ahead."""
    host = torch.Generator().manual_seed(2000)
    tok = torch.randint(0, cfg.vocab_size, (batch, seq + 2), generator=host)
    return {"tokens": tok[:, :seq].to(dev), "labels": tok[:, 1:-1].to(dev),
            "labels_next2": tok[:, 2:].to(dev)}


def rel_l2_or_zero(got: torch.Tensor, want: torch.Tensor) -> float:
    """``rel_l2``, or 0 where both are all zero (the MTP head's gradient
    under ``loss_fn``), inf where only ``want`` is."""
    if not bool(want.any()):
        return 0.0 if not bool(got.any()) else float("inf")
    return rel_l2(got, want)


def mesh_train_families_reference(dev, root) -> dict:
    """(i)'s one-process runs, in this process before the ranks start,
    each model freed before the next.  float32 cuts (TF32 off): the first
    step's loss and grad norm, the gradients written to ``root`` for the
    ranks, and for FAMILY_F32_WITNESS the same step's gradients in
    float64 (``float64_arithmetic``) beside them.  bf16 runs: the first
    step's loss and grad norm, then those of the same weights in float32
    (bf16's floor); DeepSeek-V3's mtp_loss too."""
    import dataclasses

    from repro_torch.launch.steps import mtp_loss_and_grads
    from repro_torch.models import TransformerLM
    from repro_torch.optim.adamw import _global_norm

    t = MESH_TRAIN_FAMILIES
    out = {}
    with tf32_off():
        for name, arch, changes, b, s in t["f32"]:
            cfg = family_config(arch, dtype="float32", **changes)
            params = family_params(cfg, dev)
            batch = family_train_batch(cfg, b, s, dev)
            t0 = time.perf_counter()
            loss, grads = train_grads(cfg, params, batch)
            out[name] = {"loss": loss, "grad_norm": float(_global_norm(grads)),
                         "s": time.perf_counter() - t0}
            torch.save({n: g.cpu() for n, g in grads.items()},
                       os.path.join(root, f"{name}.pt"))
            del grads
            if name in FAMILY_F32_WITNESS:
                t0 = time.perf_counter()
                with float64_arithmetic():
                    wide = dataclasses.replace(cfg, dtype="float64")
                    p64 = TransformerLM(wide, dev)
                    with torch.no_grad():
                        for a, w in zip(p64.parameters(),
                                        params.parameters()):
                            a.copy_(w)
                    loss64, g64 = train_grads(wide, p64, batch)
                    out[name].update(f64_loss=loss64,
                                     f64_grad_norm=float(_global_norm(g64)),
                                     f64_s=time.perf_counter() - t0)
                torch.save({n: g.cpu() for n, g in g64.items()},
                           os.path.join(root, f"{name}_f64.pt"))
                del p64, g64
            del params
            torch.cuda.empty_cache()
    def scalars(cfg, params, batch, mtp_batch, tag, row):
        with tf32_off():
            loss, g = train_grads(cfg, params, batch)
            row[f"{tag}_loss"] = loss
            row[f"{tag}_grad_norm"] = float(_global_norm(g))
            del g
            if cfg.mtp_depth:
                loss, g = mtp_loss_and_grads(cfg, params, mtp_batch)
                row[f"{tag}_mtp_loss"] = float(loss.detach())
                row[f"{tag}_mtp_grad_norm"] = float(_global_norm(g))
                del g
        torch.cuda.empty_cache()

    for name, arch, changes, b, s in t["runs"]:
        row = {}
        cfg = family_config(arch, dtype="bfloat16", **changes)
        batch = family_train_batch(cfg, b, s, dev)
        mtp_batch = family_train_batch(cfg, *t["mtp_tokens"], dev)
        params = family_params(cfg, dev)
        scalars(cfg, params, batch, mtp_batch, "bf16", row)
        cfg32 = family_config(arch, dtype="float32", **changes)
        params32 = TransformerLM(cfg32, dev)
        with torch.no_grad():
            for a, w in zip(params32.parameters(), params.parameters()):
                a.copy_(w.float())
        del params
        torch.cuda.empty_cache()
        scalars(cfg32, params32, batch, mtp_batch, "f32", row)
        del params32
        torch.cuda.empty_cache()
        out[name] = row
    return out


def family_train_f32(dev, mesh, root, run) -> dict:
    """(i) float32 on this rank: its shards of the cut's seeded weights,
    the first step's loss, grad norm (from the shards) and gradient
    shards, the last against the one-process gradients' slices read from
    ``root``; for FAMILY_F32_WITNESS each shard's and the one-process
    slice's distance from the float64 slice too."""
    from repro_torch.launch.shardings import local_shard, shard_params
    from repro_torch.models.sharding import logical_sharding, single_pod_rules
    from repro_torch.optim.adamw import _global_norm

    name, arch, changes, b, s = run
    cfg = family_config(arch, dtype="float32", **changes)
    t0 = time.perf_counter()
    with tf32_off(), logical_sharding(mesh, single_pod_rules()):
        params = shard_params(cfg, family_leaves(cfg, dev), mesh, dev)
        loss, grads = train_grads(cfg, params,
                                  family_train_batch(cfg, b, s, dev))
        norm = float(_global_norm(grads, params))

    def slices(file):
        whole = torch.load(os.path.join(root, file), mmap=True)
        return {n: local_shard(whole[n], params.pspecs[n], mesh).to(dev)
                for n in grads}

    want = slices(f"{name}.pt")
    rels = sorted(((rel_l2_or_zero(g, want[n]), n)
                   for n, g in grads.items()), reverse=True)
    row = {"run": name, "layers": cfg.n_layers, "tokens": [b, s],
           "loss": loss, "grad_norm": norm, "grad_rel_l2_max": rels[0][0],
           "worst_leaves": rels[:3]}
    if name in FAMILY_F32_WITNESS:
        exact = slices(f"{name}_f64.pt")
        for who, got in (("tp", grads), ("one_process", want)):
            gaps = sorted(((rel_l2_or_zero(got[n], x), n)
                           for n, x in exact.items()), reverse=True)
            row[f"{who}_f64_rel_l2_max"] = gaps[0][0]
            row[f"{who}_f64_worst_leaves"] = gaps[:3]
        del exact
    del params, grads, want
    torch.cuda.empty_cache()
    return dict(row, s=time.perf_counter() - t0)


def family_train_bf16(dev, mesh, run) -> dict:
    """(i) bf16 on this rank: its train state of shards (the stored bytes
    held to the sum of ``shard_shape`` bytes), DeepSeek-V3's mtp_loss
    gradient at the seeded weights, then 1 + ``timed`` steps, the timed
    ones under ``collective_timing`` and split by CUDA events
    (``StepSplit``), with the peak memory (the ``mesh_train_bf16``
    pattern)."""
    from repro_torch.launch.shardings import (
        NamedSharding,
        opt_pspecs,
        shard_train_state,
    )
    from repro_torch.launch.steps import make_train_step, mtp_loss_and_grads
    from repro_torch.models import TransformerLM
    from repro_torch.models.sharding import (
        collective_timing,
        logical_sharding,
        single_pod_rules,
    )
    from repro_torch.optim.adamw import AdamWConfig, _global_norm

    t = MESH_TRAIN_FAMILIES
    name, arch, changes, b, s = run
    cfg = family_config(arch, dtype="bfloat16", **changes)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    state = shard_train_state(cfg, family_leaves(cfg, dev), mesh, dev)
    params, opt = state.pop("params"), state.pop("opt")
    torch.cuda.synchronize()
    row = {"run": name, "arch": arch, "mesh": list(t["mesh"]),
           "layers": cfg.n_layers, "experts": cfg.n_experts,
           "tokens": [b, s], "remat": "full",
           "init_s": time.perf_counter() - t0,
           "init_peak_bytes": torch.cuda.max_memory_allocated(dev) - base}
    step = make_train_step(cfg, AdamWConfig(**t["opt"]), remat="full")
    batch = family_train_batch(cfg, b, s, dev)
    losses, norms, step_s, splits, coll = [], [], [], [], {}
    with logical_sharding(mesh, single_pod_rules()):
        if cfg.mtp_depth:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss, g = mtp_loss_and_grads(
                cfg, params, family_train_batch(cfg, *t["mtp_tokens"], dev))
            norm = float(_global_norm(g, params))
            row["mtp"] = {"tokens": list(t["mtp_tokens"]),
                          "loss": float(loss.detach()), "grad_norm": norm,
                          "s": time.perf_counter() - t0,
                          "mtp_leaves_nonzero": sum(
                              bool(x.any()) for n, x in g.items()
                              if n.startswith("mtp."))}
            del g, loss
            torch.cuda.empty_cache()
        with StepSplit() as split:
            for i in range(1 + t["timed"]):
                timing = (collective_timing() if i
                          else contextlib.nullcontext())
                torch.cuda.synchronize()
                with timing as times:
                    t0 = time.perf_counter()
                    params, opt, met = step(params, opt, batch)
                    torch.cuda.synchronize()
                    dt = time.perf_counter() - t0
                losses.append(float(met["loss"]))
                norms.append(float(met["grad_norm"]))
                if i == 0:
                    row["first_step_s"] = dt
                    continue
                step_s.append(dt)
                splits.append(split.split_ms())
                for kind, c in times.items():
                    acc = coll.setdefault(kind, dict.fromkeys(c, 0))
                    for k, v in c.items():
                        acc[k] += v
    # after the steps: the moments are float32 from the first update on
    specs = opt_pspecs(cfg, mesh, params.pspecs)
    meta = dict(TransformerLM(cfg, "meta").named_parameters())
    stored = sum(p.numel() * p.element_size() for p in params.parameters())
    stored += sum(x.numel() * x.element_size() for k in ("m", "v")
                  for x in opt[k].values())
    want = sum(
        int(np.prod(NamedSharding(mesh, specs["m"][n]).shard_shape(p.shape)))
        * (p.element_size() + 8) for n, p in meta.items())
    wall = sum(step_s)
    row.update({
        "losses": losses, "grad_norms": norms, "step_s": stats(step_s),
        "tokens_per_s": b * s / float(np.median(step_s)),
        "split_ms": {k: stats([x[k] for x in splits]) for k in splits[0]},
        "collectives": coll,
        "collective_share": {k: c["s"] / wall for k, c in coll.items()},
        "collective_share_total": sum(c["s"] for c in coll.values()) / wall,
        "wait_share_total": sum(c["wait_s"] for c in coll.values()) / wall,
        "backward_kinds": sorted(k for k in coll if k.endswith(" bwd")),
        "state_bytes": stored, "shard_shape_bytes": want,
        "peak_bytes": torch.cuda.max_memory_allocated(dev) - base,
        "peak_abs": torch.cuda.max_memory_allocated(dev),
    })
    assert all(np.isfinite(losses)) and all(np.isfinite(norms)), row
    assert stored == want, (stored, want)
    assert row["backward_kinds"], coll
    del params, opt, batch
    torch.cuda.empty_cache()
    return row


@contextlib.contextmanager
def rank_report(rank, run):
    """A rank's failure printed with its rank and run before it
    propagates (the spawner reports only the first rank to fail, often
    one whose peer had died), and the run's end with its peak memory."""
    import traceback

    try:
        yield
    except BaseException:
        print(f"(i) rank {rank} run {run} failed:\n"
              f"{traceback.format_exc()}", file=sys.stderr, flush=True)
        raise
    print(f"(i) rank {rank} run {run} done, peak "
          f"{torch.cuda.max_memory_allocated()} B", file=sys.stderr,
          flush=True)


def mesh_train_families_rank(rank, root, device):
    """One of (i)'s MESH_RANKS ranks on ``device``: the float32 checks,
    then the bf16 runs; K7's and K8's counts set to 0 before and read
    after (training launches neither)."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh

    with mesh_group(rank, root, device) as (dev, backend):
        mesh = make_host_mesh(*MESH_TRAIN_FAMILIES["mesh"], device=dev)
        reset_kernel_launches()
        out = {"rank": rank, "backend": backend, "part_s": {}}
        t0 = time.perf_counter()
        out["f32"] = []
        for run in MESH_TRAIN_FAMILIES["f32"]:
            with rank_report(rank, run[0]):
                out["f32"].append(family_train_f32(dev, mesh, root, run))
        out["part_s"]["f32"] = time.perf_counter() - t0
        out["bf16"] = []
        for run in MESH_TRAIN_FAMILIES["runs"]:
            t0 = time.perf_counter()
            with rank_report(rank, run[0]):
                out["bf16"].append(family_train_bf16(dev, mesh, run))
            out["part_s"][run[0]] = time.perf_counter() - t0
        out["kernel_launches"] = kernel_launch_counts()
        with open(os.path.join(root, f"rank{rank}.json"), "w") as fh:
            json.dump(out, fh)
        dist.barrier()


def mesh_train_families_check(ranks, ref) -> dict:
    """(i) across the ranks: the metrics equal on every rank, K7 and K8
    launched 0 times; the float32 first steps within MESH_TRAIN_TOL of one
    process (FAMILY_F32_WITNESS's gradients within F32_WITNESS_FACTOR
    times the one process's distance from the float64 ones); each bf16 first step's (and DeepSeek-V3's mtp_loss's) loss
    and grad norm within FAMILY_BF16_OVER_FLOOR times bf16's floor of one
    process's.  Returns the ``{"mesh_train_families"}`` row's figures,
    ``ok`` whether every first step met its bound."""
    tol = MESH_TRAIN_TOL
    r0 = ranks[0]

    def worst(run, key):
        return max(y[key] for rk in ranks for y in rk["f32"]
                   if y["run"] == run)

    for rk in ranks[1:]:
        for a, b in zip(rk["f32"], r0["f32"]):
            assert (a["loss"], a["grad_norm"]) == (b["loss"], b["grad_norm"])
        for a, b in zip(rk["bf16"], r0["bf16"]):
            assert (a["losses"], a["grad_norms"]) == (b["losses"],
                                                      b["grad_norms"])
    for rk in ranks:
        assert rk["kernel_launches"] == {"k7": 0, "k8": 0}, rk
    f32 = []
    for x in r0["f32"]:
        one = ref[x["run"]]
        row = dict(x, one_process=one,
                   loss_rel=abs(x["loss"] / one["loss"] - 1),
                   grad_norm_rel=abs(x["grad_norm"] / one["grad_norm"] - 1),
                   grad_rel_l2_max=worst(x["run"], "grad_rel_l2_max"))
        if x["run"] in FAMILY_F32_WITNESS:
            for who in ("tp", "one_process"):
                row[f"{who}_f64_rel_l2_max"] = worst(
                    x["run"], f"{who}_f64_rel_l2_max")
            row["f64_bound"] = (F32_WITNESS_FACTOR
                                * row["one_process_f64_rel_l2_max"])
            grads_ok = row["tp_f64_rel_l2_max"] <= row["f64_bound"]
        else:
            grads_ok = row["grad_rel_l2_max"] <= tol["grad"]
        row["ok"] = (row["loss_rel"] <= tol["loss"]
                     and row["grad_norm_rel"] <= tol["loss"] and grads_ok)
        f32.append(row)
    first = []
    for x in r0["bf16"]:
        one = ref[x["run"]]
        got = {"loss": x["losses"][0], "grad_norm": x["grad_norms"][0]}
        if "mtp" in x:
            got.update(mtp_loss=x["mtp"]["loss"],
                       mtp_grad_norm=x["mtp"]["grad_norm"])
        row = {"run": x["run"], "one_process": one}
        for k, v in got.items():
            floor = abs(one[f"bf16_{k}"] - one[f"f32_{k}"])
            row[k] = v
            row[f"{k}_gap"] = abs(v - one[f"bf16_{k}"])
            row[f"{k}_bound"] = FAMILY_BF16_OVER_FLOOR * floor
        row["ok"] = all(row[f"{k}_gap"] <= row[f"{k}_bound"] for k in got)
        first.append(row)
    return {
        "ok": all(r["ok"] for r in f32 + first),
        "f32": f32, "bf16": r0["bf16"], "bf16_first_step": first,
        "peak_bytes_per_rank": [[x["peak_abs"] for x in rk["bf16"]]
                                for rk in ranks],
        "kernel_launches": [rk["kernel_launches"] for rk in ranks],
        "ranks_part_s": r0["part_s"],
    }


def phase_mesh_train_families(dev) -> dict:
    """Phase 15 (i): the one-process runs in this process
    (``mesh_train_families_reference``), then MESH_RANKS ranks spawned on
    the one card (``mesh_train_families_rank``), then the checks
    (``mesh_train_families_check``).  Returns the
    ``{"mesh_train_families"}`` row."""
    import tempfile

    import torch.multiprocessing as mp

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    row = {"card": smi_line(), "ranks": MESH_RANKS,
           "backend": mesh_backend(MESH_RANKS, torch.cuda.device_count()),
           "parent_allocated_bytes": torch.cuda.memory_allocated(dev),
           "parent_reserved_bytes": torch.cuda.memory_reserved(dev)}
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        ref = mesh_train_families_reference(dev, root)
        row["reference_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        # the ranks' allocator maps memory in growable segments: four
        # processes share the one card, and with fixed segments four
        # DeepSeek-V3 ranks left 3.6 GB a rank reserved but unallocated
        saved = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
        os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
        try:
            mp.spawn(mesh_train_families_rank, args=(root, str(dev)),
                     nprocs=MESH_RANKS, join=True)
        finally:
            if saved is None:
                del os.environ["PYTORCH_CUDA_ALLOC_CONF"]
            else:
                os.environ["PYTORCH_CUDA_ALLOC_CONF"] = saved
        row["ranks_s"] = time.perf_counter() - t0
        ranks = []
        for r in range(MESH_RANKS):
            with open(os.path.join(root, f"rank{r}.json")) as fh:
                ranks.append(json.load(fh))
    row.update(mesh_train_families_check(ranks, ref))
    row["phase_s"] = time.perf_counter() - t_phase
    if not row["ok"]:  # the figures first, then the failure
        log(json.dumps({"mesh_train_families": row}))
        raise AssertionError("phase 15 (i): a first step missed its bound")
    return row


def mesh_train_families_main() -> None:
    """``--mesh-train-families``: phase 15 (i) alone (training launches no
    kernel, none is built): one ``{"mesh_train_families"}`` line."""
    dev = phase_environment()
    log(json.dumps({"mesh_train_families": phase_mesh_train_families(dev)}))
    print(json.dumps({"ok": True}), flush=True)


def phase_mesh(dev) -> tuple[dict, list, list]:
    """Phase 15: (e)'s, (g)'s, (h)'s and (f)'s one-process runs in this
    process, each model freed before the next, then MESH_RANKS ranks
    spawned on the one card (the kernels are built before, in this
    process), running (a)-(h) (``mesh_rank``; (f)'s float32 gradients
    shared with them through CUDA IPC); then this process's checks: (a)'s
    logits against a dense prefill, (b)'s against the unpadded prefill,
    (c) against its one-process replay, (e), (g) and (h) against their
    one-process runs, (f) across the ranks
    (``mesh_train_check``); K7 at (b)'s, (e)'s and (g)'s launches and K8
    at (g)'s against their plain versions.  Returns the ``{"mesh"}`` row
    and each rank's K7 launches in the timed prefills of (a), (b), (e)
    and (g), and its K8 launches in (g)'s."""
    import tempfile

    import torch.multiprocessing as mp

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    backend = mesh_backend(MESH_RANKS, torch.cuda.device_count())
    row = {"card": smi_line(), "ranks": MESH_RANKS,
           "cards": torch.cuda.device_count(), "backend": backend}
    log(json.dumps({"mesh_backend": backend, "ranks": MESH_RANKS,
                    "cards": row["cards"], "why": mesh_backend.__doc__}))
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        row["tp_reference"] = mesh_tp_reference(dev, root, serve_runs("e"))
        row["tp_reference_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        row["rec_reference"] = mesh_tp_reference(dev, root,
                                                 serve_runs("g"))
        row["rec_reference_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        row["mla_reference"] = mesh_tp_reference(dev, root,
                                                 serve_runs("h"))
        row["mla_reference_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        train_ref = mesh_train_reference(dev)
        row["train_reference_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        mp.spawn(mesh_rank, args=(root, str(dev), train_ref),
                 nprocs=MESH_RANKS, join=True)
        train_scalars = train_ref[1]
        del train_ref
        torch.cuda.empty_cache()
        row["ranks_s"] = time.perf_counter() - t0
        ranks = []
        for r in range(MESH_RANKS):
            with open(os.path.join(root, f"rank{r}.json")) as fh:
                ranks.append(json.load(fh))
        for rk in ranks[1:]:  # every rank returns the whole output
            for a, b in zip(rk["granite"], ranks[0]["granite"]):
                assert a["logits"] == b["logits"], "ranks' logits differ"
            assert rk["hymba"]["logits"] == ranks[0]["hymba"]["logits"]
            assert [(x["loss"], x["grad_norm"]) for x in rk["wire"]["steps"]
                    ] == [(x["loss"], x["grad_norm"])
                          for x in ranks[0]["wire"]["steps"]]
            for a, b in zip(rk["tp"] + rk["rec"],
                            ranks[0]["tp"] + ranks[0]["rec"]):
                assert a["logits"] == b["logits"], "ranks' TP logits differ"
        t0 = time.perf_counter()
        row["granite_vs_dense"] = mesh_granite_check(dev, root)
        torch.cuda.empty_cache()
        row["hymba_vs_unpadded"] = mesh_hymba_check(dev, root)
        torch.cuda.empty_cache()
        row["wire_replay"] = mesh_wire_replay(dev, ranks)
        torch.cuda.empty_cache()
        row["tp_vs_one_process"] = mesh_tp_check(root, serve_runs("e"))
        row["rec_vs_one_process"] = mesh_tp_check(root, serve_runs("g"))
        row["mla_vs_one_process"] = mesh_tp_check(root, serve_runs("h"))
        row["checks_s"] = time.perf_counter() - t0
        row["train_tp"] = mesh_train_check(root, train_scalars)
        row["train_tp"]["card"] = row["card"]
    row["k7_padded_launch"] = mesh_k7_timing(dev)
    row["k7_tp_launch"] = mesh_k7_tp_timing(dev)
    row["k7_rec_launch"] = mesh_k7_rec_timing(dev)
    row["k8_rec_launch"] = mesh_k8_rec_timing(dev)
    r0 = ranks[0]
    row["granite"] = [{k: v for k, v in g.items() if k != "logits"}
                      for g in r0["granite"]]
    row["hymba"] = {k: v for k, v in r0["hymba"].items() if k != "logits"}
    row["wire"] = {k: r0["wire"][k] for k in ("steps", "numel",
                                              "wire_bytes_per_step")}
    row["ckpt"] = r0["ckpt"]
    row["tp"] = [{k: v for k, v in t.items() if k != "logits"}
                 for t in r0["tp"]]
    row["tp_peak_bytes_per_rank"] = [[t["peak_bytes"] for t in rk["tp"]]
                                     for rk in ranks]
    row["rec"] = [{k: v for k, v in t.items() if k != "logits"}
                  for t in r0["rec"]]
    row["rec_peak_bytes_per_rank"] = [[t["peak_bytes"] for t in rk["rec"]]
                                      for rk in ranks]
    row.update(mesh_mla_rows(ranks))
    for rk in ranks:  # each bf16 (1, 4) run's kernel at its launch shape
        for t in rk["rec"]:
            if t["run"] in MESH_RECURRENT["launch"]:
                kernel, shape = MESH_RECURRENT["launch"][t["run"]]
                assert t["launch_shapes"] == {kernel: [shape]}, t
    row["transports"] = r0["transports"]
    for key, how in r0["transports"].items():
        log(json.dumps({"mesh_transport": key, "carried": how}))
    row["part_s"] = r0["part_s"]
    row["max_memory_allocated"] = [rk["max_memory_allocated"] for rk in ranks]
    row["max_memory_allocated_sum"] = sum(row["max_memory_allocated"])
    k7 = [sum(g["k7_launches"] for g in rk["granite"])
          + rk["hymba"]["k7_launches"]
          + sum(t["k7_launches"] for t in rk["tp"] + rk["rec"])
          for rk in ranks]
    k8 = [sum(t["k8_launches"] for t in rk["rec"]) for rk in ranks]
    row["k7_launches_per_rank"] = k7
    row["k8_launches_per_rank"] = k8
    row["phase_s"] = time.perf_counter() - t_phase
    return row, k7, k8


def mesh_mla_main() -> None:
    """``--mesh-mla``: phase 15 (h) alone (no kernel reached, none built):
    the one-process runs, the ranks, the checks, one ``{"mesh_mla"}``
    line."""
    import tempfile

    import torch.multiprocessing as mp

    dev = phase_environment()
    t_phase = time.perf_counter()
    row = {"card": smi_line()}
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        row["mla_reference"] = mesh_tp_reference(dev, root,
                                                 serve_runs("h"))
        row["mla_reference_s"] = time.perf_counter() - t0
        mp.spawn(mesh_mla_rank, args=(root, str(dev)), nprocs=MESH_RANKS,
                 join=True)
        ranks = []
        for r in range(MESH_RANKS):
            with open(os.path.join(root, f"rank{r}.json")) as fh:
                ranks.append(json.load(fh))
        row["mla_vs_one_process"] = mesh_tp_check(root, serve_runs("h"))
    row.update(mesh_mla_rows(ranks))
    row["max_memory_allocated"] = [max(t["peak_abs"] for t in rk["mla"])
                                   for rk in ranks]
    row["phase_s"] = time.perf_counter() - t_phase
    log(json.dumps({"mesh_mla": row}))
    print(json.dumps({"ok": True}), flush=True)


def mesh_main() -> None:
    """``--mesh``: K7's parity cases and phase 15 alone."""
    from repro_torch.kernels import build

    dev = phase_environment()
    build.build(["flash_attention", "rwkv6_scan"])
    errs = []
    phase_flash_parity(dev, errs)
    row, launches, k8_launches = phase_mesh(dev)
    log(json.dumps({"mesh": row}))
    log(json.dumps({"k7_mesh_launches": launches,
                    "k8_mesh_launches": k8_launches,
                    "k7_max_abs_err": max(errs)}))
    print(json.dumps({"ok": True}), flush=True)


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
    models, train_launches = phase_training(dev)
    clock["training"] = time.perf_counter()
    phase_train_again(dev, models["regression"][0])
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
    served, fleet_launches, build_rows, forests = phase_fleet_serving(
        dev, bench_stores)
    k5, fleet = fleet_entry(served, fleet_launches, build_rows, fleet_rows)
    for entry in out:
        if entry["name"] in (K1["name"], K2["name"]):
            entry["fleet_launches"] = fleet_launches[entry["name"]]
        if entry["name"] == K1["name"]:
            entry["fleet"] = {task: fleet[task]["k1"] for task in served}
    out.append(k5)
    log(json.dumps({"fleet": fleet}))
    clock["fleet"] = time.perf_counter()

    store, requests, want = served["classification"]
    life, life_launches = phase_store_lifecycle(
        dev, store, forests["classification"], requests, want)
    for entry in out:
        if entry["name"] in (K1["name"], K2["name"], K5["name"]):
            entry["lifecycle_launches"] = life_launches[entry["name"]]
    log(json.dumps({"store_lifecycle": life}))
    clock["store_lifecycle"] = time.perf_counter()

    online, online_launches = phase_online(dev, store)
    for entry in out:
        if entry["name"] in (K1["name"], K2["name"], K5["name"]):
            entry["online_launches"] = online_launches[entry["name"]]
    log(json.dumps({"online": online}))
    clock["online"] = time.perf_counter()

    families, family_launches = phase_families(dev, flash_errs)
    for entry in out:
        if entry["name"] == K7["name"]:
            entry["families_launches"] = family_launches
            entry["max_abs_err"] = max(flash_errs)
            entry["families"] = {m["model"]: m["k7"]
                                 for m in families["models"] if "k7" in m}
    assert family_launches > 0, family_launches
    log(json.dumps({"families": families}))
    clock["families"] = time.perf_counter()

    train = phase_train(dev)
    log(json.dumps({"train": train}))
    clock["train"] = time.perf_counter()

    mesh, mesh_launches, mesh_k8 = phase_mesh(dev)
    for entry in out:
        if entry["name"] == K7["name"]:
            entry["mesh_launches_per_rank"] = mesh_launches
            entry["mesh_tp_recurrent"] = mesh["k7_rec_launch"]
        if entry["name"] == K8["name"]:
            entry["mesh_launches_per_rank"] = mesh_k8
            entry["mesh_tp_recurrent"] = mesh["k8_rec_launch"]
    assert min(mesh_launches) > 0 and min(mesh_k8) > 0, (mesh_launches,
                                                         mesh_k8)
    log(json.dumps({"mesh": mesh}))
    clock["mesh"] = time.perf_counter()
    log(json.dumps({"mesh_train_families": phase_mesh_train_families(dev)}))
    clock["mesh_train_families"] = time.perf_counter()
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
    elif len(sys.argv) > 1 and sys.argv[1] == "--lifecycle":
        lifecycle_main()
    elif len(sys.argv) > 1 and sys.argv[1] == "--online":
        online_main()
    elif len(sys.argv) > 1 and sys.argv[1] == "--families":
        families_main()
    elif len(sys.argv) > 1 and sys.argv[1] == "--train":
        train_main()
    elif len(sys.argv) > 1 and sys.argv[1] == "--mesh":
        mesh_main()
    elif len(sys.argv) > 1 and sys.argv[1] == "--mesh-mla":
        mesh_mla_main()
    elif len(sys.argv) > 1 and sys.argv[1] == "--mesh-train-families":
        mesh_train_families_main()
    else:
        main()
