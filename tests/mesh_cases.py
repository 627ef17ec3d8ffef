"""Inputs shared by both sides of ``tests/test_torch_mesh_spmd.py`` (the
reference's process, ``torch_mesh_reference.py``, and the port's ranks,
``torch_mesh_ranks.py``): configs, seeds and numpy-made inputs.  Imports
numpy only."""
import dataclasses

import numpy as np

MOE_SEED = 3
#: case -> (data, model, experts): granite-moe's smoke config (8 experts,
#: top 2, capacity factor 1.25) on two meshes, and 6 experts padded to 8
#: on a 4-way model axis
MOE_CASES = {"1x4": (1, 4, 8), "2x2": (2, 2, 8), "pad6_1x4": (1, 4, 6)}
MOE_X_SHAPE = (4, 16, 128)

WIRE_BITS = (4, 8)
WIRE_KEY = 7
WIRE_GEN_DRAWS = 200

STEP_SEED = 0
STEP_STEPS = 3
STEP_BITS = 8
STEP_OPT = {"lr": 1e-3, "warmup_steps": 1, "total_steps": 4}
STEP_BATCH = (4, 16)  # global (B, S): one row per rank of a (4, 1) mesh

CKPT_SEED = 1

ATTN_SEED = 5
ATTN_X_SHAPE = (2, 16, 128)


def moe_config(get_config, n_experts: int):
    return dataclasses.replace(get_config("granite-moe-3b-a800m").smoke(),
                               n_experts=n_experts, dtype="float32")


def moe_input() -> np.ndarray:
    return np.random.default_rng(MOE_SEED).normal(
        size=MOE_X_SHAPE).astype(np.float32)


def wire_grads() -> dict[str, np.ndarray]:
    """Per-rank gradients, stacked on a leading axis of 4 ranks: each
    rank at its own scale, one leaf with a zero rank."""
    rng = np.random.default_rng(11)
    scales = np.array([1.0, 0.5, 2.0, 0.25], np.float32)
    a = rng.normal(size=(4, 33, 17)).astype(np.float32) * scales[:, None, None]
    b = rng.standard_t(3, size=(4, 1000)).astype(np.float32) * np.float32(1e-3)
    b[2] = 0.0
    return {"a": a, "b": b}


def step_config(get_config):
    return dataclasses.replace(get_config("qwen3-4b").smoke(),
                               dtype="float32")


def step_batch(cfg, i: int) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(100 + i)
    tok = rng.integers(0, cfg.vocab_size, STEP_BATCH, dtype=np.int32)
    lab = rng.integers(0, cfg.vocab_size, STEP_BATCH, dtype=np.int32)
    return {"tokens": tok, "labels": lab}


def attn_config(get_config):
    """Hymba's smoke config with the full model's 25 query heads over 5 KV
    heads: on a 4-way model axis they pad to 6 x 6."""
    return dataclasses.replace(get_config("hymba-1.5b").smoke(), n_heads=25,
                               n_kv_heads=5, dtype="float32")


def attn_input() -> np.ndarray:
    return np.random.default_rng(ATTN_SEED).normal(
        size=ATTN_X_SHAPE).astype(np.float32)


TP_SEED = 7
TP_MESHES = ((1, 4), (2, 2))
TP_DECODE_STEPS = 3
#: case -> (arch, config overrides, batch, prompt, cache length): one case
#: per regime where the tiling rule changes.  kv4: KV heads divide the
#: model axis (each rank its own, cache included); kv1: one KV head, its
#: wk / wv columns cut mid-head and the decode cache cut along time;
#: seq_odd: a prompt that divides neither axis (residual whole), a batch
#: of 3 that does not divide data (rows whole) and a head_dim of 30 (on a
#: 4-way model axis one KV head's wk / wv stay whole); vocab_odd: a vocab
#: of 509 and an FF width of 255 (embedding, head and MLP replicated over
#: model, each rank computing the whole MLP); starcoder2: qkv and
#: mlp biases (b2 added once after the reduce); granite: MoE through EP;
#: internvl2: frontend embeddings on the first positions; rwkv6: its
#: heads, FF columns and d_model-cut token-shift caches; hymba: 4 heads
#: over 1 KV head (no padding), 64 tokens (more token rows than d_model
#: on (1, 4): the SSM gathers its weights there, its products on (2, 2))
#: and a ring of 64 slots that decode wraps; hymba_padded: 25 / 5 heads
#: padded to 6 x 6 (9 a rank in groups of 6 on (1, 4), 15 on (2, 2): they
#: straddle groups), wq cut mid-head, w_in's u / z split across ranks, a
#: window of 8 that binds in the prefill and a ring of 8 cut 2 a rank (at
#: 16 tokens the prefill takes the products route, as a decode step does);
#: hymba_padded_long: the same at 72 tokens, more token rows than d_model
#: on both meshes, so the prefill gathers wq / wk / wv / wo whole (the
#: weights route of hymba-1.5b's 2 x 4,096 prefill)
TP_CASES = {
    "kv4": ("qwen3-4b", {"n_heads": 8, "n_kv_heads": 4}, 4, 16, 24),
    "kv1": ("qwen3-4b", {}, 4, 16, 24),
    "seq_odd": ("qwen3-4b", {"head_dim": 30}, 3, 15, 24),
    "vocab_odd": ("deepseek-7b", {"vocab_size": 509, "d_ff": 255}, 4, 16,
                  20),
    "starcoder2": ("starcoder2-3b", {}, 4, 16, 24),
    "granite": ("granite-moe-3b-a800m", {}, 4, 16, 24),
    "internvl2": ("internvl2-76b", {}, 4, 16, 24),
    "rwkv6": ("rwkv6-1.6b", {}, 4, 16, 24),
    "hymba": ("hymba-1.5b", {}, 4, 64, 72),
    "hymba_padded": ("hymba-1.5b", {"n_heads": 25, "n_kv_heads": 5,
                                    "head_dim": 8, "sliding_window": 8},
                     4, 16, 24),
    "hymba_padded_long": ("hymba-1.5b", {"n_heads": 25, "n_kv_heads": 5,
                                         "head_dim": 8, "sliding_window": 8},
                          4, 72, 80),
}
#: tensor-parallel serving of MLA and a shared expert, in the regimes of
#: TP_CASES (held by ``test_torch_mesh_mla.py``, its reference in a
#: process of its own).  dsv3: deepseek-v3-671b's smoke config (1 dense
#: and 4 MoE layers, 4 MLA heads, 8 experts top 2, 1 shared expert), its
#: latent cache of 24 cut 6 slots a rank on (1, 4): decode's positions
#: 16-18 cross from rank 2's slice into rank 3's; dsv3_long: the same cut
#: to 2 layers at 1 x 4,096 tokens, the chunked MLA route, and a cache of
#: 4,102 slots (whole on (1, 4), cut on (2, 2)); granite_shared: one
#: shared expert on Granite's GQA block
TP_MLA_CASES = {
    "dsv3": ("deepseek-v3-671b", {}, 4, 16, 24),
    "dsv3_long": ("deepseek-v3-671b", {"n_layers": 2}, 1, 4096, 4102),
    "granite_shared": ("granite-moe-3b-a800m", {"n_shared_experts": 1}, 4,
                       16, 24),
}
#: MLA alone on a rank (dsv3's smoke config): its input (B, S, d), the
#: seed of its weights and inputs, and the cache lengths that are cut
#: along time on both meshes (24) and whole on both (25)
MLA_X_SHAPE = (2, 16, 128)
MLA_SEED = 9
MLA_CACHES = {"cut": 24, "whole": 25}
#: the straddling-group attention alone (hymba_padded's config on both
#: meshes, both ways of redistributing wq / wo): its input (B, S, d)
STRADDLE_CASE = "hymba_padded"
STRADDLE_X_SHAPE = (2, 16, 128)


def tp_case(name: str):
    """(arch, config overrides, batch, prompt, cache length) of a regime of
    TP_CASES or TP_MLA_CASES."""
    return {**TP_CASES, **TP_MLA_CASES}[name]


def tp_config(get_config, name: str):
    arch, over, *_ = tp_case(name)
    return dataclasses.replace(get_config(arch).smoke(), **over,
                               dtype="float32")


def tp_inputs(cfg, name: str):
    """(tokens (B, S + TP_DECODE_STEPS) int32: the prompt then the tokens
    each decode step is fed, frontend embeddings (B, nf, d) or None)."""
    _, _, b, s, _ = tp_case(name)
    rng = np.random.default_rng(TP_SEED)
    tok = rng.integers(0, cfg.vocab_size, (b, s + TP_DECODE_STEPS),
                       dtype=np.int32)
    fe = None
    if cfg.frontend is not None:
        fe = rng.normal(size=(b, cfg.n_frontend_tokens, cfg.d_model)
                        ).astype(np.float32)
    return tok, fe


TRAIN_SEED = 11
TRAIN_STEPS = 2
TRAIN_OPT = {"lr": 1e-3, "warmup_steps": 1, "total_steps": 4}
#: the AdamW constants the tests recompute the normalized step with (the
#: config's defaults)
TRAIN_OPT_CFG = {"beta1": 0.9, "beta2": 0.95, "eps": 1e-8}
#: case -> (TP_CASES regime, mesh, batch, sequence, remat): tensor-parallel
#: training held against the reference's sharded jit.  kv4 on both meshes:
#: on (1, 4) 1 x 2,048 tokens under remat "full" (the vocab-parallel
#: chunked cross entropy), on (2, 2) ZeRO-3 over data; kv1 (wk / wv cut
#: mid-head) under remat "dots"; vocab_odd (embedding, head and MLP
#: replicated over model) and seq_odd (3 rows that do not divide data, 15
#: tokens that do not divide model) on (2, 2); granite's EP with its aux
#: loss on (2, 2); starcoder2's qkv and MLP biases (b2 added once after
#: the reduce) on (2, 2); internvl2's frontend embeddings on (1, 4)
TRAIN_CASES = {
    "kv4_1x4": ("kv4", (1, 4), 1, 2048, "full"),
    "kv4_2x2": ("kv4", (2, 2), 4, 16, None),
    "kv1": ("kv1", (1, 4), 4, 16, "dots"),
    "vocab_odd": ("vocab_odd", (2, 2), 4, 16, "full"),
    "seq_odd": ("seq_odd", (2, 2), 3, 15, "full"),
    "granite": ("granite", (2, 2), 4, 16, "full"),
    "starcoder2": ("starcoder2", (2, 2), 4, 16, "full"),
    "internvl2": ("internvl2", (1, 4), 4, 16, None),
}
#: the reference's cases in three processes run side by side (its time is
#: the sharded jits' compiles)
TRAIN_REFERENCE_SPLIT = (("kv4_1x4", "kv4_2x2", "internvl2"),
                         ("kv1", "granite", "starcoder2"),
                         ("vocab_odd", "seq_odd"))
#: the cases whose tensor-parallel first step is also held against the
#: port's own one-process step (granite's EP routes each data shard's
#: tokens into capacities of its own, so its one-process step is another
#: function, as the reference's is; kv4 on (1, 4) is the costly 2,048-token
#: one)
TRAIN_ONE_PROCESS = ("kv4_2x2", "kv1", "vocab_odd", "seq_odd", "starcoder2",
                     "internvl2")
#: preempt-and-resume on (2, 2): a checkpoint every 2 steps, preempted at
#: step 3 of 5
TRAIN_RESUME = {"regime": "kv4", "mesh": (2, 2), "batch": 4, "seq": 16,
                "steps": 5, "save_every": 2, "fail_at": 3}


def train_config(get_config, case: str, cases=None):
    return tp_config(get_config, (cases or TRAIN_CASES)[case][0])


def train_batch(cfg, case: str, step: int, cases=None):
    """The case's global batch of step ``step`` (tokens, labels and, for a
    frontend, its embeddings), numpy."""
    _, _, b, s, _ = (cases or TRAIN_CASES)[case]
    rng = np.random.default_rng(1000 * TRAIN_SEED + 10 * step
                                + sorted(cases or TRAIN_CASES).index(case))
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, s), dtype=np.int32),
           "labels": rng.integers(0, cfg.vocab_size, (b, s), dtype=np.int32)}
    if cfg.frontend is not None:
        out["frontend_embeds"] = rng.normal(
            size=(b, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)
    return out


def shard_key(index) -> str:
    """A shard's place in its global array, ``"lo:hi,lo:hi"``, from its
    per-dim (lo, hi) bounds."""
    return ",".join(f"{lo}:{hi}" for lo, hi in index)


def shard_index(files) -> dict:
    """{head: {shard key: npz key}} of the reference's shard keys
    (``"<head>/<shard key>"``), to look shards up without loading them."""
    out: dict = {}
    for k in files:
        head, _, skey = k.rpartition("/")
        if ":" in skey:
            out.setdefault(head, {})[skey] = k
    return out


def ref_shard(ref, index: dict, head: str, path: str, block, key: str):
    """The reference's shard at the place ``key`` of the leaf at ``path``
    (``head``: the case, kind and step): its addressable shard there, or
    block ``block``'s slice of it under a stacked leaf (the L axis is
    never cut)."""
    shards = index[f"{head}/{path}"]
    if block is None:
        return ref[shards[key]]
    (want,) = [k for s, k in shards.items() if s.split(",", 1)[1] == key]
    return ref[want][block]


class NpzFiles:
    """Several ``.npz`` files read as one (their keys are disjoint):
    ``files`` and ``[key]`` as ``np.load`` gives them."""

    def __init__(self, paths):
        self._where = {}
        for path in paths:
            z = np.load(path)
            self._where.update(dict.fromkeys(z.files, z))
        self.files = list(self._where)

    def __getitem__(self, key):
        return self._where[key][key]


#: case -> (TP_CASES / TP_MLA_CASES regime, mesh, batch, sequence, remat):
#: tensor-parallel training of the recurrent families, MLA and a shared
#: expert (``tests/test_torch_mesh_train_families.py``), held against the
#: reference's sharded jit as TRAIN_CASES are.  rwkv6 on (1, 4) at 4 x 64
#: (the chunked WKV on each rank's head) and on (2, 2) at 4 x 16 (the
#: scan, ZeRO-3 over data); hymba at 4 x 80, past its window of 64 (4
#: heads over 1 KV head, more token rows than d_model: the SSM gathers its
#: weights); hymba_padded (25 / 5 heads padded to 6 x 6, a window of 8) at
#: 4 x 16 on (1, 4), fewer token rows than d_model: wq / wk / wv / wo and
#: the SSM's products redistributed; hymba_padded_long at 4 x 72 on
#: (2, 2): the weights gathered; dsv3 (MLA, 1 dense and 4 MoE layers of 8
#: experts top 2, the shared expert, the aux loss, the MTP head) on both
#: meshes at 4 x 32 (at 4 x 16 a data shard routes 8 tokens an expert,
#: and over 5 % of the elements, mostly experts', get clipped gradients
#: within ``_check_update``'s few eps of zero); dsv3_long (2 layers) at
#: 1 x 4,096 on (1, 4), the chunked MLA route; granite_shared (a shared
#: expert on GQA) on (2, 2)
TRAIN_FAMILY_CASES = {
    "rwkv6_1x4": ("rwkv6", (1, 4), 4, 64, None),
    "rwkv6_2x2": ("rwkv6", (2, 2), 4, 16, "full"),
    "hymba": ("hymba", (1, 4), 4, 80, "dots"),
    "hymba_padded": ("hymba_padded", (1, 4), 4, 16, "full"),
    "hymba_padded_long": ("hymba_padded_long", (2, 2), 4, 72, None),
    "dsv3_1x4": ("dsv3", (1, 4), 4, 32, None),
    "dsv3_2x2": ("dsv3", (2, 2), 4, 32, None),
    "dsv3_long": ("dsv3_long", (1, 4), 1, 4096, "full"),
    "granite_shared": ("granite_shared", (2, 2), 4, 16, "full"),
}
#: the reference's family cases in processes run side by side
TRAIN_FAMILY_REFERENCE_SPLIT = (("dsv3_1x4",), ("dsv3_2x2",), ("dsv3_long",),
                                ("hymba", "rwkv6_1x4"),
                                ("hymba_padded", "rwkv6_2x2"),
                                ("hymba_padded_long", "granite_shared"))
#: the family cases whose tensor-parallel first step is also held against
#: the port's one-process step: every case whose batch is not cut over
#: data (an MoE data shard routes into capacities of its own), and the
#: recurrent families on (2, 2); dsv3_long's 4,096 tokens are left out
TRAIN_FAMILY_ONE_PROCESS = ("rwkv6_1x4", "rwkv6_2x2", "hymba",
                            "hymba_padded", "hymba_padded_long", "dsv3_1x4")
#: the cases that also take ``mtp_loss``'s gradient (DeepSeek-V3's MTP
#: head) at their first step's state
TRAIN_FAMILY_MTP = ("dsv3_1x4", "dsv3_2x2")
#: the family cases whose grad norm and moments are held to the
#: reference's (the moments to the port's one-process step's too) at
#: limits of their own, not ``test_torch_mesh_train.py``'s 1e-5, and
#: whose every step has a float64 witness (``torch_mesh_train_ranks.
#: _witness``).  RWKV6's gradient of the bonus u sums terms that cancel:
#: every float32 computation of it, the reference's included, lies
#: 1.6e-5 to 1.2e-4 (relative L2) from the float64 value, its moments
#: likewise, and the reference's float32 grad norm on (2, 2) 1.04e-5.  Of
#: sound runs the tensor-parallel step read at most 1.27e-6 (1x4) and
#: 9.88e-6 (2x2) from the reference's grad norm, 3.21e-5 and 1.96e-4 from
#: its moments, 1.04e-4 from the one-process step's; a wrong cut (u's
#: gradient not summed over ``model``) read 1.7e-5 to 5.8e-3 and 0.86 to
#: 1.0.  Each limit is about 3x the largest sound reading
TRAIN_FAMILY_F32_GAPS = {"rwkv6_1x4": {"grad_norm": 1e-5, "moments": 1e-4},
                         "rwkv6_2x2": {"grad_norm": 3e-5, "moments": 5e-4}}
#: the witness's bound: each kind's (gradient, m, v) largest distance of
#: the tensor-parallel step from the float64 value, over that of the
#: reference's float32 step (sound runs read at most 1.76)
F32_WITNESS_FACTOR = 3.0
#: preempt-and-resume of RWKV6 on (2, 2), as TRAIN_RESUME
TRAIN_FAMILY_RESUME = {"regime": "rwkv6", "mesh": (2, 2), "batch": 4,
                       "seq": 16, "steps": 5, "save_every": 2, "fail_at": 3}


def rwkv6_draws(shapes: dict) -> dict:
    """RWKV6's decay leaves for the family cases, drawn in place of their
    init values ({leaf: stacked shape} -> {leaf: float32 array}): the
    bonus u (0 at init) 0.1 N(0, 1) as ``chip_smoke.py``'s phase 9 checks
    draw it, the base log-decay w0 (-5 at init) uniform in [-3, -0.5], the
    decay's LoRA factors (0.01 N(0, 1) at init) 0.1 N(0, 1).  From the
    init values, a step after u = 0 the first token's head norm of an
    output ~u put rwkv6_1x4's gradient shards up to 1.8e-4 and rwkv6_2x2's
    grad norm 3.8e-4 apart from the reference's sharded jit, and the slow
    uniform decay leaves most of the LoRA factors' clipped gradients
    within ``_check_update``'s few eps of zero (over 20 % of rwkv6_1x4's
    elements)."""
    rng = np.random.default_rng(TRAIN_SEED + 1)
    out = {}
    for leaf in ("u", "w0", "w_lora_a", "w_lora_b"):
        shape = shapes[leaf]
        draw = (rng.uniform(-3.0, -0.5, shape) if leaf == "w0"
                else 0.1 * rng.normal(size=shape))
        out[leaf] = draw.astype(np.float32)
    return out


def train_cases(case: str) -> dict:
    """The table (TRAIN_CASES or TRAIN_FAMILY_CASES) that holds ``case``."""
    return TRAIN_CASES if case in TRAIN_CASES else TRAIN_FAMILY_CASES


def mtp_labels(cfg, case: str):
    """The tokens two places ahead for ``mtp_loss`` at the case's first
    step, numpy (B, S)."""
    _, _, b, s, _ = TRAIN_FAMILY_CASES[case]
    rng = np.random.default_rng(
        500 + sorted(TRAIN_FAMILY_CASES).index(case))
    return rng.integers(0, cfg.vocab_size, (b, s), dtype=np.int32)
