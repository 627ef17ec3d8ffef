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
#: internvl2: frontend embeddings on the first positions
TP_CASES = {
    "kv4": ("qwen3-4b", {"n_heads": 8, "n_kv_heads": 4}, 4, 16, 24),
    "kv1": ("qwen3-4b", {}, 4, 16, 24),
    "seq_odd": ("qwen3-4b", {"head_dim": 30}, 3, 15, 24),
    "vocab_odd": ("deepseek-7b", {"vocab_size": 509, "d_ff": 255}, 4, 16,
                  20),
    "starcoder2": ("starcoder2-3b", {}, 4, 16, 24),
    "granite": ("granite-moe-3b-a800m", {}, 4, 16, 24),
    "internvl2": ("internvl2-76b", {}, 4, 16, 24),
}


def tp_config(get_config, name: str):
    arch, over, *_ = TP_CASES[name]
    return dataclasses.replace(get_config(arch).smoke(), **over,
                               dtype="float32")


def tp_inputs(cfg, name: str):
    """(tokens (B, S + TP_DECODE_STEPS) int32: the prompt then the tokens
    each decode step is fed, frontend embeddings (B, nf, d) or None)."""
    _, _, b, s, _ = TP_CASES[name]
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
