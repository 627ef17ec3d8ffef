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
