"""Architecture registry — the 10 assigned architectures, exact published
configs (sources in brackets; see DESIGN.md for modality-stub notes).
A copy of ``repro.configs.registry``."""
from __future__ import annotations

from .base import ModelConfig

# — LM-family transformers —————————————————————————————————————————————

INTERNVL2_76B = ModelConfig(
    # InternViT frontend is a stub; this is the InternLM2-76B backbone
    # [arXiv:2404.16821]
    name="internvl2-76b", family="vlm",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=28672,
    vocab_size=128256, attn_type="gqa", rope_theta=1e6,
    frontend="patch", n_frontend_tokens=256,
)

DEEPSEEK_7B = ModelConfig(
    # llama-arch dense [arXiv:2401.02954]
    name="deepseek-7b", family="dense",
    n_layers=30, d_model=4096, n_heads=32, n_kv_heads=32, d_ff=11008,
    vocab_size=102400, attn_type="gqa", rope_theta=10000.0,
)

QWEN3_4B = ModelConfig(
    # qk_norm, GQA [hf:Qwen/Qwen3-8B family]
    name="qwen3-4b", family="dense",
    n_layers=36, d_model=2560, n_heads=32, n_kv_heads=8, d_ff=9728,
    vocab_size=151936, head_dim=128, attn_type="gqa", qk_norm=True,
    rope_theta=1e6,
)

STARCODER2_3B = ModelConfig(
    # GQA, RoPE [arXiv:2402.19173]
    name="starcoder2-3b", family="dense",
    n_layers=30, d_model=3072, n_heads=24, n_kv_heads=2, d_ff=12288,
    vocab_size=49152, attn_type="gqa", qkv_bias=True, mlp_bias=True,
    rope_theta=1e5,
)

QWEN2_5_3B = ModelConfig(
    # GQA, QKV bias [hf:Qwen/Qwen2.5 family]
    name="qwen2.5-3b", family="dense",
    n_layers=36, d_model=2048, n_heads=16, n_kv_heads=2, d_ff=11008,
    vocab_size=151936, attn_type="gqa", qkv_bias=True, rope_theta=1e6,
)

DEEPSEEK_V3_671B = ModelConfig(
    # MLA, 1 shared + 256 routed top-8, 3 leading dense layers, MTP
    # [arXiv:2412.19437]
    name="deepseek-v3-671b", family="moe",
    n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128, d_ff=18432,
    vocab_size=129280, attn_type="mla", mlp_type="moe",
    n_experts=256, top_k=8, n_shared_experts=1, moe_d_ff=2048,
    n_dense_layers=3,
    q_lora_rank=1536, kv_lora_rank=512, qk_nope_dim=128, qk_rope_dim=64,
    v_head_dim=128, mtp_depth=1, rope_theta=10000.0,
)

GRANITE_MOE_3B = ModelConfig(
    # 40 experts top-8 [hf:ibm-granite/granite-3.0 family]
    name="granite-moe-3b-a800m", family="moe",
    n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8, d_ff=512,
    vocab_size=49155, attn_type="gqa", mlp_type="moe",
    n_experts=40, top_k=8, moe_d_ff=512, rope_theta=10000.0,
)

RWKV6_1_6B = ModelConfig(
    # Finch: data-dependent decay, attention-free [arXiv:2404.05892]
    name="rwkv6-1.6b", family="ssm",
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32, d_ff=7168,
    vocab_size=65536, head_dim=64, attn_type="rwkv6",
)

HYMBA_1_5B = ModelConfig(
    # parallel attn+mamba heads, ssm_state=16 [arXiv:2411.13676]
    name="hymba-1.5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5, d_ff=5504,
    vocab_size=32001, head_dim=64, attn_type="hymba", ssm_state=16,
    d_inner=3200, sliding_window=2048, rope_theta=10000.0,
)

MUSICGEN_LARGE = ModelConfig(
    # decoder-only over EnCodec tokens; frame frontend stubbed
    # [arXiv:2306.05284]
    name="musicgen-large", family="audio",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32, d_ff=8192,
    vocab_size=2048, attn_type="gqa", frontend="frame",
    n_frontend_tokens=0, rope_theta=10000.0,
)

ARCHITECTURES: dict[str, ModelConfig] = {
    c.name: c
    for c in (
        INTERNVL2_76B, DEEPSEEK_7B, QWEN3_4B, STARCODER2_3B, QWEN2_5_3B,
        DEEPSEEK_V3_671B, GRANITE_MOE_3B, RWKV6_1_6B, HYMBA_1_5B,
        MUSICGEN_LARGE,
    )
}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHITECTURES:
        raise KeyError(
            f"unknown arch {name!r}; available: {sorted(ARCHITECTURES)}"
        )
    return ARCHITECTURES[name]
