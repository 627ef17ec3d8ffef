"""Model / run configuration system (a copy of ``repro.configs.base``).

One frozen dataclass describes every assigned architecture; configs/<id>.py
instantiates it with the published numbers.  ``smoke()`` derives the reduced
same-family config used by CPU smoke tests (small widths, few layers/experts,
tiny vocab) — the full config is exercised only through the dry-run
(ShapeDtypeStruct, no allocation).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 => d_model // n_heads

    # block wiring
    attn_type: str = "gqa"  # gqa | mla | rwkv6 | hymba
    mlp_type: str = "dense"  # dense | moe
    qk_norm: bool = False
    qkv_bias: bool = False
    mlp_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 10000.0
    rms_eps: float = 1e-6

    # MoE (deepseek-v3 / granite)
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0  # per-expert hidden size
    n_dense_layers: int = 0  # leading dense layers (deepseek-v3: 3)
    capacity_factor: float = 1.25

    # MLA (deepseek-v3)
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0

    # SSM / hybrid (rwkv6, hymba)
    ssm_state: int = 0
    d_inner: int = 0  # mamba inner width (hymba)
    sliding_window: int = 0  # hymba attention window (0 => full causal)

    # modality frontend stub (vlm / audio): embeddings for the first
    # n_frontend_tokens positions arrive precomputed from input_specs()
    frontend: str | None = None  # None | "patch" | "frame"
    n_frontend_tokens: int = 0

    # multi-token prediction (deepseek-v3 optional head)
    mtp_depth: int = 0

    dtype: str = "bfloat16"

    # ---- derived -----------------------------------------------------------
    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch decode at 500k context with O(1)/O(window) state?"""
        return self.attn_type in ("rwkv6", "hymba")

    def n_params(self) -> int:
        """Total parameter count (embeddings included, analytic)."""
        d, h = self.d_model, self.head_dim_
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        if self.attn_type == "gqa":
            attn = d * h * self.n_heads + 2 * d * h * self.n_kv_heads + self.n_heads * h * d
        elif self.attn_type == "mla":
            qk = self.qk_nope_dim + self.qk_rope_dim
            attn = (
                d * self.q_lora_rank
                + self.q_lora_rank * self.n_heads * qk
                + d * (self.kv_lora_rank + self.qk_rope_dim)
                + self.kv_lora_rank * self.n_heads * (self.qk_nope_dim + self.v_head_dim)
                + self.n_heads * self.v_head_dim * d
            )
        elif self.attn_type == "rwkv6":
            attn = 4 * d * d + 2 * d * 64  # r,k,v,g,o + decay lora
        else:  # hymba: attention + mamba branches
            attn = (
                d * h * self.n_heads
                + 2 * d * h * self.n_kv_heads
                + self.n_heads * h * d
                + 2 * d * self.d_inner_  # in/ gate proj
                + self.d_inner_ * d  # out proj
                + self.d_inner_ * 3 * self.ssm_state  # B, C, dt
            )
        if self.mlp_type == "dense":
            mlp = 3 * d * self.d_ff
        else:
            mlp = (
                self.n_experts * 3 * d * self.moe_d_ff
                + self.n_shared_experts * 3 * d * self.moe_d_ff
                + d * self.n_experts  # router
            )
            mlp_dense = 3 * d * self.d_ff
            return (
                emb
                + self.n_dense_layers * (attn + mlp_dense)
                + (self.n_layers - self.n_dense_layers) * (attn + mlp)
            )
        return emb + self.n_layers * (attn + mlp)

    def n_active_params(self) -> int:
        """Per-token active parameters (MoE: only routed top-k + shared)."""
        if self.mlp_type != "moe":
            return self.n_params()
        d = self.d_model
        full = self.n_params()
        inactive = (self.n_experts - self.top_k) * 3 * d * self.moe_d_ff * (
            self.n_layers - self.n_dense_layers
        )
        return full - inactive

    @property
    def d_inner_(self) -> int:
        return self.d_inner or 2 * self.d_model

    # ---- reduced smoke config ------------------------------------------------
    def smoke(self) -> "ModelConfig":
        """Same-family reduced config for CPU smoke tests."""
        heads = min(self.n_heads, 4)
        kv = max(1, min(self.n_kv_heads, heads))
        # preserve the GQA group structure when possible
        if self.n_kv_heads < self.n_heads:
            kv = max(1, heads // max(1, self.n_heads // self.n_kv_heads))
        return dataclasses.replace(
            self,
            n_layers=min(self.n_layers, 2 + self.n_dense_layers),
            d_model=128,
            n_heads=heads,
            n_kv_heads=kv,
            head_dim=32,
            d_ff=256,
            vocab_size=512,
            n_experts=min(self.n_experts, 8),
            top_k=min(self.top_k, 2),
            moe_d_ff=64 if self.mlp_type == "moe" else 0,
            n_dense_layers=min(self.n_dense_layers, 1),
            q_lora_rank=32 if self.q_lora_rank else 0,
            kv_lora_rank=32 if self.kv_lora_rank else 0,
            qk_nope_dim=32 if self.qk_nope_dim else 0,
            qk_rope_dim=16 if self.qk_rope_dim else 0,
            v_head_dim=32 if self.v_head_dim else 0,
            d_inner=128 if self.attn_type == "hymba" else 0,
            ssm_state=min(self.ssm_state, 8) if self.ssm_state else 0,
            sliding_window=min(self.sliding_window, 64) if self.sliding_window else 0,
            n_frontend_tokens=min(self.n_frontend_tokens, 8),
            dtype="float32",
        )


@dataclass(frozen=True)
class ShapeConfig:
    """One of the assigned input-shape cells."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}
