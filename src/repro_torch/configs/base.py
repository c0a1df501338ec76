"""Model/shape configuration system.

Every assigned architecture gets a module in this package defining
``CONFIG`` (the exact published dimensions) and ``SMOKE`` (a reduced
same-family config for CPU tests).  ``repro.configs.get_config`` resolves
them by id.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | rwkv6 | hybrid | encdec
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 0  # 0 -> d_model // n_heads

    # attention flavour
    attention: str = "gqa"  # gqa | mla | none (attention-free)
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    causal: bool = True

    # MLA (DeepSeek/MiniCPM3 style latent KV compression)
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_rope_dim: int = 0
    qk_nope_dim: int = 0
    v_head_dim: int = 0

    # MoE
    n_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25

    # SSM / RWKV / hybrid
    ssm_state: int = 0
    ssm_heads: int = 0
    d_conv: int = 4
    expand: int = 2
    attn_every: int = 0  # hybrid: shared attention block period (in layers)

    # encoder-decoder (whisper): decoder uses the top-level dims
    n_enc_layers: int = 0
    enc_frames: int = 1500  # stub frontend output length (precomputed embeds)

    dtype: str = "bfloat16"
    notes: str = ""
    source: str = ""

    # execution knobs (set by step builders, not per-arch constants)
    remat: bool = False  # checkpoint each block in the layer scan (training)
    seq_shard: bool = False  # Megatron-style sequence parallelism between blocks

    def __post_init__(self):
        if self.d_head == 0:
            object.__setattr__(self, "d_head", self.d_model // max(1, self.n_heads))

    @property
    def kv_bytes_per_token(self) -> int:
        """bf16 KV-cache bytes per token (the paper's per-model axis in
        Fig. 5: 40/60/120 KB per token across GLM/Llama)."""
        if self.attention == "mla":
            per_layer = self.kv_lora_rank + self.qk_rope_dim
        elif self.family == "rwkv6":
            return 0  # constant-size state, not per-token
        else:
            per_layer = 2 * self.n_kv_heads * self.d_head
        n_attn_layers = self.n_layers if self.attn_every == 0 else self.n_layers // self.attn_every
        return per_layer * n_attn_layers * 2  # bf16

    def param_count(self) -> int:
        """Analytic parameter count (used for 6ND model-FLOPs)."""
        d, f, V, L = self.d_model, self.d_ff, self.vocab_size, self.n_layers
        emb = V * d * 2  # in + out embedding
        if self.family == "rwkv6":
            per = d * d * 4 + d * f * 2 + d * 64 * 8  # mixers + channel mix (approx lora)
            return emb + L * per
        if self.attention == "mla":
            attn = (
                self.d_model * (self.q_lora_rank or self.d_model)
                + (self.q_lora_rank or 0) * self.n_heads * (self.qk_nope_dim + self.qk_rope_dim)
                + self.d_model * (self.kv_lora_rank + self.qk_rope_dim)
                + self.kv_lora_rank * self.n_heads * (self.qk_nope_dim + self.v_head_dim)
                + self.n_heads * self.v_head_dim * self.d_model
            )
        else:
            attn = d * self.n_heads * self.d_head + 2 * d * self.n_kv_heads * self.d_head + self.n_heads * self.d_head * d
        if self.family == "moe":
            ff = self.n_experts * 3 * d * self.moe_d_ff + d * self.n_experts  # experts + router
        else:
            ff = 3 * d * f
        per = attn + ff
        if self.family == "hybrid":
            # mamba2 blocks + one shared attention block
            d_in = self.expand * d
            per = 2 * d * d_in + d_in * d + d_in * self.d_conv  # in/out proj + conv
            shared = attn + 3 * d * f
            return emb + L * per + shared
        if self.family == "encdec":
            enc_per = attn + 3 * d * f
            dec_per = attn * 2 + 3 * d * f  # self + cross
            return emb + self.n_enc_layers * enc_per + L * dec_per
        return emb + L * per

    def active_param_count(self) -> int:
        """Activated params per token (MoE: top-k experts only)."""
        if self.family != "moe":
            return self.param_count()
        d = self.d_model
        dense = self.param_count() - self.n_layers * self.n_experts * 3 * d * self.moe_d_ff
        return dense + self.n_layers * self.experts_per_token * 3 * d * self.moe_d_ff


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}

# archs that may run long_500k (sub-quadratic / constant-state decode);
# pure full-attention archs skip it (DESIGN.md §4)
LONG_CONTEXT_OK = {"rwkv6-1.6b", "zamba2-1.2b"}


def smoke_variant(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    base = dict(
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=max(1, min(cfg.n_kv_heads, 2)) if cfg.n_kv_heads else 0,
        d_head=16,
        d_ff=128,
        vocab_size=256,
    )
    if cfg.family == "moe":
        base.update(n_experts=4, experts_per_token=2, moe_d_ff=64)
    if cfg.attention == "mla":
        base.update(q_lora_rank=32, kv_lora_rank=16, qk_rope_dim=8, qk_nope_dim=8, v_head_dim=16)
    if cfg.family in ("rwkv6", "hybrid"):
        base.update(ssm_state=8, ssm_heads=4 if cfg.family == "hybrid" else 0)
    if cfg.family == "hybrid":
        base.update(attn_every=2, expand=2)
    if cfg.family == "encdec":
        base.update(n_enc_layers=2, enc_frames=16)
    base.update(overrides)
    base["name"] = cfg.name + "-smoke"
    return dataclasses.replace(cfg, **base)
