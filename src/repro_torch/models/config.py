"""Unified model configuration covering all assigned architecture families."""
from __future__ import annotations

from dataclasses import dataclass, field, replace


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int | None = None          # default d_model // n_heads
    # attention details
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    window: int | None = None            # sliding-window size (local attention)
    # MLA (deepseek)
    use_mla: bool = False
    kv_lora: int = 0
    q_lora: int = 0
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128
    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0
    n_dense_layers: int = 0              # leading dense layers (deepseek)
    capacity_factor: float = 1.25
    moe_token_chunk: int = 16384         # dispatch-buffer chunking knob (§Perf)
    # SSM (mamba2 / SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_ngroups: int = 1
    ssm_conv: int = 4
    ssm_chunk: int = 256
    # hybrid (recurrentgemma): repeating temporal pattern, e.g. ("rglru","rglru","attn")
    pattern: tuple = ()
    lru_width: int = 0
    # encoder-decoder (whisper)
    n_enc_layers: int = 0
    frontend: str = "none"               # none | audio_stub | patch_stub
    n_frontend_tokens: int = 0           # patch/frame positions fed as embeddings
    norm_type: str = "rmsnorm"           # rmsnorm | layernorm
    act: str = "swiglu"                  # swiglu | gelu
    tie_embeddings: bool = False
    logit_softcap: float = 0.0
    # numerics
    sub_quadratic: bool = False          # eligible for long_500k

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def scaled(self, **kw) -> "ModelConfig":
        return replace(self, **kw)


def n_params_dense(cfg: ModelConfig) -> int:
    """Rough parameter count (reported next to MODEL_FLOPS in the roofline)."""
    d, h = cfg.d_model, cfg.resolved_head_dim
    emb = cfg.vocab * d * (1 if cfg.tie_embeddings else 2)
    per_layer = 0
    if cfg.use_mla:
        per_layer += d * (cfg.kv_lora + cfg.rope_head_dim)
        per_layer += cfg.kv_lora * cfg.n_heads * (cfg.nope_head_dim + cfg.v_head_dim)
        q_in = cfg.q_lora or d
        per_layer += (d * cfg.q_lora if cfg.q_lora else 0)
        per_layer += q_in * cfg.n_heads * (cfg.nope_head_dim + cfg.rope_head_dim)
        per_layer += cfg.n_heads * cfg.v_head_dim * d
    else:
        per_layer += d * cfg.n_heads * h + 2 * d * cfg.n_kv_heads * h + cfg.n_heads * h * d
    if cfg.n_experts:
        shared = cfg.n_shared_experts * 3 * d * cfg.moe_d_ff
        routed = cfg.n_experts * 3 * d * cfg.moe_d_ff
        router = d * cfg.n_experts
        moe_layers = cfg.n_layers - cfg.n_dense_layers
        dense_part = cfg.n_dense_layers * 3 * d * cfg.d_ff
        return emb + cfg.n_layers * per_layer + moe_layers * (shared + routed + router) + dense_part
    ff_mult = 3 if cfg.act == "swiglu" else 2
    return emb + cfg.n_layers * (per_layer + ff_mult * d * cfg.d_ff)


def n_active_params(cfg: ModelConfig) -> int:
    """Activated parameters per token (MoE: top-k + shared only)."""
    if not cfg.n_experts:
        return n_params_dense(cfg)
    full = n_params_dense(cfg)
    moe_layers = cfg.n_layers - cfg.n_dense_layers
    inactive = moe_layers * (cfg.n_experts - cfg.moe_top_k) * 3 * cfg.d_model * cfg.moe_d_ff
    return full - inactive
