"""deepseek-v2-236b [moe] — MLA kv_lora=512, 2 shared + 160 routed top-6.
60L d_model=5120 128H moe_d_ff=1536 vocab=102400 [arXiv:2405.04434]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,
    d_ff=12288,
    vocab=102400,
    use_mla=True,
    kv_lora=512,
    q_lora=1536,
    rope_head_dim=64,
    nope_head_dim=128,
    v_head_dim=128,
    n_experts=160,
    n_shared_experts=2,
    moe_top_k=6,
    moe_d_ff=1536,
    n_dense_layers=1,
    norm_type="rmsnorm",
)

SMOKE_CONFIG = CONFIG.scaled(
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, d_ff=256, vocab=512,
    kv_lora=64, q_lora=96, rope_head_dim=16, nope_head_dim=32, v_head_dim=32,
    n_experts=8, n_shared_experts=1, moe_top_k=2, moe_d_ff=64, n_dense_layers=1,
    moe_token_chunk=256,
)
