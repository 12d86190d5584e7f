"""qwen3-14b [dense] — GQA kv=8, qk_norm.  40L d=5120 40H d_ff=17408
vocab=151936 [hf:Qwen/Qwen3-14B]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-14b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=17408,
    vocab=151936,
    qk_norm=True,
    rope_theta=1e6,
    norm_type="rmsnorm",
)

SMOKE_CONFIG = CONFIG.scaled(
    n_layers=2, d_model=128, n_heads=8, n_kv_heads=2, head_dim=16, d_ff=256, vocab=512,
)
