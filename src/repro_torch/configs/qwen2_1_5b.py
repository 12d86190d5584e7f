"""qwen2-1.5b [dense] — GQA kv=2, QKV bias.  28L d=1536 12H d_ff=8960
vocab=151936 [arXiv:2407.10671]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-1.5b",
    family="dense",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    d_ff=8960,
    vocab=151936,
    qkv_bias=True,
    rope_theta=1e6,
    norm_type="rmsnorm",
    tie_embeddings=True,
)

SMOKE_CONFIG = CONFIG.scaled(
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_ff=256, vocab=512,
)
