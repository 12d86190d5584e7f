"""command-r-35b [dense] — GQA kv=8, no biases.  40L d=8192 64H d_ff=22528
vocab=256000 [hf:CohereForAI/c4ai-command-r-v01]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="command-r-35b",
    family="dense",
    n_layers=40,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22528,
    vocab=256000,
    norm_type="layernorm",   # cohere uses LayerNorm (no bias)
    act="swiglu",
    rope_theta=8e6,
    tie_embeddings=True,
)

SMOKE_CONFIG = CONFIG.scaled(
    n_layers=2, d_model=128, n_heads=8, n_kv_heads=2, d_ff=256, vocab=512,
)
