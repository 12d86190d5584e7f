"""recurrentgemma-2b [hybrid] — RG-LRU + local attention, pattern
(rglru, rglru, attn).  26L d=2560 10H (kv=1) d_ff=7680 vocab=256000
[arXiv:2402.19427]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab=256000,
    pattern=("rglru", "rglru", "attn"),
    lru_width=2560,
    window=2048,
    norm_type="rmsnorm",
    act="gelu",          # gated GeLU (GeGLU)
    tie_embeddings=True,
    logit_softcap=30.0,
    sub_quadratic=True,
)

SMOKE_CONFIG = CONFIG.scaled(
    n_layers=6, d_model=128, n_heads=4, n_kv_heads=1, head_dim=32, d_ff=256,
    vocab=512, lru_width=128, window=64,
)
