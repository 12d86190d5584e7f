"""mamba2-780m [ssm] — SSD (state-space duality), attention-free.
48L d_model=1536 d_ff=0 vocab=50280 ssm_state=128  [arXiv:2405.21060]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-780m",
    family="ssm",
    n_layers=48,
    d_model=1536,
    n_heads=48,          # d_inner / headdim = 1536*2/64
    n_kv_heads=48,
    d_ff=0,              # SSD blocks only — no separate MLP (per config)
    vocab=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_headdim=64,
    ssm_ngroups=1,
    ssm_conv=4,
    norm_type="rmsnorm",
    tie_embeddings=True,
    sub_quadratic=True,
)

SMOKE_CONFIG = CONFIG.scaled(
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, vocab=256,
    ssm_state=16, ssm_headdim=32, ssm_chunk=32,
)
