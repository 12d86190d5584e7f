"""pixtral-12b [vlm] — mistral-nemo-style decoder; the pixtral ViT frontend is
a STUB (input_specs provides precomputed patch embeddings that replace the
leading positions).  40L d=5120 32H (kv=8) d_ff=14336 vocab=131072
[hf:mistralai/Pixtral-12B-2409]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b",
    family="vlm",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab=131072,
    rope_theta=1e9,
    norm_type="rmsnorm",
    frontend="patch_stub",
    n_frontend_tokens=1024,   # patch positions per sample in mixed batches
)

SMOKE_CONFIG = CONFIG.scaled(
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32, d_ff=256,
    vocab=512, n_frontend_tokens=8,
)
