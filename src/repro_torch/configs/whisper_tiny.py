"""whisper-tiny [audio] — enc-dec, conv frontend stubbed (input_specs feeds
precomputed frame embeddings).  4L enc + 4L dec, d=384 6H d_ff=1536
vocab=51865 [arXiv:2212.04356]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="encdec",
    n_layers=4,            # decoder layers
    n_enc_layers=4,
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    d_ff=1536,
    vocab=51865,
    norm_type="layernorm",
    act="gelu",
    frontend="audio_stub",
    tie_embeddings=True,
)

SMOKE_CONFIG = CONFIG.scaled(
    n_layers=2, n_enc_layers=2, d_model=64, n_heads=2, n_kv_heads=2, d_ff=128, vocab=512,
)
