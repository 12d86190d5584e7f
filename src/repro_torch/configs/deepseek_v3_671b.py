"""deepseek-v3-671b [moe] — MLA, 1 shared + 256 routed top-8.
61L d_model=7168 128H (kv via MLA lora=512) moe_d_ff=2048 vocab=129280
[arXiv:2412.19437].  MTP head is a training-loss add-on; systems behaviour is
unchanged, so it is represented by the optional `mtp` flag (off by default —
see DESIGN.md §8)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    d_ff=18432,          # dense layers' FFN
    vocab=129280,
    use_mla=True,
    kv_lora=512,
    q_lora=1536,
    rope_head_dim=64,
    nope_head_dim=128,
    v_head_dim=128,
    n_experts=256,
    n_shared_experts=1,
    moe_top_k=8,
    moe_d_ff=2048,
    n_dense_layers=3,
    norm_type="rmsnorm",
)

SMOKE_CONFIG = CONFIG.scaled(
    n_layers=3, d_model=128, n_heads=4, n_kv_heads=4, d_ff=256, vocab=512,
    kv_lora=64, q_lora=96, rope_head_dim=16, nope_head_dim=32, v_head_dim=32,
    n_experts=8, moe_top_k=2, moe_d_ff=64, n_dense_layers=1, moe_token_chunk=256,
)
