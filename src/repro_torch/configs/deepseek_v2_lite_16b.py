"""deepseek-v2-lite-16b — MLA (kv_lora=512) + fine-grained MoE.

[arXiv:2405.04434; hf] 27L d_model=2048 16H d_ff=1408(moe) vocab=102400,
MoE 64 routed experts top-6 + 2 shared, first layer dense (d_ff=10944).
Cache stores the compressed latent (kv_lora_rank + qk_rope_dim = 576/token).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab_size=102400,
    attn_kind="mla",
    kv_lora_rank=512,
    qk_rope_dim=64,
    qk_nope_dim=128,
    v_head_dim=128,
    n_experts=64,
    n_shared_experts=2,
    top_k=6,
    moe_d_ff=1408,
    first_dense_layers=1,
    dense_d_ff=10944,
    source="arXiv:2405.04434; hf",
)
