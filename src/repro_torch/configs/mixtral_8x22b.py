"""mixtral-8x22b — 8-expert top-2 MoE with sliding-window attention.

[arXiv:2401.04088; hf] 56L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=32768.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=32768,
    attn_kind="gqa",
    sliding_window=4096,
    rope_theta=1e6,
    n_experts=8,
    top_k=2,
    moe_d_ff=16384,
    source="arXiv:2401.04088; hf",
)
