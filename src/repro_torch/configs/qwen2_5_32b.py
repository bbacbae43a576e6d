"""qwen2.5-32b — dense GQA with QKV bias.

[hf:Qwen/Qwen2.5-0.5B; hf] 64L d_model=5120 40H (GQA kv=8) d_ff=27648 vocab=152064.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=27648,
    vocab_size=152064,
    attn_kind="gqa",
    qkv_bias=True,
    rope_theta=1e6,
    source="hf:Qwen/Qwen2.5-0.5B; hf",
)
