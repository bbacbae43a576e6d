"""qwen3-8b — dense GQA with per-head qk-norm.

[hf:Qwen/Qwen3-8B; hf] 36L d_model=4096 32H (GQA kv=8) d_ff=12288 vocab=151936.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-8b",
    family="dense",
    n_layers=36,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=12288,
    vocab_size=151936,
    attn_kind="gqa",
    qk_norm=True,
    rope_theta=1e6,
    source="hf:Qwen/Qwen3-8B; hf",
)
