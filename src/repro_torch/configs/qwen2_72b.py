"""qwen2-72b — dense GQA with QKV bias.

[arXiv:2407.10671; hf] 80L d_model=8192 64H (GQA kv=8) d_ff=29568 vocab=152064.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-72b",
    family="dense",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=29568,
    vocab_size=152064,
    attn_kind="gqa",
    qkv_bias=True,
    rope_theta=1e6,
    source="arXiv:2407.10671; hf",
)
