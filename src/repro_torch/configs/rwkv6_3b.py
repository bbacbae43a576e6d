"""rwkv6-3b — Finch, data-dependent decay, attention-free.

[arXiv:2404.05892; hf] 32L d_model=2560 d_ff=8960 vocab=65536.
WKV6 head size 64 -> 40 heads. No KV cache; O(1) recurrent state.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b",
    family="ssm",
    n_layers=32,
    d_model=2560,
    n_heads=40,
    n_kv_heads=40,
    head_dim=64,
    d_ff=8960,
    vocab_size=65536,
    attn_kind="none",
    ssm_kind="rwkv6",
    ssm_state=64,   # per-head state is [head_dim x head_dim]
    ssm_heads=40,
    source="arXiv:2404.05892; hf",
)
