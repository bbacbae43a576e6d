"""zamba2-7b — hybrid: Mamba2 backbone + shared full-attention blocks.

[arXiv:2411.15242; unverified] 81L d_model=3584 32H (GQA kv=32, i.e. MHA-width
KV for the shared block) d_ff=14336 vocab=32000, ssm_state=64.
A single shared transformer block (attention + MLP, with per-invocation LoRA
deltas) is applied after every 6th Mamba2 layer -> 13 applications.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    head_dim=112,
    d_ff=14336,
    vocab_size=32000,
    attn_kind="gqa",
    ssm_kind="mamba2",
    ssm_state=64,
    ssm_heads=112,  # d_inner = 2*d_model, mamba2 head_dim 64
    attn_every=6,
    source="arXiv:2411.15242; unverified",
)
