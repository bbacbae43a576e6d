"""llava-next-34b — VLM; dense LM backbone with anyres patch embeddings.

[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]
60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000.
The vision tower is a STUB per the assignment: ``input_specs()`` provides
precomputed anyres patch embeddings [B, n_patches=2880, d_model] that are
prepended to the text token embeddings (5 tiles x 576 patches).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b",
    family="vlm",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=20480,
    vocab_size=64000,
    attn_kind="gqa",
    rope_theta=5e6,
    n_patches=2880,
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified",
)
