"""seamless-m4t-medium — encoder-decoder multimodal (audio) backbone.

[arXiv:2308.11596; hf] 12L d_model=1024 16H d_ff=4096 vocab=256206.
The speech frontend is a STUB per the assignment: ``input_specs()`` provides
precomputed frame embeddings [B, src_len, d_model]. Convention (DESIGN.md):
``seq_len`` refers to the decoder; encoder source length is 1024 frames.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="audio",
    n_layers=12,       # decoder layers
    enc_layers=12,     # encoder layers
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=256206,
    attn_kind="gqa",
    src_len=1024,
    source="arXiv:2308.11596; hf",
)
