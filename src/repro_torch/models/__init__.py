"""The port's models: the serving engine's attention decoder (GQA or MLA
attention, dense or MoE FFN, optional patch inputs), RWKV-6, the zamba2
hybrid (Mamba-2 with a shared attention block) and the encoder-decoder.

``build_model(cfg)`` returns the `Model` record of plain functions over a
parameter module (`registry.py`); `attention.py`, `moe.py`, `ssm.py`,
`blocks.py`, `lm.py` and `encdec.py` follow the reference's module of the
same name.
"""
from repro_torch.models.registry import Model, build_model

__all__ = ["Model", "build_model"]
