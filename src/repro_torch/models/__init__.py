"""The port's models: the serving engine's dense GQA decoder, RWKV-6 and
the zamba2 hybrid (Mamba-2 with a shared attention block).

``build_model(cfg)`` returns the `Model` record of plain functions over a
parameter module (`registry.py`); `attention.py`, `ssm.py`, `blocks.py`
and `lm.py` follow the reference's module of the same name.
"""
from repro_torch.models.registry import Model, build_model

__all__ = ["Model", "build_model"]
