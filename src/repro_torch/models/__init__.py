"""The port's models: the dense GQA decoder of the serving engine.

``build_model(cfg)`` returns the `Model` record of plain functions over a
parameter module (`registry.py`); `attention.py`, `blocks.py` and `lm.py`
follow the reference's module of the same name.
"""
from repro_torch.models.registry import Model, build_model

__all__ = ["Model", "build_model"]
