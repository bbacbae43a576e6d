"""The serving cluster's engine configurations.

Only ``_engine_config`` is ported so far: the three reduced model classes
(`configs/iemas_cluster.py::MODEL_CLASSES`) that the reference's
``SimCluster`` derives from ``qwen3-8b`` for its real engines.  The
simulated cluster itself (queueing, faults, the virtual clock) waits for
the simulator slice.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs import get_config
from repro_torch.configs.iemas_cluster import MODEL_CLASSES


def _engine_config(model_class: str, vocab: int):
    n_layers, d_model, n_heads, d_ff, _scale = MODEL_CLASSES[model_class]
    base = get_config("qwen3-8b").scaled(dtype="float32")
    return dataclasses.replace(
        base, name=f"engine-{model_class}", n_layers=n_layers, d_model=d_model,
        n_heads=n_heads, n_kv_heads=n_heads, head_dim=d_model // n_heads,
        d_ff=d_ff, vocab_size=vocab + 1, qk_norm=False)
