"""Model, cluster and router configurations of the port.

``get_config("<arch-id>")`` returns a model configuration; the registry
lists only the architectures the port can build (`repro_torch.models`):
the dense GQA family (``qwen3-8b``, ``qwen2.5-32b``, ``qwen2-72b``,
``deepseek-coder-33b``), the MoE family (``mixtral-8x22b``, sliding-window
GQA, and ``deepseek-v2-lite-16b``, MLA), ``rwkv6-3b`` (RWKV-6) and
``zamba2-7b`` (the Mamba-2 hybrid with a shared attention block).  The
reference's patch-input and encoder-decoder architectures arrive with the
slice that ports them.
"""
from __future__ import annotations

from repro_torch.configs import (deepseek_coder_33b, deepseek_v2_lite_16b,
                                 mixtral_8x22b, qwen2_5_32b, qwen2_72b,
                                 qwen3_8b, rwkv6_3b, zamba2_7b)
from repro_torch.configs.base import ModelConfig, param_counts

ARCHS: dict[str, ModelConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (rwkv6_3b, mixtral_8x22b, deepseek_v2_lite_16b,
              deepseek_coder_33b, qwen2_72b, qwen3_8b, qwen2_5_32b,
              zamba2_7b)}


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(ARCHS)}")
    return ARCHS[arch_id]


def list_archs() -> list[str]:
    return sorted(ARCHS)


__all__ = ["ARCHS", "ModelConfig", "get_config", "list_archs",
           "param_counts"]
