"""Model, cluster and router configurations of the port.

``get_config("<arch-id>")`` returns a model configuration; the registry
lists the reference's ten architectures, all of which the port builds
(`repro_torch.models`): the dense GQA family (``qwen3-8b``,
``qwen2.5-32b``, ``qwen2-72b``, ``deepseek-coder-33b``), the MoE family
(``mixtral-8x22b``, sliding-window GQA, and ``deepseek-v2-lite-16b``,
MLA), ``rwkv6-3b`` (RWKV-6), ``zamba2-7b`` (the Mamba-2 hybrid with a
shared attention block), ``llava-next-34b`` (a dense decoder with
prepended patch embeddings) and ``seamless-m4t-medium`` (the
encoder-decoder).
"""
from __future__ import annotations

from repro_torch.configs import (deepseek_coder_33b, deepseek_v2_lite_16b,
                                 llava_next_34b, mixtral_8x22b, qwen2_5_32b,
                                 qwen2_72b, qwen3_8b, rwkv6_3b,
                                 seamless_m4t_medium, zamba2_7b)
from repro_torch.configs.base import (SHAPES, ModelConfig, ShapeConfig,
                                      cell_supported, model_flops,
                                      param_counts)

ARCHS: dict[str, ModelConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (rwkv6_3b, mixtral_8x22b, deepseek_v2_lite_16b,
              seamless_m4t_medium, deepseek_coder_33b, qwen2_72b, qwen3_8b,
              qwen2_5_32b, llava_next_34b, zamba2_7b)}


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(ARCHS)}")
    return ARCHS[arch_id]


def list_archs() -> list[str]:
    return sorted(ARCHS)


__all__ = [
    "ARCHS", "SHAPES", "ModelConfig", "ShapeConfig", "get_config",
    "list_archs", "cell_supported", "model_flops", "param_counts",
]
