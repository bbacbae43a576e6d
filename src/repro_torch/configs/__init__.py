"""Model, cluster and router configurations of the port.

``get_config("<arch-id>")`` returns a model configuration; the registry
lists only the architectures the port can build (`repro_torch.models`):
``qwen3-8b`` (the dense GQA family), ``rwkv6-3b`` (RWKV-6) and
``zamba2-7b`` (the Mamba-2 hybrid with a shared attention block).  The
reference's other architectures arrive with the slices that port their
families.
"""
from __future__ import annotations

from repro_torch.configs import qwen3_8b, rwkv6_3b, zamba2_7b
from repro_torch.configs.base import ModelConfig, param_counts

ARCHS: dict[str, ModelConfig] = {
    m.CONFIG.name: m.CONFIG for m in (qwen3_8b, rwkv6_3b, zamba2_7b)}


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(ARCHS)}")
    return ARCHS[arch_id]


def list_archs() -> list[str]:
    return sorted(ARCHS)


__all__ = ["ARCHS", "ModelConfig", "get_config", "list_archs",
           "param_counts"]
