"""Gradient compression with error feedback (the reference's
`repro.training.compress`).

Int8 block quantization: per-block scale = max|g|/127, with the
quantization residual fed back into the next step's gradient (error
feedback), which is what keeps convergence intact.  ``torch.round``
rounds half to even, as ``jnp.round`` does.  On one card nothing is
reduced across devices: the transform is the reference's math alone.

Blocks run over a flattened leaf of the reference's tree, where a stack of
layers is one [L, ...] array: a block of a small leaf (a norm's weight,
qwen3's per-head q/k norms) spans layers, and its scale is the max over
them.  The port keeps one leaf per layer, so leaves whose paths differ
only in their list indices (``stack0.0.ln1``, ``stack0.1.ln1``; zamba's
``groups.<g>.<l>...``) are quantized as one flat vector, in layer order,
as the reference quantizes its stacked leaf.
"""
from __future__ import annotations

import re
from dataclasses import dataclass

import torch

from repro_torch.utils.tree import (tree_paths_and_leaves, tree_unflatten,
                                    tree_zeros_like_f32)

_INDEX = re.compile(r"(^|[./])\d+(?=[./]|$)")


@dataclass(frozen=True)
class CompressionConfig:
    enabled: bool = True
    block: int = 256
    bits: int = 8


def _quant_dequant(g: torch.Tensor, cfg: CompressionConfig) -> torch.Tensor:
    flat = g.reshape(-1)
    pad = (-flat.shape[0]) % cfg.block
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    blocks = flat.reshape(-1, cfg.block)
    qmax = 2.0 ** (cfg.bits - 1) - 1
    scale = blocks.abs().amax(dim=1, keepdim=True) / qmax
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(blocks / scale), -qmax, qmax)
    return (q * scale).reshape(-1)[: g.numel()].reshape(g.shape)


def init_feedback(params):
    return tree_zeros_like_f32(params)


def _stacked(paths: list[str]) -> list[list[int]]:
    """The leaves (by index, in layer order) of each of the reference's
    stacked arrays: paths equal but for their numeric components."""
    groups: dict[str, list[int]] = {}
    for i, path in enumerate(paths):
        groups.setdefault(_INDEX.sub(r"\1*", path), []).append(i)
    return list(groups.values())


def compress_with_feedback(grads, feedback, cfg: CompressionConfig):
    """Returns (compressed grads, new feedback residuals), trees of the
    structures given."""
    if not cfg.enabled:
        return grads, feedback
    named = tree_paths_and_leaves(grads)
    gs = [g for _, g in named]
    rs = [r for _, r in tree_paths_and_leaves(feedback)]
    out_g, out_r = [None] * len(gs), [None] * len(gs)
    for idx in _stacked([path for path, _ in named]):
        g32 = torch.cat([(gs[i].to(torch.float32) + rs[i]).reshape(-1)
                         for i in idx])
        deq = _quant_dequant(g32, cfg)
        res = g32 - deq
        at = 0
        for i in idx:
            n, shape = gs[i].numel(), gs[i].shape
            out_g[i] = deq[at:at + n].reshape(shape).to(gs[i].dtype)
            out_r[i] = res[at:at + n].reshape(shape)
            at += n
    return tree_unflatten(grads, out_g), tree_unflatten(feedback, out_r)
