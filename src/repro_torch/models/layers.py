"""Shared model primitives: the parameter tree, norms, RoPE, SwiGLU, inits.

Parameters live in a `ParamTree`: an ``nn.Module`` whose leaves are frozen
``nn.Parameter``s read as ``p["name"]``, like the reference's nested dicts
of arrays, so each model function keeps the reference's shape (init,
apply).  ``.to(device)``, ``state_dict`` and ``parameters()`` work as on
any module.  The reference's float32 islands stay: `rms_norm` and
`apply_rope` compute in float32 and cast back.
"""
from __future__ import annotations

import torch
from torch import nn


class ParamTree(nn.Module):
    """Nested frozen parameters: a dict becomes a child tree, a list a
    ``ModuleList`` of trees (one per layer; a list of lists, such as
    zamba2's groups of layers, nests), a tensor a parameter."""

    def __init__(self, tree: dict):
        super().__init__()
        for name, value in tree.items():
            if isinstance(value, (dict, list, tuple)):
                self.add_module(name, _module(value))
            else:
                self.register_parameter(
                    name, nn.Parameter(value, requires_grad=False))

    def __getitem__(self, name: str):
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules


def _module(value) -> nn.Module:
    if isinstance(value, dict):
        return ParamTree(value)
    return nn.ModuleList(_module(t) for t in value)


def normal_init(shape, fan_in: int, dtype, *, generator: torch.Generator,
                scale: float = 1.0) -> torch.Tensor:
    """A float32 normal draw of std ``scale / sqrt(fan_in)`` on the
    generator's device, cast to ``dtype`` (as the reference draws)."""
    std = scale / max(fan_in, 1) ** 0.5
    x = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=generator.device)
    return (x * std).to(dtype)


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    rms = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return ((xf * rms) * weight.float()).to(x.dtype)


def group_norm_heads(x: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor, n_heads: int,
                     eps: float = 1e-5) -> torch.Tensor:
    """Per-head group norm over [..., n_heads*head_dim] (the RWKV-6 output
    norm), in float32, cast back to x's dtype."""
    shape = x.shape
    xf = x.float().reshape(*shape[:-1], n_heads, shape[-1] // n_heads)
    mean = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, unbiased=False)
    xf = ((xf - mean) * torch.rsqrt(var + eps)).reshape(shape)
    return (xf * weight.float() + bias.float()).to(x.dtype)


# ---------------- RoPE ----------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    # a Python-scalar base: a device tensor made from ``theta`` would be a
    # host-to-device copy that waits for the stream, twice per layer
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return torch.pow(theta, -exps)


def apply_rope(x: torch.Tensor, pos: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [..., seq, heads, head_dim] (llama half-rotation), pos: [..., seq]."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                 # [d/2]
    angles = pos[..., None].float() * freqs                # [..., seq, d/2]
    cos = torch.cos(angles)[..., None, :]                  # over heads
    sin = torch.sin(angles)[..., None, :]
    x1 = x[..., : d // 2].float()
    x2 = x[..., d // 2:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------- SwiGLU FFN ----------------

def ffn_init(d_model: int, d_ff: int, dtype, *,
             generator: torch.Generator) -> dict:
    return {
        "wg": normal_init((d_model, d_ff), d_model, dtype,
                          generator=generator),
        "wu": normal_init((d_model, d_ff), d_model, dtype,
                          generator=generator),
        "wd": normal_init((d_ff, d_model), d_ff, dtype, generator=generator),
    }


def ffn_apply(p, x: torch.Tensor) -> torch.Tensor:
    h = torch.nn.functional.silu(x @ p["wg"])
    h = h * (x @ p["wu"])
    return h @ p["wd"]
