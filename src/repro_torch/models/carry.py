"""Carry the reference model's parameters into the port.

``params_from_reference`` takes the JAX model's parameter pytree as nested
dicts of NumPy arrays (``jax.device_get(params)``; layers stacked with a
leading L per stack, as the reference's ``lm.py`` builds them) and returns
the port's `ParamTree` with the stacks split into per-layer trees.  Every
value is kept exactly (bfloat16 arrays by their bits), so the tests can
feed one set of weights to both packages.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.layers import ParamTree


def tensor_from_numpy(a, device="cpu") -> torch.Tensor:
    """An exact tensor copy of ``a`` (bfloat16 by its 16-bit pattern)."""
    a = np.array(a)                      # a writable, contiguous copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16) \
            .to(device)
    return torch.from_numpy(a).to(device)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def _leading(tree) -> int:
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return np.asarray(tree).shape[0]


def params_from_reference(tree: dict, device="cpu") -> ParamTree:
    """The port's parameters for a reference dense-family pytree."""
    out = {}
    for key, value in tree.items():
        if key.startswith("stack"):
            out[key] = [_map(value, lambda a, l=l: tensor_from_numpy(
                np.asarray(a)[l], device)) for l in range(_leading(value))]
        elif isinstance(value, dict):
            raise NotImplementedError(f"parameter group {key!r} belongs to a "
                                      "family the port does not build yet")
        else:
            out[key] = tensor_from_numpy(value, device)
    return ParamTree(out)
