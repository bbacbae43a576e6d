"""Carry the reference model's parameters into the port.

``params_from_reference`` takes the JAX model's parameter pytree as nested
dicts of NumPy arrays (``jax.device_get(params)``, laid out as the
reference's ``lm.py`` builds it) and returns the port's `ParamTree`, with
the reference's stacked groups split into per-layer trees:

* ``stack<i>`` (the attention decoder's stacks: dense or MoE FFN, GQA or
  MLA attention, their nested groups such as ``moe`` / ``shared`` or
  MLA's ``wdkv`` / ``kv_norm`` / ``wuk`` / ``wuv`` split alike),
  ``layers`` (rwkv), ``tail`` (zamba), ``encoder`` and ``decoder`` (the
  encoder-decoder): a leading L -> a list of L trees;
* ``groups`` (zamba): [G, per, ...] -> G lists of ``per`` trees;
* ``shared`` (zamba): ``block`` unstacked, ``lora`` [G, ...] -> G trees.

Every value is kept exactly (bfloat16 arrays by their bits, float32 ones
such as ``A_log`` and ``dt_bias`` as float32), so the tests can feed one
set of weights to both packages.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.layers import ParamTree

_STACKED = ("layers", "tail", "encoder", "decoder")


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


def _unstack(tree: dict, device, depth: int = 1):
    """A tree of arrays stacked ``depth`` times -> nested lists of trees."""
    if depth == 0:
        return _map(tree, lambda a: tensor_from_numpy(a, device))
    return [_unstack(_map(tree, lambda a, i=i: np.asarray(a)[i]), device,
                     depth - 1) for i in range(_leading(tree))]


def params_from_reference(tree: dict, device="cpu") -> ParamTree:
    """The port's parameters for a reference attention-decoder (dense,
    MoE, MLA, patch input), rwkv, zamba or encoder-decoder pytree."""
    out = {}
    for key, value in tree.items():
        if key.startswith("stack") or key in _STACKED:
            out[key] = _unstack(value, device)
        elif key == "groups":
            out[key] = _unstack(value, device, depth=2)
        elif key == "shared":
            out[key] = {"block": _unstack(value["block"], device, depth=0),
                        "lora": _unstack(value["lora"], device)}
        elif isinstance(value, dict):
            raise KeyError(f"{key!r} is no parameter group of the "
                           "reference's models")
        else:
            out[key] = tensor_from_numpy(value, device)
    return ParamTree(out)
