"""Tree utilities of the port (the reference's `repro.utils.tree`).

A tree is a `ParamTree` or a nested dict, list or tuple of tensors.  Its
leaves come in one order everywhere: ``named_parameters()`` order for a
`ParamTree` (so a leaf's path is its ``state_dict`` name), insertion order
for a dict, index order for a list or tuple.  ``tree_map`` returns a tree
of the same kind: a new `ParamTree` (frozen leaves, as `ParamTree` makes
them) for a `ParamTree`.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models.layers import ParamTree


def tree_paths_and_leaves(tree, prefix: str = "") -> list:
    """[(path, tensor)] in the tree's order; paths join keys and indices
    with "/", and a `ParamTree`'s leaves are named as in its
    ``state_dict``."""
    if isinstance(tree, nn.Module):
        return [(prefix + name, p) for name, p in tree.named_parameters()]
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return [(prefix.removesuffix("/"), tree)]
    return [leaf for key, sub in items
            for leaf in tree_paths_and_leaves(sub, f"{prefix}{key}/")]


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in tree_paths_and_leaves(tree)]


def _rebuild(module: nn.Module, by_name: dict, prefix: str):
    if isinstance(module, nn.ModuleList):
        return [_rebuild(m, by_name, f"{prefix}{i}.")
                for i, m in enumerate(module)]
    out = {n: by_name[prefix + n] for n in module._parameters}
    out.update({n: _rebuild(m, by_name, f"{prefix}{n}.")
                for n, m in module._modules.items()})
    return out


def tree_unflatten(like, leaves):
    """A tree of ``like``'s structure holding ``leaves`` (in its order)."""
    leaves = iter(leaves)
    return _unflatten(like, leaves)


def _unflatten(like, leaves):
    if isinstance(like, nn.Module):
        names = [n for n, _ in like.named_parameters()]
        return ParamTree(_rebuild(like, dict(zip(names, leaves)), ""))
    if isinstance(like, dict):
        return {k: _unflatten(v, leaves) for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(v, leaves) for v in like)
    return next(leaves)


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and of the trees ``rest`` (of the
    same structure), leaf by leaf, into a new tree of ``tree``'s kind."""
    others = [tree_leaves(r) for r in rest]
    return tree_unflatten(tree, [fn(*xs) for xs in zip(tree_leaves(tree),
                                                          *others)])


def param_count(tree) -> int:
    """Total number of parameters in a tree."""
    return int(sum(x.numel() for x in tree_leaves(tree)))


def param_bytes(tree) -> int:
    return int(sum(x.numel() * x.element_size() for x in tree_leaves(tree)))


def tree_cast(tree, dtype):
    return tree_map(lambda x: x.detach().to(dtype), tree)


def tree_zeros_like_f32(tree):
    """float32 zeros of the same structure and shapes, on each leaf's
    device: the optimizer's state."""
    return tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                          device=x.device), tree)


def tree_global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's float32 sum of squares
    (the reference's order: per-leaf sums first)."""
    sums = [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sums)))


def tree_add(a, b):
    return tree_map(torch.add, a, b)


def tree_scale(a, s):
    return tree_map(lambda x: x * s, a)
