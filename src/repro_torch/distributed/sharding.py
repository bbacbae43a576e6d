"""Logical-axis sharding rules of the port (the reference's
`repro.distributed.sharding`, t5x/MaxText style).

Parameters carry per-leaf logical axes (``Model.param_axes()``), and a
``ShardingPolicy`` maps logical names to mesh axes with the reference's
resolution: divisibility fallback (8 KV heads on a 16-way ``model`` axis
fall back to replication) and no mesh axis used for two dims of one
tensor.  A resolved spec is a tuple, the reference's ``PartitionSpec``
entry for entry: ``None``, a mesh axis name or a tuple of them, trailing
``None``s dropped.

Two rule sets live in one policy:
  * ``acts``   — activation rules (the batch's split over ``data``);
  * ``params`` — parameter rules overlaid on them (FSDP/ZeRO placements).

A spec becomes DTensor placements over a
``torch.distributed.device_mesh.DeviceMesh`` (`placements`): ``Shard(d)``
on each mesh axis that splits tensor dim d, ``Replicate()`` elsewhere and
on every mesh axis of size 1.  The resolver reads only the mesh's axis
names and sizes, so the dry run resolves production meshes through a
shape-only `repro_torch.launch.mesh.AbstractMesh`.

``shard`` is a no-op without a policy, as in the reference.  With one it
checks the tensor's rank and returns it as it is: the port runs the model
on each rank's local block (the batch split over ``data``, each sequence
over ``model``; `repro_torch.training.loop`), and the attention gathers
the K/V it needs itself (`repro_torch.distributed.seq_parallel`).
"""
from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass, field, replace
from typing import Any

# Rules map a logical axis name to a mesh axis name, a tuple of mesh axes,
# or None (replicated). Order matters only through the tensor's own axes.
DEFAULT_RULES: dict = {
    # activations
    "batch": ("pod", "data"),
    "seq": None,
    "embed": None,
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "qk_dim": None,
    "ff": "model",
    "vocab": "model",
    "expert": "model",
    "expert_capacity": None,
    "kv_lora": None,
    "state": None,
    "inner": "model",   # SSM inner projections (rwkv/mamba d_inner)
    "conv_k": None,
    "lora_rank": None,
    "attn_seq": None,     # q seq in the chunked path (heads carry `model`)
    "attn_kv_seq": None,  # gathered key/value seq
    "attn_head": None,    # head dims in the dense path (seq carries `model`)
    "logit_seq": None,    # LM-head seq dim (vocab carries `model`)
    "cache_seq": None,
    "src_seq": None,
    "patches": None,
    # parameters (stacked layer dim never sharded)
    "layers": None,
    "groups": None,
}

# Training: sequence-parallel residual stream + FSDP parameters over `data`.
TRAIN_RULES = dict(DEFAULT_RULES)
TRAIN_RULES.update({"seq": "model"})
TRAIN_PARAM_RULES = {
    # FSDP: shard the long dim of weight matrices over `data` as well
    "embed": "data",
    "ff": "model",
    "vocab": "model",
    "heads": "model",
    "kv_heads": "model",
    "expert": "model",
}

# Decode/prefill: weights sharded over model only (no FSDP gather per step);
# batch over data, KV cache heads over model with seq fallback.
DECODE_RULES = dict(DEFAULT_RULES)
DECODE_RULES.update({"seq": None, "cache_seq": None})
DECODE_PARAM_RULES = {
    # ZeRO-style 2D weight sharding for serving: embed dim over `data`,
    # heads/ff/vocab over `model`.
    "embed": "data",
    "ff": "model",
    "vocab": "model",
    "heads": "model",
    "kv_heads": "model",
    "expert": "model",
    "inner": "model",
}


def mesh_shape(mesh) -> dict:
    """{axis name: size}, in the mesh's axis order."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None and not isinstance(mesh.shape, dict):
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


@dataclass(frozen=True)
class ShardingPolicy:
    """Maps logical axis names to mesh axes for activations and params.

    ``acts`` holds the activation rules; ``params`` overlays
    parameter-specific rules (FSDP/ZeRO assignments) on top of them."""
    mesh: Any
    acts: dict = field(default_factory=lambda: dict(DEFAULT_RULES))
    params: dict = field(default_factory=dict)

    def _resolve(self, logical_axes, dims, rules) -> tuple:
        """Logical names -> spec with divisibility + reuse fallback."""
        shape = mesh_shape(self.mesh)
        used: set = set()
        spec = []
        for i, name in enumerate(logical_axes):
            rule = rules.get(name, None)
            if rule is None:
                spec.append(None)
                continue
            axes = rule if isinstance(rule, tuple) else (rule,)
            # drop axes missing from the mesh or already used by this tensor
            axes = tuple(a for a in axes if a in shape and a not in used)
            if not axes:
                spec.append(None)
                continue
            if dims is not None and dims[i] % _prod(shape[a] for a in axes):
                # divisibility fallback: try shrinking the axis tuple
                while axes and dims[i] % _prod(shape[a] for a in axes):
                    axes = axes[:-1]
                if not axes:
                    spec.append(None)
                    continue
            used.update(axes)
            spec.append(axes if len(axes) > 1 else axes[0])
        while spec and spec[-1] is None:
            spec.pop()
        return tuple(spec)

    def act_spec(self, logical_axes, dims=None) -> tuple:
        """The spec of an activation under the ``acts`` rules."""
        return self._resolve(logical_axes, dims, dict(self.acts))

    def param_spec(self, logical_axes, dims=None) -> tuple:
        """The spec of a parameter (``params`` overlaid on ``acts``)."""
        rules = dict(self.acts)
        rules.update(self.params)
        return self._resolve(logical_axes, dims, rules)

    def with_rules(self, acts=None, params=None) -> "ShardingPolicy":
        """A copy of this policy with rule overrides merged in."""
        new_acts = dict(self.acts)
        new_acts.update(acts or {})
        new_params = dict(self.params)
        new_params.update(params or {})
        return replace(self, acts=new_acts, params=new_params)


def _prod(it):
    out = 1
    for x in it:
        out *= x
    return out


def spec_axes(spec: tuple) -> dict:
    """{mesh axis: tensor dim} of a resolved spec."""
    out = {}
    for dim, entry in enumerate(spec):
        for axis in (entry if isinstance(entry, tuple) else (entry,)):
            if axis is not None:
                out[axis] = dim
    return out


def placements(mesh, spec: tuple) -> tuple:
    """DTensor placements of ``spec``, one per mesh axis in the mesh's
    order: ``Shard(d)`` where the axis splits tensor dim d, else (and on
    an axis of size 1, where a shard is the whole) ``Replicate()``.  A dim
    split by several axes is split major-first, as the spec lists them."""
    from torch.distributed.tensor import Replicate, Shard

    by_axis = spec_axes(spec)
    return tuple(Shard(by_axis[a]) if a in by_axis and size > 1
                 else Replicate() for a, size in mesh_shape(mesh).items())


def local_shape(mesh, spec: tuple, dims) -> tuple:
    """The per-card block of a tensor of ``dims`` under ``spec``."""
    sizes = mesh_shape(mesh)
    out = list(dims)
    for axis, dim in spec_axes(spec).items():
        out[dim] //= sizes[axis]
    return tuple(out)


def local_block(x, mesh, spec: tuple):
    """This rank's block of a tensor every rank holds whole: split along
    each dim over its spec's mesh axes, major axis first (DTensor's
    ``Shard`` order)."""
    sizes = mesh_shape(mesh)
    for dim, entry in enumerate(spec):
        for axis in (entry if isinstance(entry, tuple) else (entry,)):
            if axis is not None and sizes[axis] > 1:
                x = x.tensor_split(sizes[axis], dim)[
                    mesh.get_local_rank(axis)]
    return x


_state = threading.local()


def current_policy() -> ShardingPolicy | None:
    """The thread-local active policy (None outside `apply_policy`)."""
    return getattr(_state, "policy", None)


@contextlib.contextmanager
def apply_policy(policy: ShardingPolicy | None):
    """Make ``policy`` the thread-local active policy for the block."""
    prev = current_policy()
    _state.policy = policy
    try:
        yield policy
    finally:
        _state.policy = prev


def shard(x, *logical_axes):
    """Annotate an activation with logical axes; no-op without a policy.
    With one, the rank is checked and ``x`` (already its rank's block)
    returned; see the module docstring."""
    if current_policy() is not None and len(logical_axes) != x.ndim:
        raise ValueError(
            f"shard(): {len(logical_axes)} logical axes for rank-{x.ndim} tensor"
        )
    return x


def axes_by_path(param_axes, prefix: str = "") -> dict:
    """{leaf path: tuple of logical names} of a ``param_axes()`` (or
    ``cache_axes``) table, paths dotted as a `ParamTree`'s
    ``named_parameters``; a "." axis name is None, as in the reference."""
    if isinstance(param_axes, dict):
        items = param_axes.items()
    elif isinstance(param_axes, (list, tuple)):   # layers, a state's slots
        items = enumerate(param_axes)
    else:
        return {prefix[:-1]: tuple(a if a != "." else None
                                   for a in param_axes.split())}
    out = {}
    for key, sub in items:
        out.update(axes_by_path(sub, f"{prefix}{key}."))
    return out


def param_shardings(policy: ShardingPolicy, params, param_axes) -> dict:
    """{leaf path: spec} for a `ParamTree` (or a tree of its structure,
    such as AdamW's moments) given its logical-axes table."""
    axes = axes_by_path(param_axes)
    out = {}
    for name, leaf in params.named_parameters():
        if len(axes[name]) != leaf.ndim:
            raise ValueError(f"axes {axes[name]!r} vs shape "
                             f"{tuple(leaf.shape)} at {name}")
        out[name] = policy.param_spec(axes[name], tuple(leaf.shape))
    return out
