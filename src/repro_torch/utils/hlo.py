"""Collective wire bytes of the port's training step, from its placements
(the reference's `repro.utils.hlo`).

The reference parses XLA's optimized HLO text for its collective ops,
since ``cost_analysis()`` does not report them.  Nothing here parses HLO:
PyTorch compiles no SPMD program whose text could be read.  The port's
collectives are the ones its training step issues by hand
(`repro_torch.training.loop`, `repro_torch.distributed.seq_parallel`), so
they follow from the resolved placements (`repro_torch.distributed.
sharding`): per parameter leaf, an all-gather of the parameter over the
mesh axes that shard it, a reduce-scatter of its gradient over those
axes, and an all-reduce of the gradient's shard over the other mesh axes
that split the batch or the sequence; the loss's all-reduce over those
axes.  Where the sequence is split over ``model``, each attention layer
also gathers its K/V over that axis twice a step (its forward and its
checkpointed re-run) and reduce-scatters their gradient once.
Each is costed with the reference's ring formulas (per device, a group of
k participants):

    all-reduce        2 * S * (k-1)/k     (reduce-scatter + all-gather phases)
    all-gather        R * (k-1)/k         (R = gathered result bytes)
    reduce-scatter    S * (k-1)/k         (S = operand bytes)
    all-to-all        S * (k-1)/k
    collective-permute  R                 (point-to-point)

The gradient norm's few-byte all-reduce is left out.  The step issues one
collective per mesh axis where this plan has one over several axes (the
same bytes on a ring of each axis's size); `tests/torch_port/
test_torch_seq_parallel.py` counts the step's own.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.distributed.sharding import mesh_shape, spec_axes


@dataclass
class CollectiveOp:
    op: str
    result_bytes: int
    operand_bytes: int
    group_size: int
    computation: str = ""

    @property
    def wire_bytes(self) -> float:
        k = max(self.group_size, 1)
        ring = (k - 1) / k if k > 1 else 0.0
        if self.op == "all-reduce":
            return 2.0 * self.operand_bytes * ring
        if self.op == "all-gather":
            return self.result_bytes * ring
        if self.op == "reduce-scatter":
            return self.operand_bytes * ring
        if self.op == "all-to-all":
            return self.operand_bytes * ring
        if self.op == "collective-permute":
            return float(self.result_bytes)
        return float(self.result_bytes)


def step_collectives(mesh, specs: dict, leaf_bytes: dict, batch_axes,
                     seq_axes=(), attn_layers: int = 0,
                     kv_bytes: int = 0) -> list[CollectiveOp]:
    """The collectives of one training step: ``specs`` and ``leaf_bytes``
    map each parameter leaf's path to its resolved spec and its full size
    in the gradient's dtype; ``batch_axes`` are the mesh axes the batch is
    split over, ``seq_axes`` those each sequence is split over, with
    ``attn_layers`` attention layers whose gathered K/V take ``kv_bytes``
    a layer on a card."""
    sizes = mesh_shape(mesh)
    reducing = [a for a in dict.fromkeys((*batch_axes, *seq_axes))
                if sizes.get(a, 1) > 1]
    m = 1
    for axis in seq_axes:
        m *= sizes.get(axis, 1)
    ops = []
    if m > 1:
        for layer in range(attn_layers):
            name = f"attn{layer}"
            ops.append(CollectiveOp("all-gather", kv_bytes, kv_bytes // m, m,
                                    f"{name}.kv"))
            ops.append(CollectiveOp("all-gather", kv_bytes, kv_bytes // m, m,
                                    f"{name}.kv (remat)"))
            ops.append(CollectiveOp("reduce-scatter", kv_bytes // m,
                                    kv_bytes, m, f"{name}.dkv"))
    for name, spec in specs.items():
        full = leaf_bytes[name]
        sharded = spec_axes(spec)
        k = 1
        for axis in sharded:
            k *= sizes[axis]
        rest = 1
        for axis in reducing:
            if axis not in sharded:
                rest *= sizes[axis]
        if k > 1:
            ops.append(CollectiveOp("all-gather", full, full // k, k, name))
            ops.append(CollectiveOp("reduce-scatter", full // k, full, k,
                                    name))
        if rest > 1:
            ops.append(CollectiveOp("all-reduce", full // k, full // k,
                                    rest, name))
    n = 1
    for axis in reducing:
        n *= sizes[axis]
    if n > 1:
        ops.append(CollectiveOp("all-reduce", 4, 4, n, "loss"))
    return ops


def collective_wire_bytes(ops: list[CollectiveOp]) -> dict:
    """Per-collective-type wire bytes (per device) + total and count."""
    by_type: dict[str, float] = {}
    for c in ops:
        by_type[c.op] = by_type.get(c.op, 0.0) + c.wire_bytes
    by_type["total"] = sum(by_type.values())
    by_type["count"] = len(ops)
    return by_type
