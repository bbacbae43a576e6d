"""Collective wire bytes of the port's training step, from its placements
(the reference's `repro.utils.hlo`).

The reference parses XLA's optimized HLO text for its collective ops,
since ``cost_analysis()`` does not report them.  Nothing here parses HLO:
PyTorch compiles no SPMD program whose text could be read.  The port's
collectives are the ones its training step issues by hand
(`repro_torch.training.loop`, `repro_torch.distributed.seq_parallel`), so
they follow from the resolved placements (`repro_torch.distributed.
sharding`): per parameter leaf, an all-gather of the parameter over the
mesh axes that shard it where it is read (`distributed.param_gather`:
twice a step for a checkpointed layer's leaf, in its forward and in its
re-run, once for the others), a reduce-scatter of its gradient over
those axes, and an all-reduce of the gradient's shard over the other
mesh axes that split the batch or the sequence; the loss's all-reduce
over those axes.  Where the head and the table are vocab-sharded, their
vocab axis takes no gather and no reduction of them; the embedding
gathers the tokens and reduce-scatters its rows (its gradient gathered
back), and the loss gathers the normed rows (their gradient
reduce-scattered back) and the targets and all-reduces each row's
maximum and its two sums, and is not all-reduced over that axis.
Where the sequence is split over ``model``, each attention layer
also gathers its K/V over that axis twice a step (its forward and its
checkpointed re-run) and reduce-scatters their gradient once (MLA its
latent), and so does each recurrent layer with its token shifts' rows
and its scan state (``halos``, `launch.dryrun.split_halos`).  Where the
experts are sharded over that axis (``experts``: each rank keeps its
own), they take no gather or reduction over it, and each MoE layer
gathers its rows (``tokens``) twice, in its forward and its re-run, and
reduce-scatters its partial outputs once (the re-run stops before it),
each mirrored once in the backward; elsewhere each MoE layer gathers
its pair counts twice and has no gradient to scatter (``counts``).
Each is costed with the
reference's ring formulas (per device, a group of k participants):

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
                     seq_axes=(), attn_layers: int = 0, kv_bytes: int = 0,
                     halos: dict | None = None,
                     counts: dict | None = None, layer_leaves=frozenset(),
                     vocab: dict | None = None, experts: dict | None = None,
                     tokens: dict | None = None) -> list[CollectiveOp]:
    """The collectives of one training step: ``specs`` and ``leaf_bytes``
    map each parameter leaf's path to its resolved spec and its full size
    in the gradient's dtype; ``batch_axes`` are the mesh axes the batch is
    split over, ``seq_axes`` those each sequence is split over, with
    ``attn_layers`` attention layers whose gathered K/V take ``kv_bytes``
    a layer on a card, and ``halos`` the other gathers of a split step
    ({name: one rank's operand bytes}: the token shifts' rows, the scan
    states), ``counts`` those without a gradient (the MoE's pair
    counts).  ``layer_leaves`` are the leaves a checkpointed layer
    gathers (twice a step); ``vocab`` ({"axis", "leaves": the table's
    and the head's names, "rows": the bytes of the sequence's normed
    rows of a card's batch rows, "tokens": of their int64 token ids,
    "stats": of a float32 a position}) where the table and the head are
    vocab-sharded; ``experts`` ({"axis", "leaves": their names}) the MoE
    expert leaves a rank keeps sharded over the sequence's axis, and
    ``tokens`` ({name: the bytes of a card's whole rows}) the MoE layers
    that then bring the rows to them."""
    sizes = mesh_shape(mesh)
    reducing = [a for a in dict.fromkeys((*batch_axes, *seq_axes))
                if sizes.get(a, 1) > 1]
    m = 1
    for axis in seq_axes:
        m *= sizes.get(axis, 1)
    ops = []
    if vocab is not None:
        ops += _vocab_collectives(vocab, sizes[vocab["axis"]],
                                  vocab["axis"] in seq_axes)
    if m > 1:
        for layer in range(attn_layers):
            name = f"attn{layer}"
            ops.append(CollectiveOp("all-gather", kv_bytes, kv_bytes // m, m,
                                    f"{name}.kv"))
            ops.append(CollectiveOp("all-gather", kv_bytes, kv_bytes // m, m,
                                    f"{name}.kv (remat)"))
            ops.append(CollectiveOp("reduce-scatter", kv_bytes // m,
                                    kv_bytes, m, f"{name}.dkv"))
        for name, one in (halos or {}).items():
            ops.append(CollectiveOp("all-gather", one * m, one, m, name))
            ops.append(CollectiveOp("all-gather", one * m, one, m,
                                    f"{name} (remat)"))
            ops.append(CollectiveOp("reduce-scatter", one, one * m, m,
                                    f"d{name}"))
        for name, one in (counts or {}).items():
            ops.append(CollectiveOp("all-gather", one * m, one, m, name))
            ops.append(CollectiveOp("all-gather", one * m, one, m,
                                    f"{name} (remat)"))
        for name, whole in (tokens or {}).items():
            ops.append(CollectiveOp("all-gather", whole, whole // m, m,
                                    name))
            ops.append(CollectiveOp("all-gather", whole, whole // m, m,
                                    f"{name} (remat)"))
            ops.append(CollectiveOp("reduce-scatter", whole // m, whole, m,
                                    f"d{name}"))
            ops.append(CollectiveOp("reduce-scatter", whole // m, whole, m,
                                    f"{name}.out"))
            ops.append(CollectiveOp("all-gather", whole, whole // m, m,
                                    f"d{name}.out"))
    for name, spec in specs.items():
        full = leaf_bytes[name]
        sharded = spec_axes(spec)
        axes = reducing
        keep = (vocab["axis"] if vocab is not None and name in vocab["leaves"]
                else experts["axis"] if experts is not None
                and name in experts["leaves"] else None)
        if keep is not None:
            full //= sizes[keep]
            sharded = {a: d for a, d in sharded.items() if a != keep}
            axes = [a for a in reducing if a != keep]
        k = 1
        for axis in sharded:
            k *= sizes[axis]
        rest = 1
        for axis in axes:
            if axis not in sharded:
                rest *= sizes[axis]
        if k > 1:
            ops.append(CollectiveOp("all-gather", full, full // k, k, name))
            if name in layer_leaves:
                ops.append(CollectiveOp("all-gather", full, full // k, k,
                                        f"{name} (remat)"))
            ops.append(CollectiveOp("reduce-scatter", full // k, full, k,
                                    name))
        if rest > 1:
            ops.append(CollectiveOp("all-reduce", full // k, full // k,
                                    rest, name))
    n = 1
    for axis in reducing:
        if vocab is None or axis != vocab["axis"]:
            n *= sizes[axis]
    if n > 1:
        ops.append(CollectiveOp("all-reduce", 4, 4, n, "loss"))
    return ops


def _vocab_collectives(vocab: dict, k: int, split: bool) -> list:
    """The vocab-sharded embedding's and loss's collectives over the
    vocab's ``k`` ranks (`distributed.param_gather`): with the sequence
    ``split`` over them, the tokens and the normed rows gathered, the
    embedding's rows and the rows' gradient reduce-scattered, the
    embedding's gradient and the targets gathered; where the sequence is
    whole on them, the embedding's rows and the rows' gradient
    all-reduced instead.  Each row's maximum and its sums all-reduced."""
    rows, tokens, stats = vocab["rows"], vocab["tokens"], vocab["stats"]
    if split:
        ops = [CollectiveOp("all-gather", tokens, tokens // k, k,
                            "embed.tokens"),
               CollectiveOp("reduce-scatter", rows // k, rows, k,
                            "embed.rows"),
               CollectiveOp("all-gather", rows, rows // k, k,
                            "embed.drows"),
               CollectiveOp("all-gather", rows, rows // k, k, "head.rows"),
               CollectiveOp("reduce-scatter", rows // k, rows, k,
                            "head.drows"),
               CollectiveOp("all-gather", tokens, tokens // k, k,
                            "head.targets")]
    else:
        ops = [CollectiveOp("all-reduce", rows, rows, k, "embed.rows"),
               CollectiveOp("all-reduce", rows, rows, k, "head.drows")]
    return ops + [CollectiveOp("all-reduce", stats, stats, k, "head.max"),
                  CollectiveOp("all-reduce", 2 * stats, 2 * stats, k,
                               "head.sums")]


def collective_wire_bytes(ops: list[CollectiveOp]) -> dict:
    """Per-collective-type wire bytes (per device) + total and count."""
    by_type: dict[str, float] = {}
    for c in ops:
        by_type[c.op] = by_type.get(c.op, 0.0) + c.wire_bytes
    by_type["total"] = sum(by_type.values())
    by_type["count"] = len(ops)
    return by_type
