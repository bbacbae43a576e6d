"""A split training step's parameters kept as each rank's shards: the
port's counterpart of what the reference's compiled program does when
``TRAIN_PARAM_RULES`` shard every leaf and its layers run as a
``lax.scan`` over stacked leaves, each under ``jax.checkpoint``.

The step (`training.loop`) hands the model its ranks' local shards and
binds a `ParamGather` to the thread (`bind`), as it sets a
`seq_parallel.SeqSplit`; ``seq_parallel.bound`` carries both into a
checkpointed layer's re-run, which may run on the autograd engine's
device thread.  Under the binding:

* each checkpointed layer gathers its leaves whole where it starts
  (`whole`, one all-gather per mesh axis that shards a leaf, the minor
  axis first, as `training.loop.gathered` does): non-reentrant
  checkpointing saves only the shards, the re-run gathers the layer
  again, and the gather's backward reduces the layer's gradient to the
  rank's shard as the step's reduction always did (`StepMesh.reduce`: a
  sum over the axes that split the sequence, a mean over those that split
  the batch, a reduce-scatter over an axis that also shards the leaf).
  So a rank holds its shards and one layer whole at a time;
* the embedding table ``[vocab, embed]`` and the head ``[embed, vocab]``
  stay vocab-sharded over ``model``, as the reference's logits do
  (``shard(logits, "batch", "logit_seq", "vocab")``): only their
  ``embed`` dim is gathered (over ``data``).  `embedding` gathers the
  tokens over the sequence's ranks, looks up those in the rank's vocab
  rows (other tokens give 0) and reduce-scatters the partial sums back
  to each rank's block, exactly, each sum having one nonzero term.
  `vocab_nll` gathers the normed rows, computes every row's logits over
  the rank's vocab slice and builds the log-sum-exp from all-reduced
  maxima and sums, each target's logit from the rank that owns it: the
  loss is then the whole sequence's on every ``model`` rank.

Without a binding (no policy, or a mesh of one card) everything here is
the identity, or the plain op: the one-card policy step runs the plain
step's ops bit for bit.  The collectives are `seq_parallel`'s, counted by
kind in `seq_parallel.collective_counts`.
"""
from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass

import torch
import torch.distributed as dist
from torch import nn

from repro_torch.distributed import seq_parallel
from repro_torch.distributed.sharding import spec_axes


@dataclass(frozen=True)
class StepMesh:
    """The step's mesh as its collectives need it: ``sizes`` {axis: size}
    in the mesh's order, and for each axis above one card its process
    ``groups`` and this rank's coordinate in ``ranks``."""
    sizes: dict
    groups: dict
    ranks: dict

    @classmethod
    def of(cls, mesh) -> "StepMesh":
        """A `torch.distributed` ``DeviceMesh``'s."""
        from repro_torch.distributed.sharding import mesh_shape

        sizes = mesh_shape(mesh)
        big = [(i, a) for i, a in enumerate(sizes) if sizes[a] > 1]
        return cls(sizes, {a: mesh.get_group(i) for i, a in big},
                   {a: mesh.get_local_rank(a) for _, a in big})

    def axes(self, entry) -> tuple:
        """The mesh axes above one card in a spec entry."""
        return tuple(a for a in (entry if isinstance(entry, tuple)
                                 else (entry,))
                     if a is not None and self.sizes[a] > 1)

    def whole(self, t: torch.Tensor, spec: tuple) -> torch.Tensor:
        """``t``, this rank's block under ``spec``, gathered whole over
        each mesh axis that shards it, the minor axis first (undoing
        `sharding.local_block`)."""
        dims = spec_axes(spec)
        for a in reversed(self.sizes):
            if a in dims and self.sizes[a] > 1:
                t = seq_parallel.all_gather(t, dims[a], self.groups[a],
                                            self.sizes[a])
        return t

    def reduce(self, t: torch.Tensor, spec: tuple, sums=(),
               means=()) -> torch.Tensor:
        """``t`` (this rank's share, whole) summed over the mesh axes
        ``sums``, averaged over ``means``, and cut to ``spec``'s block (a
        reduce-scatter over an axis that also shards it)."""
        sharding = spec_axes(spec)
        for a in (*sums, *means):
            if a not in sharding:
                t = seq_parallel.all_reduce(t, self.groups[a])
        for dim, entry in enumerate(spec):
            for a in self.axes(entry):
                if a in sums or a in means:
                    t = seq_parallel.reduce_scatter(
                        t, dim, self.groups[a], self.sizes[a], self.ranks[a])
                else:
                    t = t.tensor_split(self.sizes[a], dim)[self.ranks[a]]
        n = 1
        for a in means:
            n *= self.sizes[a]
        return t / n if n > 1 else t


class _GatherLeaf(torch.autograd.Function):
    """A leaf's shard gathered whole on the way forward (`StepMesh.whole`);
    its whole gradient reduced to the shard on the way back
    (`StepMesh.reduce`)."""

    @staticmethod
    def forward(ctx, shard, mesh, spec, sums, means):
        ctx.plan = (mesh, spec, sums, means)
        return mesh.whole(shard, spec)

    @staticmethod
    def backward(ctx, g):
        mesh, spec, sums, means = ctx.plan
        if set(sums + means) - set(spec_axes(spec)):
            g = g.clone()         # its all-reduce writes in place
        return mesh.reduce(g, spec, sums, means), None, None, None, None


class ParamGather:
    """One step's binding: each local shard the model is handed (keyed by
    the tensor), its spec, and the step's reduction (``sums``: the mesh
    axes that split each sequence, ``means``: those that split the
    batch).  ``gathered`` holds the shards gathered since the binding
    began (`missed` names the rest)."""

    def __init__(self, mesh: StepMesh, leaves, specs, sums=(), means=()):
        self.mesh, self.sums, self.means = mesh, tuple(sums), tuple(means)
        self.specs = {id(t): tuple(s) for t, s in zip(leaves, specs)}
        self.gathered: set = set()

    def bound(self, t) -> bool:
        """Whether ``t`` is one of the step's shards."""
        return isinstance(t, torch.Tensor) and id(t) in self.specs

    def gather(self, t: torch.Tensor, keep=None) -> torch.Tensor:
        """Leaf ``t`` whole (`_GatherLeaf`), but over the mesh axis
        ``keep``, which stays sharded and out of the gradient's
        reduction (the vocab ops reduce over it themselves)."""
        self.gathered.add(id(t))
        spec, sums = self.specs[id(t)], self.sums
        if keep is not None:
            spec = tuple(None if self.mesh.axes(e) == (keep,) else e
                         for e in spec)
            sums = tuple(a for a in sums if a != keep)
        return _GatherLeaf.apply(t, self.mesh, spec, sums, self.means)

    def vocab_axis(self, t: torch.Tensor, dim: int):
        """The mesh axis that shards dim ``dim`` of leaf ``t`` (its vocab
        dim), or None where that dim is whole on every rank."""
        spec = self.specs[id(t)]
        axes = self.mesh.axes(spec[dim]) if dim < len(spec) else ()
        if len(axes) > 1:
            raise NotImplementedError(f"a vocab split over {axes} is not "
                                      "ported")
        return axes[0] if axes else None

    def expert_axis(self, t: torch.Tensor):
        """The mesh axis that shards dim 0 of leaf ``t`` (an MoE expert
        dim) where it is the axis that splits the sequence, as the
        training rules shard ``expert`` over ``model`` where E divides
        over its ranks; None elsewhere.  An MoE layer's rank then keeps
        its experts and brings the row's tokens to them
        (`models.moe`)."""
        spec = self.specs[id(t)]
        axes = self.mesh.axes(spec[0]) if spec else ()
        return axes[0] if len(axes) == 1 and axes[0] in self.sums else None

    def loss_axes(self, head: torch.Tensor) -> tuple:
        """The mesh axes the step sums a rank's loss over: the sequence's,
        less the vocab axis of ``head``, over which `vocab_nll`'s loss is
        already the whole sequence's."""
        axis = self.vocab_axis(head, 1)
        return tuple(a for a in self.sums if a != axis)

    def missed(self, leaves) -> list[int]:
        """The indices of ``leaves`` no layer has gathered."""
        return [i for i, t in enumerate(leaves)
                if id(t) not in self.gathered]


_state = threading.local()


def current() -> ParamGather | None:
    """The thread's binding (None outside `bind`)."""
    return getattr(_state, "gather", None)


@contextlib.contextmanager
def bind(g: ParamGather | None):
    """Make ``g`` the thread's binding for the block."""
    prev = current()
    _state.gather = g
    try:
        yield g
    finally:
        _state.gather = prev


EXPERT_LEAVES = ("wg", "wu", "wd")   # an MoE layer's, beside its router


def whole(tree):
    """``tree`` (a `ParamTree`, a dict, list or tuple, a tensor, anything
    else) with every bound leaf gathered whole, as plain dicts and lists
    (a `ParamTree` would detach them), but an MoE layer's expert leaves
    that `ParamGather.expert_axis` keeps sharded, which stay the rank's
    shards for `models.moe` to gather; the tree itself without a
    binding."""
    g = current()
    return tree if g is None else _whole(tree, g)


def _whole(tree, g: ParamGather):
    if isinstance(tree, nn.ModuleList):
        return [_whole(m, g) for m in tree]
    if isinstance(tree, nn.Module):
        items = {**tree._parameters, **tree._modules}
        return {k: _whole_item(k, v, "router" in items, g)
                for k, v in items.items()}
    if isinstance(tree, dict):
        return {k: _whole_item(k, v, "router" in tree, g)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_whole(v, g) for v in tree)
    return g.gather(tree) if g.bound(tree) else tree


def _whole_item(key, v, moe: bool, g: ParamGather):
    """`_whole` of a dict's item ``key``; ``moe``: the dict is an MoE
    layer's (it holds a router)."""
    if moe and key in EXPERT_LEAVES and g.bound(v) \
            and g.expert_axis(v) is not None:
        return v
    return _whole(v, g)


def vocab_sharded(t: torch.Tensor, dim: int) -> bool:
    """Whether leaf ``t``'s dim ``dim`` (its vocab) is sharded under the
    thread's binding."""
    g = current()
    return g is not None and g.vocab_axis(t, dim) is not None


class _ReduceScatter(torch.autograd.Function):
    """The ranks' sum of ``x``, this rank's slice along ``dim``; the
    gradient all-gathered back (`seq_parallel._Gather`'s mirror).  An
    emulated split (no group) counts the same collectives and acts as if
    every rank held this rank's tensors: the slice times the ranks."""

    @staticmethod
    def forward(ctx, x, s, dim):
        ctx.split, ctx.dim = s, dim
        if s.group is None:
            seq_parallel._COUNTS["reduce_scatter"] += 1
            return x.chunk(s.size, dim)[s.rank] * s.size
        return seq_parallel.reduce_scatter(x, dim, s.group, s.size, s.rank)

    @staticmethod
    def backward(ctx, g):
        s = ctx.split
        if s.group is None:
            seq_parallel._COUNTS["all_gather"] += 1
            return torch.cat([g] * s.size, dim=ctx.dim), None, None
        return seq_parallel.all_gather(g, ctx.dim, s.group, s.size), None, \
            None


class _SumOver(torch.autograd.Function):
    """The ranks' sum of ``x`` (an all-reduce) where every rank goes on
    with the same result, so each rank's gradient of its own term is the
    result's: the identity."""

    @staticmethod
    def forward(ctx, x, group):
        return seq_parallel.all_reduce(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyTo(torch.autograd.Function):
    """``x``, the same on every rank, read by each rank for its own
    part: the identity forward, the ranks' gradients summed back (an
    all-reduce)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return seq_parallel.all_reduce(g.clone(), ctx.group), None


class _LogSumExp(torch.autograd.Function):
    """Each row's log-sum-exp over every rank's vocab slice of its float32
    ``logits`` [..., V / M] (the rows' maxima all-reduced, then the sums
    of their exponentials, packed with the ranks' ``picked`` target logits
    [...] into one all-reduce): (lse, the target logits).  The backward
    is `torch.logsumexp`'s, ``g · exp(logits - lse)``, and the identity
    for the picked logits (every rank goes on with the same sums)."""

    @staticmethod
    def forward(ctx, logits, picked, group):
        top = seq_parallel.all_reduce(logits.amax(dim=-1), group,
                                      op=dist.ReduceOp.MAX)
        both = seq_parallel.all_reduce(torch.stack(
            [torch.exp(logits - top[..., None]).sum(dim=-1), picked]), group)
        lse = torch.log(both[0]) + top
        ctx.save_for_backward(logits, lse)
        return lse, both[1]

    @staticmethod
    def backward(ctx, g_lse, g_picked):
        logits, lse = ctx.saved_tensors
        return g_lse[..., None] * (logits - lse[..., None]).exp(), g_picked, \
            None


def _vocab_split(g: ParamGather, axis: str):
    """The thread's sequence split where it is over ``axis`` (the rows
    then cross the ranks), None where the sequence is whole on them; a
    split over another axis raises."""
    s = seq_parallel.current()
    if axis in g.sums:
        return s
    if s is not None:
        raise NotImplementedError(f"a vocab split over {axis!r} beside a "
                                  "sequence split over another axis is not "
                                  "ported")
    return None


def embedding(table: torch.Tensor, tokens: torch.Tensor,
              lead: int = 0) -> torch.Tensor:
    """``F.embedding(tokens, table)`` [B, S_local, D]; under a binding
    whose ``table`` [V, D] is vocab-sharded, from the rank's rows alone
    (the module docstring).  ``lead`` positions of the rank's block come
    before its tokens (a patch-input model's patches): the tokens are
    gathered padded to the block's length, so every rank gathers alike,
    and the result is the block's last S_local - ``lead`` rows."""
    g = current()
    if g is None:
        return torch.nn.functional.embedding(tokens.long(), table)
    axis = g.vocab_axis(table, 0)
    if axis is None:
        return torch.nn.functional.embedding(tokens.long(), g.gather(table))
    local = g.gather(table, keep=axis)                  # [V / M, D]
    v = local.shape[0]
    lo = g.mesh.ranks[axis] * v
    s = _vocab_split(g, axis)
    ids = tokens.long()
    if s is not None:
        ids = torch.cat([ids.new_full((ids.shape[0], lead), -1), ids], 1)
        ids = seq_parallel.all_gather(ids, 1, s.group, s.size)
    ids = ids - lo
    own = (ids >= 0) & (ids < v)
    e = torch.nn.functional.embedding(ids.clamp(0, v - 1), local)
    e = torch.where(own[..., None], e, e.new_zeros(()))
    if s is None:
        return _SumOver.apply(e, g.mesh.groups[axis])
    return _ReduceScatter.apply(e, s, 1)[:, lead:]


def vocab_nll(h: torch.Tensor, head: torch.Tensor, targets: torch.Tensor,
              count=None, ignore: int = -100) -> torch.Tensor:
    """`layers.next_token_loss` of the logits ``h @ head`` against
    ``targets`` [B, S_local] (``ignore`` left out; the sum over ``count``
    targets, or over the valid ones), with ``head`` [D, V]
    vocab-sharded under the thread's binding: the rank's rows ``h``
    [B, S_local, D] (already normed) are gathered over the sequence's
    ranks, and the loss returned is the whole sequence's on every rank
    (the module docstring)."""
    g = current()
    axis = g.vocab_axis(head, 1)
    group = g.mesh.groups[axis]
    w = g.gather(head, keep=axis)                       # [D, V / M]
    v = w.shape[1]
    lo = g.mesh.ranks[axis] * v
    s = _vocab_split(g, axis)
    if s is None:
        h = _CopyTo.apply(h, group)
    else:
        h = seq_parallel._Gather.apply(h, s, 1)
        targets = seq_parallel.all_gather(targets.long(), 1, s.group,
                                          s.size)
    logits = (h @ w).float()
    targets = targets.long()
    valid = targets != ignore
    t = targets - lo
    own = valid & (t >= 0) & (t < v)
    picked = torch.where(own, logits.gather(
        -1, t.clamp(0, v - 1)[..., None])[..., 0], 0.0)
    lse, picked = _LogSumExp.apply(logits, picked, group)
    nll = torch.where(valid, lse - picked, 0.0)
    denom = (valid.sum() if count is None else count).clamp(min=1)
    return nll.sum() / denom
