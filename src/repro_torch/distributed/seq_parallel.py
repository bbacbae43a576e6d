"""Sequence parallelism over the mesh's ``model`` axis: the port's
counterpart of what XLA's SPMD partitioner does for the reference when
``TRAIN_RULES`` put the residual stream's ``seq`` over ``model``.

The reference's dense attention keeps q sharded by sequence and gathers
only the grouped K/V (`repro.models.attention.attend_parallel`, below
``CHUNK_Q_THRESHOLD``).  Here a training step that splits each sequence
over the ``model`` ranks (`repro_torch.training.loop`) sets a `SeqSplit`
for the thread (`split`): the axis's process group, this rank's coordinate
and its tokens per sequence, S_local.  Every token-wise layer then runs on
the rank's block as it stands; the GQA attention rotates its q and k at the
block's global positions, gathers K and V over the axis (`gather_seq`,
one all-gather a call) and runs the flash kernels on its own query rows at
``q_offset = rank · S_local``.  The gather's backward sums each rank's dK /
dV of every block and hands each rank its own block's sum: a
reduce-scatter.

The collectives here are ``torch.distributed``'s list forms, which run on
any process group: NCCL, one card a rank, or gloo (on the CPU, and for
ranks that share a card, on CUDA tensors, which gloo copies through the
host).  The training step's layers gather their parameters and reduce
their gradients with them too (`distributed.param_gather`), not with
DTensor's redistribution: on gloo with
CUDA tensors DTensor's functional collectives crash the process (torch
2.11 on an H100 machine), while these run.  `collective_counts` counts the
calls by kind.

A `SeqSplit` without a group emulates the collectives in one process, as
if every rank held this rank's tensors (an all-gather repeats the block,
a reduce-scatter scales this rank's slice by the axis's size): the dry
run traces one rank's step that way, with fake tensors.

The recurrent layers (RWKV-6, Mamba-2) carry two things along a
sequence, and each crosses from rank to rank in one all-gather.  A token
shift or the causal conv reads the previous rank's last rows
(`shift_in`).  A scan (WKV6, SSD) runs twice on the rank's block
(`models.ssm`): once from zeros, for the block's final state L and its
decay D, then from the state that reaches the block, which every rank
folds from the gathered (L, D) of the ranks before it (`state_in`,
`fold_states`).  Each gather's backward is a reduce-scatter.

The MoE layers route each token on its own rank, but the reference's
dispatch is row-global: C = ceil(S·k / E · cf) slots an expert over the
whole sequence, each (token, slot) ranked within its expert in the
row's order and kept while that rank is below C.  Each MoE call gathers
every rank's pair counts per (row, expert) in one all-gather
(`count_prefix`, no gradient) and ranks its pairs from the sum of the
ranks before it.  MLA gathers its compressed latent (`gather_seq`: the
normed ckv and the rotated rope key, 576 values a token) and expands
K/V for every key on every rank.

A patch-input model (llava-next-34b) splits the sequence the reference
splits: its patch embeddings ahead of its tokens, so a rank's block may
hold patches only, tokens only or both (`training.loop.split_rows`),
and its positions count the patches.  The encoder-decoder splits its
encoder's frames beside its decoder's tokens: the encoder runs under a
`SeqSplit` of its own (the same ranks, S_local its block of frames,
`models.encdec.encode`), each encoder layer gathers its K/V, and each
decoder layer projects the cross K/V of its rank's frames and gathers
them (`gather_seq`), so every rank's rows attend to every frame.

``shard`` (`distributed.sharding`) stays a no-op: the step hands the model
each rank's block, and only the attention, those two carries, the MoE's
counts and the cross K/V cross it, besides the parameters each layer
gathers and the vocab-sharded embedding and loss
(`distributed.param_gather`).
"""
from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass
from typing import Any

import torch
import torch.distributed as dist

_COUNTS = {"all_gather": 0, "reduce_scatter": 0, "all_reduce": 0}


@dataclass(frozen=True)
class SeqSplit:
    """One rank's share of a sequence split: ``group`` the axis's process
    group (None: the collectives emulated in one process), ``rank`` this
    rank's coordinate on it, ``size`` its ranks and ``s_local`` this
    rank's tokens of each sequence."""
    group: Any
    rank: int
    size: int
    s_local: int

    @property
    def offset(self) -> int:
        """The global position of this rank's first token."""
        return self.rank * self.s_local


_state = threading.local()


def current() -> SeqSplit | None:
    """The thread's active split (None outside `split`)."""
    return getattr(_state, "split", None)


@contextlib.contextmanager
def split(s: SeqSplit | None):
    """Make ``s`` the thread's active split for the block."""
    prev = current()
    _state.split = s
    try:
        yield s
    finally:
        _state.split = prev


def bound(fn):
    """``fn`` run under the split and the parameter binding
    (`param_gather.bind`) active now, on whatever thread calls it: a
    checkpointed layer's re-run in the backward runs on the autograd
    engine's thread (a device thread, for CUDA tensors), where neither is
    set."""
    from repro_torch.distributed import param_gather

    s, g = current(), param_gather.current()

    def run(*args):
        with split(s), param_gather.bind(g):
            return fn(*args)
    return run


def all_gather(x: torch.Tensor, dim: int, group, size: int) -> torch.Tensor:
    """The ``size`` ranks' ``x`` concatenated along ``dim`` in rank order
    (``group`` None: the default group, as in ``torch.distributed``)."""
    _COUNTS["all_gather"] += 1
    parts = [torch.empty_like(x) for _ in range(size)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim)


def all_reduce(x: torch.Tensor, group,
               op=dist.ReduceOp.SUM) -> torch.Tensor:
    """The sum (or ``op``) of the ranks' ``x`` (in place where ``x`` is
    contiguous)."""
    _COUNTS["all_reduce"] += 1
    x = x.contiguous()
    dist.all_reduce(x, op=op, group=group)
    return x


def reduce_scatter(x: torch.Tensor, dim: int, group, size: int,
                   rank: int) -> torch.Tensor:
    """Slice ``rank`` (of ``size`` along ``dim``) of the ranks' sum of
    ``x``."""
    _COUNTS["reduce_scatter"] += 1
    parts = [c.contiguous() for c in x.chunk(size, dim)]
    out = torch.empty_like(parts[rank])
    dist.reduce_scatter(out, parts, group=group)
    return out


class _Gather(torch.autograd.Function):
    """All-gather along ``dim`` on the way forward; the sum of the ranks'
    gradients, this rank's block of it, on the way back (a
    reduce-scatter).  An emulated split (no group) counts the same
    collectives and acts as if every rank held this rank's tensors."""

    @staticmethod
    def forward(ctx, x, s, dim):
        ctx.split, ctx.dim = s, dim
        if s.group is None:
            _COUNTS["all_gather"] += 1
            return torch.cat([x] * s.size, dim=dim)
        return all_gather(x, dim, s.group, s.size)

    @staticmethod
    def backward(ctx, g):
        s, dim = ctx.split, ctx.dim
        if s.group is None:
            _COUNTS["reduce_scatter"] += 1
            return g.chunk(s.size, dim)[s.rank] * s.size, None, None
        return reduce_scatter(g, dim, s.group, s.size, s.rank), None, None


def gather_seq(parts, s: SeqSplit) -> tuple[torch.Tensor, ...]:
    """This rank's tensors [B, S_local, ...] (alike but for their last
    dim: K and V, MLA's latent and rope key) -> the whole sequence's
    [B, S, ...] each, packed into one all-gather (and one reduce-scatter
    of their gradients in the backward)."""
    widths = [p.shape[-1] for p in parts]
    whole = _Gather.apply(torch.cat(list(parts), dim=-1), s, 1)
    return torch.split(whole, widths, dim=-1)


def count_prefix(counts: torch.Tensor, s: SeqSplit) -> torch.Tensor:
    """The sum of the ``counts`` [B, E] of the ranks before this one
    (zeros on rank 0, which joins the gather all the same), from one
    all-gather of every rank's; integers, no gradient.  Emulated, every
    rank holds this rank's counts: ``rank · counts``."""
    if s.group is None:
        _COUNTS["all_gather"] += 1
        return counts * s.rank
    stack = all_gather(counts[None], 0, s.group, s.size)
    return stack[:s.rank].sum(dim=0)


class _ShiftIn(torch.autograd.Function):
    """The previous rank's ``tail`` (zeros on rank 0): slot rank - 1 of
    one all-gather.  The backward puts the gradient into slot rank - 1 of
    a zero stack, and one reduce-scatter hands each rank its own tail's.
    Emulated, every rank holds this rank's tail and gradient."""

    @staticmethod
    def forward(ctx, tail, s):
        ctx.split = s
        if s.group is None:
            _COUNTS["all_gather"] += 1
            return tail.clone() if s.rank else torch.zeros_like(tail)
        stack = all_gather(tail[None], 0, s.group, s.size)
        return stack[s.rank - 1] if s.rank else torch.zeros_like(tail)

    @staticmethod
    def backward(ctx, g):
        s = ctx.split
        if s.group is None:
            _COUNTS["reduce_scatter"] += 1
            return (g.clone() if s.rank < s.size - 1
                    else torch.zeros_like(g)), None
        stack = g.new_zeros((s.size, *g.shape))
        if s.rank:
            stack[s.rank - 1] = g
        return reduce_scatter(stack, 0, s.group, s.size, s.rank)[0], None


def shift_in(tail: torch.Tensor, s: SeqSplit) -> torch.Tensor:
    """The previous rank's last rows [B, w, ...] in place of this rank's
    ``tail`` (zeros on rank 0): what a token shift or a causal conv of
    width w + 1 reads before the block's first row."""
    return _ShiftIn.apply(tail.contiguous(), s)


def _decay_as_state(d: torch.Tensor, state: torch.Tensor) -> torch.Tensor:
    """A block decay [B, H] or [B, H, p] broadcast over a state
    [B, H, p, q]."""
    return d.reshape(*d.shape, *([1] * (state.dim() - d.dim())))


class _Fold(torch.autograd.Function):
    """S_0 = 0, S_{j+1} = D_j ∘ S_j + L_j for j < rank, over stacks of
    the ranks' block-final states L [m, B, H, p, q] and decays D
    [m, B, H(, p)], in a fixed order, so every rank that folds the same
    slots gets the same bits.  The backward runs the recursion in reverse
    and gives every slot a gradient, zeros from ``rank`` on: rank 0's
    too, so each rank's gather joins the backward's reduce-scatter."""

    @staticmethod
    def forward(ctx, l_stack, d_stack, rank):
        ctx.rank = rank
        states = [torch.zeros_like(l_stack[0])]
        for j in range(rank):
            states.append(_decay_as_state(d_stack[j], states[-1])
                          * states[-1] + l_stack[j])
        ctx.save_for_backward(d_stack, *states[:-1])
        return states[-1]

    @staticmethod
    def backward(ctx, g):
        d_stack, *states = ctx.saved_tensors
        dl = g.new_zeros((d_stack.shape[0], *g.shape))
        dd = torch.zeros_like(d_stack)
        for j in reversed(range(ctx.rank)):
            dl[j] = g
            d = d_stack[j]
            dd[j] = (g * states[j]).sum(
                dim=tuple(range(d.dim(), g.dim())))
            g = _decay_as_state(d, g) * g
        return dl, dd, None


def fold_states(l_stack: torch.Tensor, d_stack: torch.Tensor,
                rank: int) -> torch.Tensor:
    """The state that reaches block ``rank`` of a sequence from the
    blocks before it (`_Fold`): l_stack [m, B, H, p, q] each block's
    final state from zero, d_stack [m, B, H] or [m, B, H, p] its decay
    over the block (the product of its tokens' decays, on the state's
    dim 2)."""
    return _Fold.apply(l_stack, d_stack, rank)


def state_in(l_final: torch.Tensor, decay: torch.Tensor,
             s: SeqSplit) -> torch.Tensor:
    """The scan state [B, H, p, q] float32 that reaches this rank's
    block: every rank's block-final state from zero ``l_final`` and
    block decay ``decay`` gathered in one all-gather, then folded
    (`fold_states`); the gradient of the stack goes back in one
    reduce-scatter."""
    n = l_final[0].numel()
    packed = torch.cat([l_final.reshape(l_final.shape[0], -1),
                        decay.float().reshape(decay.shape[0], -1)], dim=1)
    stack = _Gather.apply(packed[None], s, 0)
    l_stack = stack[:, :, :n].reshape(s.size, *l_final.shape)
    d_stack = stack[:, :, n:].reshape(s.size, *decay.shape)
    return fold_states(l_stack, d_stack, s.rank)


def collective_counts() -> dict[str, int]:
    """Calls of each collective since the last reset, by kind."""
    return dict(_COUNTS)


def reset_collective_counts() -> None:
    """Set every collective's count to 0."""
    for k in _COUNTS:
        _COUNTS[k] = 0

