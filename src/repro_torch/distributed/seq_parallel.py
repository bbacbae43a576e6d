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
block's global positions, gathers K and V over the axis (`gather_kv`, one
all-gather a call) and runs the flash kernels on its own query rows at
``q_offset = rank · S_local``.  The gather's backward sums each rank's dK /
dV of every block and hands each rank its own block's sum: a
reduce-scatter.

The collectives here are ``torch.distributed``'s list forms, which run on
any process group: NCCL, one card a rank, or gloo (on the CPU, and for
ranks that share a card, on CUDA tensors, which gloo copies through the
host).  The training step gathers and reduces its parameters and
gradients with them too, not with DTensor's redistribution: on gloo with
CUDA tensors DTensor's functional collectives crash the process (torch
2.11 on an H100 machine), while these run.  `collective_counts` counts the
calls by kind.

A `SeqSplit` without a group emulates the collectives in one process, as
if every rank held this rank's tensors (an all-gather repeats the block,
a reduce-scatter scales this rank's slice by the axis's size): the dry
run traces one rank's step that way, with fake tensors.

``shard`` (`distributed.sharding`) stays a no-op: the step hands the model
each rank's block, and only the attention needs the whole sequence.
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
    """``fn`` run under the split active now, on whatever thread calls it:
    a checkpointed layer's re-run in the backward runs on the autograd
    engine's thread (a device thread, for CUDA tensors), where the
    thread's split is not set."""
    s = current()

    def run(*args):
        with split(s):
            return fn(*args)
    return run


def all_gather(x: torch.Tensor, dim: int, group, size: int) -> torch.Tensor:
    """The ``size`` ranks' ``x`` concatenated along ``dim`` in rank order
    (``group`` None: the default group, as in ``torch.distributed``)."""
    _COUNTS["all_gather"] += 1
    parts = [torch.empty_like(x) for _ in range(size)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim)


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of the ranks' ``x`` (in place where ``x`` is contiguous)."""
    _COUNTS["all_reduce"] += 1
    x = x.contiguous()
    dist.all_reduce(x, group=group)
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


class _GatherSeq(torch.autograd.Function):
    """All-gather along the sequence (dim 1) on the way forward; the sum
    of the ranks' gradients, this rank's block of it, on the way back.
    An emulated split (no group) counts the same collectives and acts as
    if every rank held this rank's tensors."""

    @staticmethod
    def forward(ctx, x, s):
        ctx.split = s
        if s.group is None:
            _COUNTS["all_gather"] += 1
            return torch.cat([x] * s.size, dim=1)
        return all_gather(x, 1, s.group, s.size)

    @staticmethod
    def backward(ctx, g):
        s = ctx.split
        if s.group is None:
            _COUNTS["reduce_scatter"] += 1
            return g.chunk(s.size, 1)[s.rank] * s.size, None
        return reduce_scatter(g, 1, s.group, s.size, s.rank), None


def gather_kv(k: torch.Tensor, v: torch.Tensor, s: SeqSplit):
    """This rank's k and v [B, S_local, Hkv, d] -> the whole sequence's
    [B, S, Hkv, d] each, in one all-gather (and one reduce-scatter of
    dK / dV in the backward)."""
    d = k.shape[-1]
    kv = _GatherSeq.apply(torch.cat([k, v], dim=-1), s)
    return kv[..., :d], kv[..., d:]


def collective_counts() -> dict[str, int]:
    """Calls of each collective since the last reset, by kind."""
    return dict(_COUNTS)


def reset_collective_counts() -> None:
    """Set every collective's count to 0."""
    for k in _COUNTS:
        _COUNTS[k] = 0


# ---------------- the slice of the port that splits sequences ----------------

def unsupported(cfg) -> str | None:
    """Why a model of ``cfg`` cannot train with its sequences split over a
    ``model`` axis above 1 (the ROADMAP item that will let it), or None
    for the dense GQA decoders."""
    item = None
    if cfg.ssm_kind:
        item = ("its recurrent scan state would pass from rank to rank",
                "Recurrent state passing")
    elif cfg.is_encdec:
        item = ("its encoder's frames are not split", "Frames")
    elif cfg.n_patches:
        item = ("its patch prefix is not split", "Patches")
    elif cfg.is_moe:
        item = ("its experts would go over `model`", "Expert over model")
    elif cfg.attn_kind == "mla":
        item = ("its MLA attention takes no query offset", "MLA")
    if item is None:
        return None
    return (f"{cfg.name}: a mesh whose model axis is above 1 splits each "
            f"sequence over it, and {item[0]}; not ported yet (ROADMAP.md, "
            f"queue 1, '{item[1]}')")
