"""Mixture-of-Experts FFN with capacity-bounded, sort-based dispatch (the
reference's `repro.models.moe`).

Tokens are bucketed per expert within each row (a stable argsort of the
expert ids), and every expert runs over its ``[B, E, C, D]`` bucket as one
batched product: ``torch.matmul`` over the experts, as the reference's
einsums are plain products XLA computes outside any Pallas kernel.  Each
expert has C = ceil(S·k / E · capacity_factor) slots; a (token, slot) past
its expert's capacity goes to the overflow row E·C, which is cut off, so a
dropped token passes through the residual stream alone (GShard
semantics).  Every expert's bucket is computed, empty ones included, as in
the reference's layout.

Two dispatch modes, as in the reference:
  * ``sort`` (default): gather-based;
  * ``onehot``: GShard one-hot dispatch and combine products.

Under a sequence split (`distributed/seq_parallel.py`) x is this rank's
block of each row, and the dispatch is the reference's over the whole
row: C = ceil(S·k / E · cf) slots an expert from the whole sequence,
each (token, slot) kept while its rank within its expert, in the row's
order, is below C.  Where the step's parameter binding keeps the
experts sharded over the split's axis (`param_gather.expert_axis`: the
training rules shard the expert dim over ``model``, E divisible by its
ranks), a rank holds E / M experts and the row's tokens come to them,
as in the reference's sharded program: the rank gathers the row (one
all-gather), routes it whole, keeps the pairs of its own experts in a
[B, E / M, C, D] bucket (exactly the reference's bucket cut to those
experts), and reduce-scatters the gated outputs, zero where a pair's
expert lives elsewhere, back to the blocks (one reduce-scatter); its
experts' weights are gathered over the other axes only, and their
gradient is neither summed nor scattered over the split (the owner's
bucket holds every rank's pairs).  ``onehot`` takes the same layout with
the reference's cumulative-sum positions over the gathered row.  The
dry run's emulated split (no process group, whole leaves) takes it
where E divides over the split, cutting each leaf to the rank's
experts.  Elsewhere (one card, no binding, E not divisible by M) each
rank routes its own block and runs every expert on its own kept pairs:
each pair ranked after the pairs the earlier ranks routed there
(`seq_parallel.count_prefix`, one all-gather a call), a bucket of
min(C, S_local) slots an expert (a token picks an expert at most once,
and a kept pair's local rank is below C), the experts' weights whole
and their gradients summed over the ranks by the step; ``onehot``
raises there.

Plain PyTorch on both devices: the reference has no kernel here.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.distributed import param_gather, seq_parallel
from repro_torch.models.layers import normal_init


def moe_init(cfg, dtype, *, generator: torch.Generator) -> dict:
    d = cfg.d_model
    e_ff = cfg.moe_d_ff or cfg.d_ff
    e = cfg.n_experts
    p = {
        "router": normal_init((d, e), d, dtype, generator=generator),
        "wg": normal_init((e, d, e_ff), d, dtype, generator=generator),
        "wu": normal_init((e, d, e_ff), d, dtype, generator=generator),
        "wd": normal_init((e, e_ff, d), e_ff, dtype, generator=generator,
                          scale=1.0 / max(2 * cfg.n_layers, 1) ** 0.5),
    }
    if cfg.n_shared_experts:
        sf = cfg.n_shared_experts * e_ff
        p["shared"] = {
            "wg": normal_init((d, sf), d, dtype, generator=generator),
            "wu": normal_init((d, sf), d, dtype, generator=generator),
            "wd": normal_init((sf, d), sf, dtype, generator=generator),
        }
    return p


def moe_axes(cfg):
    ax = {
        "router": "embed expert",
        "wg": "expert embed ff",
        "wu": "expert embed ff",
        "wd": "expert ff embed",
    }
    if cfg.n_shared_experts:
        ax["shared"] = {"wg": "embed ff", "wu": "embed ff", "wd": "ff embed"}
    return ax


def _capacity(s: int, k: int, e: int, cf: float) -> int:
    return max(1, int(math.ceil(s * k / e * cf)))


def _route(p, x, cfg):
    """Router: top-k normalized gates.  x: [B, S, D] -> (gates float32,
    idx int64) [B, S, k].  The logits are computed in x's dtype and only
    then cast to float32, as the reference does.  Ties break to the lower
    expert index, as ``jax.lax.top_k`` breaks them: a stable descending
    sort, first k (``torch.topk`` promises no order among ties)."""
    logits = torch.einsum("bsd,de->bse", x, p["router"]).float()
    probs = torch.softmax(logits, dim=-1)
    idx = torch.argsort(probs, dim=-1, descending=True,
                        stable=True)[..., :cfg.top_k]
    gates = torch.gather(probs, -1, idx)
    gates = gates / gates.sum(-1, keepdim=True).clamp(min=1e-9)
    return gates, idx


def _expert_ffn(p, xe):
    """xe: [B, E, C, D] -> [B, E, C, D]: each expert's SwiGLU over its
    bucket, one batched product per weight."""
    h = F.silu(torch.matmul(xe, p["wg"]))
    h = h * torch.matmul(xe, p["wu"])
    return torch.matmul(h, p["wd"])


def _shared_ffn(p, x):
    """The shared experts' SwiGLU on x, or None without them."""
    if "shared" not in p:
        return None
    sp = p["shared"]
    h = F.silu(x @ sp["wg"]) * (x @ sp["wu"])
    return h @ sp["wd"]


def _shared(p, x, out):
    y = _shared_ffn(p, x)
    return out if y is None else out + y


def _owned_out(p, x, split, part_of_row):
    """The block's output under the expert layout: the shared experts on
    the block first, then ``part_of_row(the gathered rows)``, the rank's
    partial output [B, S, D], reduce-scattered to the block.  In that
    order a checkpointed layer's re-run stops before the reduce-scatter
    (non-reentrant checkpointing stops at the last saved tensor), so the
    reduce-scatter runs once a step in the forward."""
    y = _shared_ffn(p, x)
    out = _to_block(part_of_row(_to_row(x, split)), split)
    return out if y is None else out + y


def _owned(p, cfg, split):
    """Under the expert layout (the module docstring): ({wg, wu, wd} of
    the rank's E / M experts, its first expert); None elsewhere."""
    g = param_gather.current()
    if g is not None:
        axis = g.expert_axis(p["wg"]) if g.bound(p["wg"]) else None
        if axis is None:
            return None
        w = {n: g.gather(p[n], keep=axis)
             for n in param_gather.EXPERT_LEAVES}
        return w, g.mesh.ranks[axis] * w["wg"].shape[0]
    if split is None or split.group is not None \
            or cfg.n_experts % split.size:
        return None
    per = cfg.n_experts // split.size      # the dry run's emulated rank
    lo = split.rank * per
    return {n: p[n][lo:lo + per] for n in param_gather.EXPERT_LEAVES}, lo


def _to_row(x, split):
    """A rank's block [B, S_local, D] -> the whole rows [B, S, D] (one
    all-gather; a reduce-scatter of the gradient)."""
    return seq_parallel._Gather.apply(x, split, 1)


def _to_block(part, split):
    """The ranks' partial outputs [B, S, D] summed, this rank's block (one
    reduce-scatter; an all-gather of the gradient)."""
    return param_gather._ReduceScatter.apply(part, split, 1)


def _sort_dispatch(w, x, gates, idx, e, c, cb, lo=0, before=None):
    """The gated outputs [B, S, D] of the experts ``w`` holds (lo .. lo +
    n, n = w["wg"].shape[0], of ``e``) on the pairs that reach them: each
    (token, slot) of ``idx`` ranked within its expert in the row's order
    (after ``before(counts)`` [B, E] pairs of the earlier ranks) and kept
    while below ``c``, at its rank in an expert bucket of ``cb`` slots;
    the other pairs go to the overflow row, which is cut off, and add 0."""
    b, s, d = x.shape
    k = idx.shape[-1]
    n = w["wg"].shape[0]
    dev = x.device
    flat_idx = idx.reshape(b, s * k)       # expert of each (token, slot)
    flat_gate = gates.reshape(b, s * k)

    # rank of each (token, slot) within its expert, per row
    order = torch.argsort(flat_idx, dim=-1, stable=True)    # [B, S*k]
    sorted_e = torch.gather(flat_idx, -1, order)
    counts = torch.zeros((b, e), dtype=torch.int64, device=dev) \
        .scatter_add_(1, flat_idx, torch.ones_like(flat_idx))
    starts = torch.cumsum(counts, dim=-1) - counts          # exclusive
    rank = torch.arange(s * k, device=dev)[None, :] \
        - torch.gather(starts, -1, sorted_e)
    held = rank            # the row-global rank: after the earlier ranks'
    if before is not None:
        held = rank + torch.gather(before(counts), -1, sorted_e)
    local = sorted_e - lo
    kept = (held < c) & (local >= 0) & (local < n)
    dest = torch.where(kept, local * cb + rank, n * cb)    # overflow

    # invert: the bucket slot of each flat (token, slot); order is a
    # permutation, so no index repeats
    dest_of_flat = torch.empty_like(dest).scatter_(1, order, dest)
    token_of_sorted = order // k
    # bucket -> source token (row n*C is the overflow row: the only index
    # written more than once, and cut off below)
    src = torch.full((b, n * cb + 1), s, dtype=torch.int64, device=dev) \
        .scatter_(1, dest, token_of_sorted)
    x_pad = torch.cat([x, x.new_zeros((b, 1, d))], dim=1)
    xe = torch.gather(x_pad, 1,
                      src[:, :n * cb, None].expand(b, n * cb, d))

    ye = _expert_ffn(w, xe.reshape(b, n, cb, d)).reshape(b, n * cb, d)
    ye = torch.cat([ye, ye.new_zeros((b, 1, d))], dim=1)
    contrib = torch.gather(ye, 1, dest_of_flat[..., None].expand(b, s * k,
                                                                 d))
    return (contrib.reshape(b, s, k, d)
            * flat_gate.reshape(b, s, k, 1).to(contrib.dtype)).sum(dim=2)


def moe_ffn_sort(p, x, cfg):
    """Gather-based dispatch, row-local capacity.  x: [B, S, D], or this
    rank's block of each row under a sequence split (the module
    docstring)."""
    e, k, cf = cfg.n_experts, cfg.top_k, cfg.capacity_factor
    split = seq_parallel.current()
    owned = _owned(p, cfg, split)
    if owned is not None:          # the row's tokens to the rank's experts
        w, lo = owned

        def part(row):
            gates, idx = _route(p, row, cfg)
            c = _capacity(row.shape[1], k, e, cf)
            return _sort_dispatch(w, row, gates, idx, e, c, c, lo)
        return _owned_out(p, x, split, part)
    s = x.shape[1]
    c = _capacity(s * (split.size if split else 1), k, e, cf)
    cb = min(c, s) if split else c         # an expert's slots in the bucket
    gates, idx = _route(p, x, cfg)                          # [B, S, k]
    before = (lambda counts: seq_parallel.count_prefix(counts, split)) \
        if split else None
    return _shared(p, x, _sort_dispatch(p, x, gates, idx, e, c, cb,
                                        before=before))


def _onehot_dispatch(w, x, gates, idx, e, c, lo=0):
    """The gated outputs [B, S, D] of the experts ``w`` holds (lo .. lo +
    n of ``e``) by GShard's one-hot dispatch and combine products: each
    pair's position in its expert by cumulative sums over the row, slot
    by slot, kept while below ``c``."""
    b, s, _ = x.shape
    n = w["wg"].shape[0]
    dispatch = x.new_zeros((b, s, n, c))
    combine = torch.zeros((b, s, n, c), dtype=torch.float32, device=x.device)
    prev = torch.zeros((b, n), dtype=torch.int64, device=x.device)
    for slot in range(idx.shape[-1]):
        oh = F.one_hot(idx[:, :, slot], e)[..., lo:lo + n]  # [B, S, n]
        pos = torch.cumsum(oh, dim=1) - 1 + prev[:, None, :]
        prev = prev + oh.sum(dim=1)
        ok = (pos < c) & (oh > 0)
        pc = F.one_hot(torch.where(ok, pos, c), c + 1).to(x.dtype)[..., :c]
        dispatch = dispatch + oh.to(x.dtype)[..., None] * pc
        combine = combine + (gates[:, :, slot][..., None, None]
                             * oh.float()[..., None] * pc.float())
    xe = torch.einsum("bsec,bsd->becd", dispatch, x)
    ye = _expert_ffn(w, xe)
    return torch.einsum("bsec,becd->bsd", combine.to(x.dtype), ye)


def moe_ffn_onehot(p, x, cfg):
    """GShard one-hot dispatch (the reference's comparison path, which no
    launcher calls).  Under a sequence split it runs only where the
    experts are sharded over the split (the module docstring); elsewhere
    it raises, since a block would get a capacity and positions of its
    own."""
    e, k, cf = cfg.n_experts, cfg.top_k, cfg.capacity_factor
    split = seq_parallel.current()
    owned = _owned(p, cfg, split)
    if owned is not None:
        w, lo = owned

        def part(row):
            gates, idx = _route(p, row, cfg)
            return _onehot_dispatch(w, row, gates, idx, e,
                                    _capacity(row.shape[1], k, e, cf), lo)
        return _owned_out(p, x, split, part)
    if split:
        raise NotImplementedError(
            "the one-hot MoE dispatch on a sequence split runs only where "
            "the step's binding shards the experts over the split's axis; "
            "with whole experts on every rank (no binding, or E not "
            "divisible by the split's ranks) it is not ported: the sort "
            "dispatch ranks each block's pairs row-globally there")
    gates, idx = _route(p, x, cfg)
    out = _onehot_dispatch(p, x, gates, idx, e,
                           _capacity(x.shape[1], k, e, cf))
    return _shared(p, x, out)


def moe_ffn(p, x, cfg, mode: str = "sort"):
    return moe_ffn_sort(p, x, cfg) if mode == "sort" else \
        moe_ffn_onehot(p, x, cfg)
