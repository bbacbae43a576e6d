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

Plain PyTorch on both devices: the reference has no kernel here.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

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


def _shared(p, x, out):
    if "shared" not in p:
        return out
    sp = p["shared"]
    h = F.silu(x @ sp["wg"]) * (x @ sp["wu"])
    return out + h @ sp["wd"]


def moe_ffn_sort(p, x, cfg):
    """Gather-based dispatch, row-local capacity.  x: [B, S, D]."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    c = _capacity(s, k, e, cfg.capacity_factor)
    dev = x.device
    gates, idx = _route(p, x, cfg)                          # [B, S, k]

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
    dest = torch.where(rank < c, sorted_e * c + rank, e * c)  # overflow

    # invert: the bucket slot of each flat (token, slot); order is a
    # permutation, so no index repeats
    dest_of_flat = torch.empty_like(dest).scatter_(1, order, dest)
    token_of_sorted = order // k
    # bucket -> source token (row E*C is the overflow row: the only index
    # written more than once, and cut off below)
    src = torch.full((b, e * c + 1), s, dtype=torch.int64, device=dev) \
        .scatter_(1, dest, token_of_sorted)
    x_pad = torch.cat([x, x.new_zeros((b, 1, d))], dim=1)
    xe = torch.gather(x_pad, 1, src[:, :e * c, None].expand(b, e * c, d))

    ye = _expert_ffn(p, xe.reshape(b, e, c, d)).reshape(b, e * c, d)
    ye = torch.cat([ye, ye.new_zeros((b, 1, d))], dim=1)
    contrib = torch.gather(ye, 1, dest_of_flat[..., None].expand(b, s * k,
                                                                 d))
    out = (contrib.reshape(b, s, k, d)
           * flat_gate.reshape(b, s, k, 1).to(contrib.dtype)).sum(dim=2)
    return _shared(p, x, out)


def moe_ffn_onehot(p, x, cfg):
    """GShard one-hot dispatch (the reference's comparison path)."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    c = _capacity(s, k, e, cfg.capacity_factor)
    gates, idx = _route(p, x, cfg)

    # position in the expert by cumulative sums over the sequence, per slot
    dispatch = x.new_zeros((b, s, e, c))
    combine = torch.zeros((b, s, e, c), dtype=torch.float32, device=x.device)
    prev = torch.zeros((b, e), dtype=torch.int64, device=x.device)
    for slot in range(k):
        oh = F.one_hot(idx[:, :, slot], e)                  # [B, S, E]
        pos = torch.cumsum(oh, dim=1) - 1 + prev[:, None, :]
        prev = prev + oh.sum(dim=1)
        ok = (pos < c) & (oh > 0)
        pc = F.one_hot(torch.where(ok, pos, c), c + 1).to(x.dtype)[..., :c]
        dispatch = dispatch + oh.to(x.dtype)[..., None] * pc
        combine = combine + (gates[:, :, slot][..., None, None]
                             * oh.float()[..., None] * pc.float())
    xe = torch.einsum("bsec,bsd->becd", dispatch, x)
    ye = _expert_ffn(p, xe)
    out = torch.einsum("bsec,becd->bsd", combine.to(x.dtype), ye)
    return _shared(p, x, out)


def moe_ffn(p, x, cfg, mode: str = "sort"):
    return moe_ffn_sort(p, x, cfg) if mode == "sort" else \
        moe_ffn_onehot(p, x, cfg)
