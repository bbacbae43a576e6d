"""Plain PyTorch versions of the port's kernels (the CPU path and the oracles).

Each function computes exactly what its hand-written CUDA kernel computes,
with plain tensor ops in the reference's op order, so the two agree bit for
bit: the tests hold these against the JAX package's oracles
(`repro.kernels.ref`) on the CPU, and `chip_smoke.py` holds each kernel
against them on the card.  `kernels/ops.py` uses them for CPU tensors only.
"""
from __future__ import annotations

import torch


# ---------------- LCP ----------------

def lcp_ref(prompts: torch.Tensor, ledgers: torch.Tensor) -> torch.Tensor:
    """prompts: [N, L] int32; ledgers: [N, M, L] int32 -> [N, M] int32.

    The length of the common prefix of each prompt with each of its M
    ledger rows: the index of the first mismatching token, or L.
    """
    n, length = prompts.shape
    m = ledgers.shape[1]
    if length == 0:
        return torch.zeros((n, m), dtype=torch.int32, device=prompts.device)
    neq = prompts[:, None, :] != ledgers
    first = neq.to(torch.uint8).argmax(dim=-1)      # first True (0 if none)
    return torch.where(neq.any(dim=-1), first,
                       torch.full_like(first, length)).to(torch.int32)


# ---------------- auction bidding round ----------------

def auction_bid_ref(W, ask, ask2, active, eps):
    """One Jacobi forward-bidding round of the capacitated column market.

    W: [n, m] float32 agent-level weights; ask/ask2: [m] cheapest and
    second-cheapest unit price per agent (+big where the agent has fewer
    units); active: [n] bool; eps: a float32 scalar.  Returns (best [m],
    winner [m] int32, wants [n] bool): the segment-max bid per agent (-big
    where none), the winning request per agent (ties to the lowest index, n
    where no bid), and which active requests bid at all (top profit > 0).

    The runner-up value v2 substitutes the favourite agent's own
    second-cheapest unit (ask2) at the k1 column.  The reference's
    ``mode="drop"`` scatters become scatters into one extra sink slot
    (index m) that is sliced off.
    """
    n, m = W.shape
    dev = W.device
    eps = float(eps)              # exact: eps is a float32 value
    big = torch.finfo(W.dtype).max / 4
    P = torch.where(active[:, None], W - ask[None, :], -big)
    v1 = P.amax(dim=1)
    k1 = P.argmax(dim=1)          # first index on ties, as jnp.argmax
    onehot = torch.arange(m, device=dev)[None, :] == k1[:, None]
    alt = torch.where(onehot & active[:, None], W - ask2[None, :], P)
    v2 = alt.amax(dim=1).clamp(min=0.0)
    wants = active & (v1 > 0.0)
    bid = ask[k1] + (v1 - v2) + eps
    sink = torch.full_like(k1, m)
    best = torch.full((m + 1,), -big, dtype=W.dtype, device=dev)
    best.scatter_reduce_(0, torch.where(wants, k1, sink), bid, "amax",
                         include_self=True)
    best = best[:m]
    at_best = wants & (bid == best[k1.clamp(max=m - 1)])
    winner = torch.full((m + 1,), n, dtype=torch.int32, device=dev)
    winner.scatter_reduce_(0, torch.where(at_best, k1, sink),
                           torch.arange(n, dtype=torch.int32, device=dev),
                           "amin", include_self=True)
    return best, winner[:m], wants
