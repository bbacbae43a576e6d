"""Dispatch on the tensor's device: the CUDA kernel, or its plain version.

A CUDA tensor goes to the hand-written kernel; a CPU tensor goes to the
plain PyTorch version; any other device raises.  There is no fallback: a
kernel that fails to build or launch raises instead of quietly running the
plain version.  Each op counts its kernel launches in a plain integer
(`launch_counts`), so a run can show that its main path went through the
kernels.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.auction_bid import auction_bid_cuda, auction_bid_plain
from repro_torch.kernels.lcp_affinity import (lcp_affinity_cuda,
                                              lcp_affinity_plain)

__all__ = ["auction_bid_op", "lcp_affinity_op", "launch_counts",
           "reset_launch_counts"]


_LAUNCHES = {"auction_bid": 0, "lcp_affinity": 0}


def _route(t: torch.Tensor) -> str:
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no kernel or plain version for device {t.device}")
    return t.device.type


def auction_bid_op(W, ask, ask2, active, eps):
    """One forward-bidding round of the column market: W [n, m], ask/ask2
    [m], active [n], eps -> (best [m], winner [m], wants [n]); see
    `kernels/auction_bid.py`."""
    if _route(W) == "cuda":
        out = auction_bid_cuda(W, ask, ask2, active, eps)
        _LAUNCHES["auction_bid"] += 1
        return out
    return auction_bid_plain(W, ask, ask2, active, eps)


def lcp_affinity_op(prompts, ledgers):
    """prompts [N, L], ledgers [N, M, L] -> lcp [N, M]; see
    `kernels/lcp_affinity.py`."""
    if _route(prompts) == "cuda":
        out = lcp_affinity_cuda(prompts, ledgers)
        _LAUNCHES["lcp_affinity"] += 1
        return out
    return lcp_affinity_plain(prompts, ledgers)


def launch_counts() -> dict[str, int]:
    """Kernel launches per op since the last reset."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    """Set every op's launch count to 0."""
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0
