"""One Jacobi forward-bidding round of the capacitated column auction.

The Phase-2 ε-scaling auction (`repro_torch.core.solvers`) runs this round
once per forward-bidding iteration.  For an (n × m) agent-level weight
matrix and the two cheapest unit prices per agent (``ask``, ``ask2``):

    P[j, i]  = W[j, i] - ask[i]               (only active rows compete)
    v1, k1   = top profit and its agent       (per request, lowest index)
    v2       = runner-up profit with the favourite agent's own ask2
               substituted at k1, floored at the outside option 0
    bid[j]   = ask[k1] + (v1 - v2) + ε        (only if v1 > 0, else park)
    best[i]  = max over bidders with k1 = i of bid[j]   (segment max)
    winner[i]= min j among bidders at best[i]           (deterministic ties)

On the card this is the hand-written kernel in ``csrc/auction_bid.cu`` (one
warp per request row, the segment max as a 64-bit atomicMax on an ordered
key); ``auction_bid_plain`` is the same round in plain PyTorch
(`kernels/ref.py`), used for CPU tensors and as the kernel's oracle.  The
two are bit-identical.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import auction_bid_ref as auction_bid_plain

__all__ = ["auction_bid_cuda", "auction_bid_plain"]

_P = ctypes.c_void_p


def _lib() -> ctypes.CDLL:
    lib = build.load("auction_bid")
    fn = lib.auction_bid_launch
    fn.argtypes = [_P, _P, _P, _P, ctypes.c_float, _P, _P, _P, _P,
                   ctypes.c_int, ctypes.c_int, _P]
    fn.restype = ctypes.c_int
    return lib


def auction_bid_cuda(W: torch.Tensor, ask: torch.Tensor, ask2: torch.Tensor,
                     active: torch.Tensor, eps):
    """W [n, m] float32, ask/ask2 [m] float32, active [n] bool (contiguous
    CUDA tensors on one device), eps a float32 scalar -> (best [m] float32,
    winner [m] int32, wants [n] bool), launched on the current stream.
    Raises on any other input and on a failed launch."""
    dev = W.device
    if dev.type != "cuda" or any(t.device != dev for t in (ask, ask2, active)):
        raise ValueError("auction_bid_cuda takes CUDA tensors on one device")
    if W.dtype != torch.float32 or ask.dtype != torch.float32 \
            or ask2.dtype != torch.float32 or active.dtype != torch.bool:
        raise TypeError("auction_bid_cuda takes float32 W/ask/ask2 and a "
                        "bool active mask")
    if W.dim() != 2 or W.shape[1] == 0:
        raise ValueError(f"W must be [n, m] with m > 0, got {tuple(W.shape)}")
    n, m = W.shape
    if ask.shape != (m,) or ask2.shape != (m,) or active.shape != (n,):
        raise ValueError("ask/ask2 must be [m] and active [n]")
    if not all(t.is_contiguous() for t in (W, ask, ask2, active)):
        raise ValueError("auction_bid_cuda takes contiguous tensors")
    eps32 = np.float32(eps)
    if eps32 != eps:
        raise ValueError(f"eps {eps!r} is not a float32 value")
    best = torch.empty((m,), dtype=torch.float32, device=dev)
    winner = torch.empty((m,), dtype=torch.int32, device=dev)
    wants = torch.empty((n,), dtype=torch.bool, device=dev)
    keys = torch.empty((m,), dtype=torch.int64, device=dev)   # scratch
    err = _lib().auction_bid_launch(
        W.data_ptr(), ask.data_ptr(), ask2.data_ptr(), active.data_ptr(),
        float(eps32), best.data_ptr(), winner.data_ptr(), wants.data_ptr(),
        keys.data_ptr(), n, m, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"auction_bid kernel launch failed: CUDA error "
                           f"{err}")
    return best, winner, wants
