"""``solver="cuda"``: the staged dense auction with the CUDA bidding kernel.

The staged solver of `dense_torch`, whose forward bidding round goes
through `repro_torch.kernels.ops.auction_bid_op`: the hand-written kernel
(`kernels/csrc/auction_bid.cu`) for a CUDA device, the plain PyTorch round
for the CPU (which is how the CPU tests hold this backend against the
reference).  ``dense-torch`` is the same solver restricted to the CPU.  The
market is solved unpadded, so round counts and the warm budget match the
reference's ``dense-jax``.
"""
from __future__ import annotations

from repro_torch.core.solvers.base import (AuctionResult,
                                           sequential_solve_batch)
from repro_torch.core.solvers.dense_common import package_dense
from repro_torch.core.solvers.dense_torch import solve_dense_auction_torch

__all__ = ["solve_dense_auction_cuda", "CudaBackend"]


def solve_dense_auction_cuda(w, caps, *, max_rounds: int = 200_000,
                             start_prices=None, device="cuda"):
    """Kernel-round dense auction solve on ``device``; returns a
    DenseAuctionResult."""
    return solve_dense_auction_torch(
        w, caps, max_rounds=max_rounds, start_prices=start_prices,
        solver_name="cuda", device=device)


class CudaBackend:
    """``solver="cuda"``: staged auction with the CUDA bidding kernel."""

    name = "cuda"
    supports_warm_start = True
    supports_batch = False

    def solve(self, w, costs, caps, *, payment_mode: str = "warmstart",
              start_prices=None, device="cuda") -> AuctionResult:
        """One market through the kernelized staged solver."""
        res = solve_dense_auction_cuda(w, caps, start_prices=start_prices,
                                       device=device)
        return package_dense(self.name, w, costs, caps, res)

    def solve_batch(self, ws, costs_list, caps_list, *,
                    payment_mode: str = "warmstart", start_prices_list=None,
                    device="cuda") -> list[AuctionResult]:
        """One ``solve`` per market (hub-batched solves come later)."""
        return sequential_solve_batch(self, ws, costs_list, caps_list,
                                      payment_mode=payment_mode,
                                      start_prices_list=start_prices_list,
                                      device=device)

    def certificate(self, result: AuctionResult) -> float:
        """2·n·ε_final at the float32 resolution-bounded ε schedule."""
        return float(result.solver_stats["gap_bound"])
