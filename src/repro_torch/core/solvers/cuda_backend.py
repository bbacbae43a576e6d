"""``solver="cuda"``: the staged dense auction as one CUDA launch per solve.

The staged solver of `dense_torch`, whose whole solve goes through
`repro_torch.kernels.ops.auction_solve_op`: the hand-written kernel
(`kernels/csrc/auction_bid.cu`, one thread block per market) for a CUDA
device, the host-driven staged market with the plain bidding round for the
CPU (which is how the CPU tests hold this backend against the reference).
``solve_batch`` solves every hub block of a batch in one call, as the
reference's ``dense-jax`` batch does in one vmapped program per shape
bucket, with the same round caps and the same float64 fallback.
``dense-torch`` is the single-market solver restricted to the CPU.
"""
from __future__ import annotations

from repro_torch.core.solvers.base import AuctionResult
from repro_torch.core.solvers.dense_common import package_dense
from repro_torch.core.solvers.dense_torch import (
    solve_dense_auction_torch, solve_dense_auction_torch_batch)

__all__ = ["solve_dense_auction_cuda", "CudaBackend"]


def solve_dense_auction_cuda(w, caps, *, max_rounds: int = 200_000,
                             start_prices=None, device="cuda"):
    """Dense auction solve on ``device`` (one launch, and a second only if
    a warm attempt trips its budget); returns a DenseAuctionResult."""
    return solve_dense_auction_torch(
        w, caps, max_rounds=max_rounds, start_prices=start_prices,
        solver_name="cuda", device=device)


class CudaBackend:
    """``solver="cuda"``: the staged auction kernel, hub blocks batched."""

    name = "cuda"
    supports_warm_start = True
    supports_batch = True

    def solve(self, w, costs, caps, *, payment_mode: str = "warmstart",
              start_prices=None, device="cuda") -> AuctionResult:
        """One market through the staged solve + batched Clarke payments."""
        res = solve_dense_auction_cuda(w, caps, start_prices=start_prices,
                                       device=device)
        return package_dense(self.name, w, costs, caps, res)

    def solve_batch(self, ws, costs_list, caps_list, *,
                    payment_mode: str = "warmstart", start_prices_list=None,
                    device="cuda") -> list[AuctionResult]:
        """Every market in one ``auction_solve`` call (one launch on a
        card), each under its shape bucket's round cap."""
        dres = solve_dense_auction_torch_batch(
            ws, caps_list, start_prices_list=start_prices_list,
            device=device)
        return [package_dense(self.name, w, c, caps, r)
                for w, c, caps, r in zip(ws, costs_list, caps_list, dres)]

    def certificate(self, result: AuctionResult) -> float:
        """2·n·ε_final at the float32 resolution-bounded ε schedule."""
        return float(result.solver_stats["gap_bound"])
