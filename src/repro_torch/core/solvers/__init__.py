"""Pluggable Phase-2 solver backends of the port.

One module per backend, one :class:`~repro_torch.core.solvers.base.SolverBackend`
protocol, one registry — ``run_auction``/``run_sharded_auction`` and the
config stack resolve ``solver=`` names through :func:`get_solver`.

Registered backends:

=========== ============================================== ===== ======
name        implementation                                 warm  batch
=========== ============================================== ===== ======
dense-torch staged float32 auction, plain bidding round    yes   no
            (CPU; the counterpart of the reference's
            ``dense-jax``)
cuda        staged float32 auction, CUDA bidding kernel    yes   no
            (plain round for CPU tensors)
=========== ============================================== ===== ======
"""
from repro_torch.core.solvers.base import (AuctionResult, SolverBackend,
                                           available_solvers, get_solver,
                                           register_solver,
                                           sequential_solve_batch)
from repro_torch.core.solvers.cuda_backend import (CudaBackend,
                                                   solve_dense_auction_cuda)
from repro_torch.core.solvers.dense_common import (DenseAuctionResult,
                                                   dense_clarke_payments)
from repro_torch.core.solvers.dense_torch import (DenseTorchBackend,
                                                  solve_dense_auction_torch)

register_solver(DenseTorchBackend())
register_solver(CudaBackend())

__all__ = [
    "AuctionResult", "SolverBackend", "available_solvers", "get_solver",
    "register_solver", "sequential_solve_batch",
    "DenseAuctionResult", "dense_clarke_payments",
    "DenseTorchBackend", "CudaBackend",
    "solve_dense_auction_torch", "solve_dense_auction_cuda",
]
