"""Pluggable Phase-2 solver backends of the port.

One module per backend, one :class:`~repro_torch.core.solvers.base.SolverBackend`
protocol, one registry — ``run_auction``/``run_sharded_auction`` and the
config stack resolve ``solver=`` names through :func:`get_solver`.

Registered backends:

=========== ============================================== ===== ======
name        implementation                                 warm  batch
=========== ============================================== ===== ======
mcmf        exact MCMF oracle (pure Python, float64, on    no    no
            the host)
dense       vectorized NumPy ε-scaling auction (float64,   yes   no
            on the host)
dense-torch staged float32 auction, plain bidding round    yes   no
            (CPU; the counterpart of the reference's
            ``dense-jax``)
cuda        staged float32 auction, one CUDA launch per    yes   yes
            solve (the plain staged market for CPU
            tensors; the counterpart of ``pallas``)
=========== ============================================== ===== ======

``mcmf`` and ``dense`` take the ``device=`` keyword like every backend and
move nothing.  ``dense-torch`` and ``cuda`` are the two the fused routing
step can run (`repro_torch.core.routing_fused.FUSED_SOLVERS`).
"""
from repro_torch.core.solvers.base import (AuctionResult, SolverBackend,
                                           available_solvers, get_solver,
                                           register_solver,
                                           sequential_solve_batch)
from repro_torch.core.solvers.cuda_backend import (CudaBackend,
                                                   solve_dense_auction_cuda)
from repro_torch.core.solvers.dense_common import (DenseAuctionResult,
                                                   dense_clarke_payments)
from repro_torch.core.solvers.dense_np import (DenseNumpyBackend,
                                               solve_dense_auction)
from repro_torch.core.solvers.dense_torch import (DenseTorchBackend,
                                                  solve_dense_auction_torch)
from repro_torch.core.solvers.mcmf import McmfBackend, solve_allocation

register_solver(McmfBackend())
register_solver(DenseNumpyBackend())
register_solver(DenseTorchBackend())
register_solver(CudaBackend())

__all__ = [
    "AuctionResult", "SolverBackend", "available_solvers", "get_solver",
    "register_solver", "sequential_solve_batch",
    "DenseAuctionResult", "dense_clarke_payments",
    "DenseNumpyBackend", "DenseTorchBackend", "CudaBackend", "McmfBackend",
    "solve_allocation", "solve_dense_auction", "solve_dense_auction_torch",
    "solve_dense_auction_cuda",
]
