"""Back-compat shim: the dense auction lives in ``repro_torch.core.solvers``.

The port's counterpart of the reference's ``repro.core.auction_dense``,
which re-exports the historical public names of the dense auction.  Each
name stands for the port's own:

* ``DenseAuctionResult``, ``dense_clarke_payments`` —
  ``solvers/dense_common.py``, as in the reference;
* ``solve_dense_auction`` — the float64 NumPy solver of
  ``solvers/dense_np.py``, as in the reference;
* ``solve_dense_auction_torch`` and ``solve_dense_auction_torch_batch`` —
  ``solvers/dense_torch.py``, where the reference has
  ``solve_dense_auction_jax`` and ``solve_dense_auction_jax_batch``.

New code should import from ``repro_torch.core.solvers`` directly.
"""
from repro_torch.core.solvers.dense_common import (DenseAuctionResult,
                                                   dense_clarke_payments)
from repro_torch.core.solvers.dense_np import solve_dense_auction
from repro_torch.core.solvers.dense_torch import (
    solve_dense_auction_torch, solve_dense_auction_torch_batch)

__all__ = [
    "DenseAuctionResult",
    "solve_dense_auction",
    "solve_dense_auction_torch",
    "solve_dense_auction_torch_batch",
    "dense_clarke_payments",
]
