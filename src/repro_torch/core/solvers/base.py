"""Phase-2 solver backend protocol + the port's own registry.

Every welfare-matching solver the port's router can run — the staged column
auction with its plain PyTorch bidding round (``dense-torch``), the same
solver with the hand-written CUDA bidding kernel (``cuda``), and whatever
comes next — is a :class:`SolverBackend` registered here by name.
``run_auction``/``run_sharded_auction`` (and through them
``RouterConfig``/``make_router``) resolve the ``solver=`` string through
:func:`get_solver`, so adding a backend is one new module plus one
:func:`register_solver` call — ``core/auction.py`` never changes.

The protocol's surface is deliberately small:

* ``solve``        — one market: pruned weight matrix + costs + capacities
                     (and an optional warm-start dual seed) in, a full
                     :class:`AuctionResult` (allocation, welfare, VCG
                     payments, solver stats) out; ``device=`` says where
                     the solver's tensors live.
* ``solve_batch``  — many independent markets (the per-hub blocks of the
                     sharded auction); backends that can batch override
                     it, everyone else inherits the
                     sequential default via :func:`sequential_solve_batch`.
* ``certificate``  — the certified welfare gap of a result (0 for exact
                     solvers, 2·n·ε for the auction family), so callers can
                     reason about optimality without per-backend knowledge.
* capability flags — ``supports_warm_start`` (accepts ``start_prices`` dual
                     seeds; the router's price book consults this instead
                     of hard-coding solver names) and ``supports_batch``
                     (``solve_batch`` is genuinely batched, not a loop).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Protocol, runtime_checkable

import numpy as np


@dataclass
class AuctionResult:
    """One Phase-2 solve: allocation, welfare, payments + solver stats."""

    assignment: list            # request j -> agent index or -1
    welfare: float              # W(C)
    payments: list              # VCG payment per request (0 if unmatched)
    weights: np.ndarray         # w_ij matrix used
    costs: np.ndarray           # c_ij matrix used
    solver_stats: dict = field(default_factory=dict)


@runtime_checkable
class SolverBackend(Protocol):
    """What a Phase-2 solver must provide to join the registry.

    Implementations are stateless singletons: all per-solve state lives in
    the returned :class:`AuctionResult` (warm-start duals round-trip through
    ``solver_stats["agent_prices"]`` and the caller's price book).
    """

    name: str
    supports_warm_start: bool   # accepts start_prices dual seeds
    supports_batch: bool        # solve_batch is batched, not a loop

    def solve(self, w: np.ndarray, costs: np.ndarray, caps, *,
              payment_mode: str = "warmstart",
              start_prices: np.ndarray | None = None,
              device="cuda") -> AuctionResult:
        """Solve one market given the pruned weight matrix ``w`` (>= 0)."""
        ...

    def solve_batch(self, ws, costs_list, caps_list, *,
                    payment_mode: str = "warmstart",
                    start_prices_list=None,
                    device="cuda") -> list[AuctionResult]:
        """Solve many independent markets (one per hub block)."""
        ...

    def certificate(self, result: AuctionResult) -> float:
        """Certified welfare gap of ``result`` (0.0 for exact solvers)."""
        ...


def sequential_solve_batch(backend: SolverBackend, ws, costs_list, caps_list,
                           *, payment_mode: str = "warmstart",
                           start_prices_list=None,
                           device="cuda") -> list[AuctionResult]:
    """Default ``solve_batch``: one independent ``solve`` per market."""
    sp = start_prices_list or [None] * len(ws)
    return [backend.solve(w, c, caps, payment_mode=payment_mode,
                          start_prices=s, device=device)
            for w, c, caps, s in zip(ws, costs_list, caps_list, sp)]


_REGISTRY: dict[str, SolverBackend] = {}


def register_solver(backend: SolverBackend) -> SolverBackend:
    """Add (or replace) a backend under ``backend.name``; returns it."""
    if not isinstance(backend, SolverBackend):
        raise TypeError(f"{backend!r} does not satisfy SolverBackend")
    _REGISTRY[backend.name] = backend
    return backend


def get_solver(name: str) -> SolverBackend:
    """Resolve a ``solver=`` string; raises ValueError when unknown."""
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown solver {name!r}; available: "
                         f"{available_solvers()}") from None


def available_solvers() -> list[str]:
    """Registered backend names, sorted (the CLI's ``--solver`` choices)."""
    return sorted(_REGISTRY)
