"""Staged dense column auction in PyTorch, on the router's device.

The counterpart of the reference's jit-staged solver
(`repro.core.solvers.dense_jax._build_jax_solver`): the same capacitated
column market, ε schedules, eviction pass, forward bidding and reverse
rounds, warm-start budget and cold fallback, op for op in float32.  The
market state lives on an (m × cmax) unit-price grid — one capacitated column
per agent, ``counts[i] = min(b_i, n)`` live units each.  The forward bidding
round always goes through `repro_torch.kernels.ops.auction_bid_op`: the CUDA
kernel for a market on the card, the plain PyTorch round for a market on the
CPU.

Where the reference stages four nested ``lax.while_loop``s (ε phase →
settle → forward bidding / reverse rounds), this solver keeps the state on
the device and evaluates each loop's condition once per iteration on the
host.  The round count ``rounds`` must match the reference exactly: it
decides the warm-budget fallback and the cold-cap error, and it is reported
in ``solver_stats``; a host loop counts exactly the iterations whose
condition held.

Things that must match the reference bit for bit, each handled below:

* The ε schedule is float32 in the reference (the jitted solve receives ε₀,
  ε_final and θ as float32 scalars), so it is kept in ``np.float32`` here:
  ``tol = ε_final / 8``, ``ε / θ`` and the phase test are float32 ops.
  Evaluated in float64 the phase count would differ.
* ``mode="drop"`` scatters use the sentinels n and m; PyTorch has none, so
  every scatter goes into one extra sink slot that is sliced off.
* Ties go to the first index everywhere (``argmax``/``argmin``; the
  ``argmax`` of a bool grid is taken on an integer cast).
* The market is solved unpadded, at (n, m, cmax), so the warm budget
  ``warm_round_budget(n, m·cmax)`` is the reference's.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.solvers.base import (AuctionResult,
                                           sequential_solve_batch)
from repro_torch.core.solvers.dense_common import (THETA, _price_grid,
                                                   check_start_prices,
                                                   column_counts,
                                                   empty_result,
                                                   float32_eps_final,
                                                   materialize_staged,
                                                   package_dense, warm_eps0,
                                                   warm_round_budget)
from repro_torch.kernels import ops
from repro_torch.utils.device import resolve_device

__all__ = ["solve_dense_auction_torch", "DenseTorchBackend"]

_F32 = np.float32
_BIG = torch.finfo(torch.float32).max / 4


def _set(x: torch.Tensor, idx: torch.Tensor, val) -> torch.Tensor:
    """``x.at[idx].set(val, mode="drop")`` for a 1-D ``x``: index
    ``len(x)`` is the drop sentinel, scattered into a sink slot."""
    buf = torch.cat([x, x.new_empty(1)])
    buf.scatter_(0, idx.long(), val)
    return buf[:-1]


def _set2(x: torch.Tensor, row: torch.Tensor, col: torch.Tensor,
          val) -> torch.Tensor:
    """``x.at[row, col].set(val, mode="drop")`` for a 2-D ``x`` whose drop
    sentinel is ``row == x.shape[0]``."""
    m, c = x.shape
    flat = torch.where(row < m, row.long() * c + col.long(), m * c)
    buf = torch.cat([x.reshape(-1), x.new_empty(1)])
    buf.scatter_(0, flat, val)
    return buf[:-1].view(m, c)


def _reduce(fill, size: int, idx: torch.Tensor, src: torch.Tensor,
            how: str) -> torch.Tensor:
    """``full(size, fill).at[idx].max/min(src, mode="drop")``."""
    buf = torch.full((size + 1,), fill, dtype=src.dtype, device=src.device)
    buf.scatter_reduce_(0, idx.long(), src, how, include_self=True)
    return buf[:size]


class _State:
    """The solver's device-resident market state plus the host round count."""

    __slots__ = ("unit_price", "unit_owner", "agent_of", "unit_of", "parked",
                 "rounds")

    def __init__(self, p0, n: int):
        m, cmax = p0.shape
        dev = p0.device
        self.unit_price = p0
        self.unit_owner = torch.full((m, cmax), -1, dtype=torch.int32,
                                     device=dev)
        self.agent_of = torch.full((n,), -1, dtype=torch.int32, device=dev)
        self.unit_of = torch.full((n,), -1, dtype=torch.int32, device=dev)
        self.parked = torch.zeros((n,), dtype=torch.bool, device=dev)
        self.rounds = 0


class _StagedMarket:
    """One column market (W, counts) and its loops; see the module
    docstring.  The scalars ``eps`` and ``tol`` are float32 values on the
    host; the sentinels of the drop scatters are n (no request) and m (no
    agent row)."""

    def __init__(self, W, counts, cmax: int, max_rounds: int, eps_final):
        dev = W.device
        self.W = W
        self.n, self.m = n, m = W.shape
        self.max_rounds = max_rounds
        self.tol = _F32(eps_final) / _F32(8.0)
        self.rows = torch.arange(n, device=dev)
        self.arange_m = torch.arange(m, dtype=torch.int32, device=dev)
        self.uiota = torch.arange(cmax, dtype=torch.int32,
                                  device=dev)[None, :].expand(m, cmax)
        self.valid = self.uiota < counts[:, None]
        self.niota = torch.arange(n, dtype=torch.int32,
                                  device=dev)[None, :].expand(m, n)

    def asks(self, unit_price):
        """Cheapest / second-cheapest unit price per agent (+big where the
        agent has fewer than one/two units), and the cheapest unit's index
        — the unit a winning bid fills."""
        priced = torch.where(self.valid, unit_price, _BIG)
        ask = priced.amin(dim=1)
        ku = priced.argmin(dim=1).to(torch.int32)
        ask2 = torch.where(self.uiota == ku[:, None], _BIG, priced).amin(dim=1)
        return ask, ask2, ku

    def _profit(self, s: _State):
        """Each assigned request's profit at its unit (0 if unassigned)."""
        assigned = s.agent_of >= 0
        ai = s.agent_of.clamp(min=0).long()
        ui = s.unit_of.clamp(min=0).long()
        return assigned, torch.where(
            assigned, self.W[self.rows, ai] - s.unit_price[ai, ui], 0.0)

    def stale(self, s: _State):
        return (s.unit_owner < 0) & (s.unit_price > 0.0) & self.valid

    def cs_state(self, s: _State, eps):
        """(unpark-violators, evict-violators, stale-unit grid)."""
        ask, _, _ = self.asks(s.unit_price)
        v1 = (self.W - ask[None, :]).amax(dim=1)
        assigned, prof = self._profit(s)
        unpark = s.parked & (v1 > float(eps + self.tol))
        viol = assigned & (prof < v1.clamp(min=0.0) - float(eps)
                           - float(self.tol))
        return unpark, viol, self.stale(s)

    def evict(self, s: _State, eps) -> None:
        # prices are KEPT: with unchanged prices the eviction pass is
        # idempotent, so a single sweep suffices (no cascade loop)
        unpark, viol, _ = self.cs_state(s, eps)
        s.parked = s.parked & ~unpark
        s.unit_owner = _set2(s.unit_owner,
                             torch.where(viol, s.agent_of, self.m),
                             s.unit_of.clamp(min=0), -1)
        s.agent_of = torch.where(viol, -1, s.agent_of)
        s.unit_of = torch.where(viol, -1, s.unit_of)

    def bid_until_settled(self, s: _State, eps) -> None:
        n, m, arange_m = self.n, self.m, self.arange_m
        while s.rounds < self.max_rounds:
            # each loop's condition is read on the host once per iteration,
            # so `rounds` counts exactly the iterations whose condition held
            active = (s.agent_of < 0) & ~s.parked
            if not bool(active.any()):
                break
            ask, ask2, ku = self.asks(s.unit_price)
            best, winner, wants = ops.auction_bid_op(self.W, ask, ask2,
                                                     active, float(eps))
            s.parked = s.parked | (active & ~wants)
            won = winner < n
            # displaced: the won unit's old owner loses it (owners never
            # bid, so a displaced request is never also a winner)
            old = s.unit_owner[arange_m.long(), ku.long()]
            disp = torch.where(won & (old >= 0), old, n)
            s.agent_of = _set(s.agent_of, disp, -1)
            s.unit_of = _set(s.unit_of, disp, -1)
            wix = torch.where(won, winner, n)
            s.agent_of = _set(s.agent_of, wix, arange_m)
            s.unit_of = _set(s.unit_of, wix, ku)
            wrow = torch.where(won, arange_m, m)
            s.unit_owner = _set2(s.unit_owner, wrow, ku, winner)
            s.unit_price = _set2(s.unit_price, wrow, ku, best)
            s.rounds += 1

    def reverse_until_clean(self, s: _State, eps) -> None:
        n, m, arange_m = self.n, self.m, self.arange_m
        e = float(eps)
        while s.rounds < self.max_rounds:
            stale = self.stale(s)
            if not bool(stale.any()):
                break
            has_stale = stale.any(dim=1)
            _, pi = self._profit(s)
            # per-agent best/second-best support over requests (only agents
            # with a stale unit participate this round)
            V = torch.where(has_stale[:, None], self.W.T - pi[None, :], -_BIG)
            b1 = V.amax(dim=1)
            j1 = V.argmax(dim=1).to(torch.int32)   # first index on ties
            b2 = torch.where(self.niota == j1[:, None], -_BIG, V).amax(dim=1)
            weak = has_stale & (b1 <= e)
            # a weak agent's stale units all re-anchor to 0 this round
            s.unit_price = torch.where(weak[:, None] & stale, 0.0,
                                       s.unit_price)
            strong = has_stale & ~weak
            newp = (b2 - e).clamp(min=0.0)
            # the agent's LOWEST-index stale unit takes the grab (argmax of
            # the bool grid, taken on an integer cast: first True, else 0)
            us = stale.to(torch.int8).argmax(dim=1).to(torch.int32)
            off = torch.where(strong, self.W[j1.long(), arange_m.long()] - newp,
                              -_BIG)
            # request-side conflicts: best offer wins, ties to lowest agent
            bestoff = _reduce(-_BIG, n, torch.where(strong, j1, n), off,
                              "amax")
            at_best = strong & (off == bestoff[j1.long()])
            take = _reduce(m, n, torch.where(at_best, j1, n),
                           arange_m, "amin")
            sel = strong & (take[j1.long()] == arange_m)
            # free the grabbed request's old unit (its price is kept — the
            # freed unit goes stale and re-anchors next round)
            old_a = s.agent_of[j1.long()]
            old_u = s.unit_of[j1.long()].clamp(min=0)
            free = sel & (old_a >= 0)
            s.unit_owner = _set2(s.unit_owner,
                                 torch.where(free, old_a, m),
                                 old_u, -1)
            srow = torch.where(sel, arange_m, m)
            s.unit_price = _set2(s.unit_price, srow, us, newp)
            s.unit_owner = _set2(s.unit_owner, srow, us, j1)
            grab = torch.where(sel, j1, n)
            s.agent_of = _set(s.agent_of, grab, arange_m)
            s.unit_of = _set(s.unit_of, grab, us)
            s.parked = _set(s.parked, grab, False)
            s.rounds += 1

    def settle(self, s: _State, eps) -> None:
        """Alternate forward bidding and reverse rounds at this ε."""
        while s.rounds < self.max_rounds:
            unpark, viol, stale = self.cs_state(s, eps)
            active = (s.agent_of < 0) & ~s.parked
            if not bool(unpark.any() | viol.any() | stale.any()
                        | active.any()):
                break
            self.evict(s, eps)
            self.bid_until_settled(s, eps)
            self.reverse_until_clean(s, eps)

    def solve(self, p0, eps0, eps_final, theta):
        """ε-scaling phases, then one final settle at ε_final; returns
        (unit_price, agent_of, unit_of, rounds)."""
        s = _State(p0, self.n)
        eps_final = _F32(eps_final)
        theta = _F32(theta)
        eps = _F32(eps0)
        # the reference tests eps > eps_final * 1.0000000001 in float32,
        # where the factor rounds to 1.0
        while eps > eps_final and s.rounds < self.max_rounds:
            self.settle(s, eps)
            eps = max(_F32(eps / theta), eps_final)
        self.settle(s, eps_final)
        return s.unit_price, s.agent_of, s.unit_of, s.rounds


def solve_dense_auction_torch(w, caps, *, eps_final: float | None = None,
                              theta: float = THETA,
                              max_rounds: int = 200_000,
                              start_prices: np.ndarray | None = None,
                              solver_name: str = "dense-torch",
                              device="cuda"):
    """Staged float32 column auction on ``device``; returns a
    DenseAuctionResult with host-side NumPy values.

    ``start_prices`` (flat agent-major, length K = Σ min(b_i, n)) seeds the
    unit-price grid: the warm attempt skips the coarse phases and runs
    under ``warm_round_budget``; tripping the budget re-solves cold.
    """
    dev = resolve_device(device)
    w_np = np.asarray(w, dtype=np.float64)
    n, m = w_np.shape
    counts = column_counts(caps, n)
    K = int(counts.sum())
    if n == 0 or K == 0:
        return empty_result(n, counts)
    W_np = np.maximum(w_np, 0.0)
    # ε anchors on the largest weight an agent WITH units can sell at
    # (zero-capacity columns never trade)
    wmax = float(W_np[:, counts > 0].max(initial=0.0))
    if wmax <= 0.0:
        return empty_result(n, counts)
    cmax = int(counts.max())
    warm = start_prices is not None
    if warm:
        p0_np = check_start_prices(start_prices, K)
    W = torch.from_numpy(W_np.astype(np.float32)).to(dev)
    counts_t = torch.from_numpy(counts.astype(np.int32)).to(dev)
    if eps_final is None:
        eps_final = float32_eps_final(wmax, np.float32)
    cold_eps0 = max(wmax / theta, eps_final)

    def run(p0, eps0, cap):
        market = _StagedMarket(W, counts_t, cmax, cap, eps_final)
        unit_price, agent_of, unit_of, rounds = market.solve(
            torch.from_numpy(p0.astype(np.float32)).to(dev), eps0, eps_final,
            theta)
        return (unit_price.cpu().numpy(), agent_of.cpu().numpy(),
                unit_of.cpu().numpy(), rounds)

    if warm:
        eps0 = min(warm_eps0(p0_np, wmax, eps_final, theta), cold_eps0)
        budget = warm_round_budget(n, m * cmax, max_rounds)
        unit_price, agent_of, unit_of, rounds = run(
            _price_grid(p0_np, counts, cmax), eps0, budget)
        if rounds < budget:
            return materialize_staged(w_np, counts, unit_price, agent_of,
                                      unit_of, rounds, eps_final,
                                      warm_started=True)
        # warm attempt tripped its budget -> cold re-solve below
    unit_price, agent_of, unit_of, rounds = run(
        np.zeros((m, cmax)), cold_eps0, max_rounds)
    if rounds >= max_rounds:
        # the loops stop at the cap; surface it instead of returning a bad
        # matching
        raise RuntimeError(
            f"dense auction ({solver_name}) failed to converge in "
            f"{max_rounds} rounds (n={n}, m={m}, eps_final={eps_final:g})")
    return materialize_staged(w_np, counts, unit_price, agent_of, unit_of,
                              rounds, eps_final, warm_started=warm,
                              fallback=warm)


class DenseTorchBackend:
    """``solver="dense-torch"``: the staged float32 auction on the CPU,
    where the bidding round is the plain PyTorch version (the counterpart of
    the reference's ``dense-jax``; on the card, use ``cuda``)."""

    name = "dense-torch"
    supports_warm_start = True
    supports_batch = False

    def solve(self, w, costs, caps, *, payment_mode: str = "warmstart",
              start_prices=None, device="cpu") -> AuctionResult:
        """One market through the staged solver + batched Clarke payments."""
        if resolve_device(device).type != "cpu":
            raise ValueError("dense-torch runs the plain bidding round on the "
                             "CPU; use solver='cuda' on a CUDA device")
        res = solve_dense_auction_torch(w, caps, start_prices=start_prices,
                                        device=device)
        return package_dense(self.name, w, costs, caps, res)

    def solve_batch(self, ws, costs_list, caps_list, *,
                    payment_mode: str = "warmstart", start_prices_list=None,
                    device="cpu") -> list[AuctionResult]:
        """One ``solve`` per market."""
        return sequential_solve_batch(self, ws, costs_list, caps_list,
                                      payment_mode=payment_mode,
                                      start_prices_list=start_prices_list,
                                      device=device)

    def certificate(self, result: AuctionResult) -> float:
        """2·n·ε_final at the float32 resolution-bounded ε schedule."""
        return float(result.solver_stats["gap_bound"])
