"""Dense ε-scaling column auction in float64 NumPy (the reference solver).

The port's copy of the reference's ``repro.core.solvers.dense_np``
column solver, NumPy only.  It is the fallback of the hub-batched staged
solve: a market whose float32 staged solve reaches its round cap is
re-solved here (``result.fallback``), exactly as the reference's
``solve_dense_auction_jax_batch`` does.

Max-weight b-matching over a dense (n_requests × n_agents) weight matrix is
solved by Bertsekas' auction with ε-scaling over the capacitated column
market: each agent i is ONE column holding a counter of ``min(b_i, n)``
unit prices; a request's ask against agent i is the agent's cheapest unit
and a winning bid fills exactly one unit.  A request may stay unmatched
(outside option, profit 0).  Within a phase every assigned request's
profit is within ε of its best option; between phases assignments and
prices are kept and only requests whose ε-CS fails at the tighter ε are
evicted.  Free units with a positive price are re-anchored by reverse
rounds (Bertsekas–Castañón), so the assignment is certified within
2·n·ε_final of the optimum.

``start_prices`` (the flat agent-major concatenation of per-agent ascending
price vectors) warm-starts the solve under a bounded round budget, with a
cold re-solve when it trips (``result.fallback``).

``solve_dense_auction_slots`` keeps the classical per-unit slot expansion
as the column market's parity oracle, and ``DenseNumpyBackend`` registers
this solver as ``solver="dense"`` (warm starts yes, batching no).  Both run
on the host; the backend takes the ``device=`` keyword every backend of the
port receives and moves nothing.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.solvers.base import (AuctionResult,
                                           sequential_solve_batch)
from repro_torch.core.solvers.dense_common import (DenseAuctionResult, THETA,
                                                   _price_grid,
                                                   check_start_prices,
                                                   column_counts,
                                                   empty_result, expand_slots,
                                                   package_dense, warm_eps0,
                                                   warm_round_budget)

__all__ = ["EPS_FINAL_REL", "solve_dense_auction",
           "solve_dense_auction_slots", "DenseNumpyBackend"]

# gap_bound = 2 * n * eps_final: below 1e-7 for any n <= ~500 at unit
# weight scale
EPS_FINAL_REL = 1e-10


def solve_dense_auction(w: np.ndarray, caps, *, eps_final: float | None = None,
                        theta: float = THETA,
                        max_rounds: int = 500_000,
                        start_prices: np.ndarray | None = None,
                        start_eps: float | None = None) -> DenseAuctionResult:
    """ε-scaling column auction over dense weights. w[j, i] <= 0 = "no edge".

    ``start_prices`` (flat agent-major, length ``K = sum(min(b_i, n))``)
    seeds the duals; the warm attempt starts its ε schedule at
    ``start_eps`` (default wmax/θ³ when the seed is informative) and is
    round-budgeted — on budget exhaustion the solve restarts cold
    (``result.fallback``).  The certificate is 2·n·ε_final either way.
    """
    w = np.asarray(w, dtype=np.float64)
    n, m = w.shape
    counts = column_counts(caps, n)
    K = int(counts.sum())
    if n == 0 or K == 0:
        return empty_result(n, counts)
    W = np.maximum(w, 0.0)
    # ε anchors on the largest weight an agent WITH units can sell at
    wmax = float(W[:, counts > 0].max(initial=0.0))
    if wmax <= 0.0:
        return empty_result(n, counts)
    cmax = int(counts.max())
    if eps_final is None:
        eps_final = EPS_FINAL_REL * max(wmax, 1.0)
    cold_eps0 = max(wmax / theta, eps_final)
    if start_prices is None:
        return _solve_dense_columns(w, W, counts, np.zeros((m, cmax)),
                                    cold_eps0, eps_final, theta, max_rounds)
    p0 = check_start_prices(start_prices, K)
    eps0 = start_eps if start_eps is not None \
        else warm_eps0(p0, wmax, eps_final, theta)
    eps0 = min(max(eps0, eps_final), cold_eps0)
    budget = warm_round_budget(n, K, max_rounds)
    try:
        res = _solve_dense_columns(w, W, counts, _price_grid(p0, counts, cmax),
                                   eps0, eps_final, theta, budget)
        res.warm_started = True
        return res
    except RuntimeError:
        res = _solve_dense_columns(w, W, counts, np.zeros((m, cmax)),
                                   cold_eps0, eps_final, theta, max_rounds)
        res.warm_started = True
        res.fallback = True
        return res


def _solve_dense_columns(w, W, counts, grid0, eps0, eps_final, theta,
                         max_rounds) -> DenseAuctionResult:
    """The forward/reverse ε-scaling loop over the capacitated column
    market, from a given (unit-price grid, ε₀) state."""
    n, m = W.shape
    cmax = grid0.shape[1]
    K = int(counts.sum())
    valid = np.arange(cmax)[None, :] < counts[:, None]      # (m, cmax)
    eps = eps0
    # absolute slack for the ε-CS tests: at price magnitude ~wmax a
    # relative-only slack can fall below one ulp and cycle
    tol = eps_final / 8.0

    unit_price = grid0.copy()
    unit_owner = np.full((m, cmax), -1, dtype=np.int64)
    agent_of = np.full(n, -1, dtype=np.int64)       # request -> agent
    unit_of = np.full(n, -1, dtype=np.int64)        # request -> unit index
    parked = np.zeros(n, dtype=bool)
    rows = np.arange(n)
    phases = 0
    rounds = [0]

    def _asks():
        """Per-agent cheapest unit (price, index) and second-cheapest
        price (+inf for single-unit agents)."""
        priced = np.where(valid, unit_price, np.inf)
        ask = priced.min(axis=1)
        ku = priced.argmin(axis=1)
        ask2 = np.partition(priced, 1, axis=1)[:, 1] if cmax >= 2 \
            else np.full(m, np.inf)
        return ask, ask2, ku

    def _evict(eps) -> bool:
        """Unpark/evict requests whose ε-CS fails at current prices (prices
        are kept); returns whether anything is left to bid."""
        ask, _, _ = _asks()
        v1 = (W - ask[None, :]).max(axis=1)
        assigned = agent_of >= 0
        ai = np.maximum(agent_of, 0)
        prof = np.where(assigned,
                        W[rows, ai] - unit_price[ai, np.maximum(unit_of, 0)],
                        0.0)
        np.logical_and(parked, v1 <= eps + tol, out=parked)
        # the best option includes the outside option (profit 0)
        viol = assigned & (prof < np.maximum(v1, 0.0) - eps - tol)
        if viol.any():
            unit_owner[agent_of[viol], unit_of[viol]] = -1
            agent_of[viol] = -1
            unit_of[viol] = -1
        return bool(((agent_of < 0) & ~parked).any())

    def _bid_until_settled(eps):
        """Jacobi bidding rounds until every request is assigned or parked."""
        while True:
            active = np.nonzero((agent_of < 0) & ~parked)[0]
            if len(active) == 0:
                return
            rounds[0] += 1
            if rounds[0] > max_rounds:
                raise RuntimeError(
                    f"dense auction failed to converge in {max_rounds} rounds"
                    f" (n={n}, m={m}, eps={eps:g})")
            ask, ask2, ku = _asks()
            P = W[active] - ask[None, :]                 # (A, m) profits
            v1 = P.max(axis=1)
            k1 = P.argmax(axis=1)
            # runner-up: other agents' cheapest units and the favourite
            # agent's own second-cheapest unit
            P[np.arange(len(active)), k1] = W[active, k1] - ask2[k1]
            v2 = np.maximum(P.max(axis=1), 0.0)          # incl. outside option
            wants = v1 > 0.0
            parked[active[~wants]] = True                # outside option wins
            bidders = active[wants]
            if len(bidders) == 0:
                continue
            kb = k1[wants]
            bid = ask[kb] + (v1[wants] - v2[wants]) + eps
            # per-agent winner: highest bid, ties to the lowest request index
            best = np.full(m, -np.inf)
            np.maximum.at(best, kb, bid)
            winner = np.full(m, n, dtype=np.int64)
            at_best = bid == best[kb]                    # exact float match
            np.minimum.at(winner, kb[at_best], bidders[at_best])
            won = np.nonzero(winner < n)[0]              # agents that sold
            uw = ku[won]
            prev = unit_owner[won, uw]
            live = prev[prev >= 0]
            agent_of[live] = -1
            unit_of[live] = -1
            wj = winner[won]
            unit_owner[won, uw] = wj
            agent_of[wj] = won
            unit_of[wj] = uw
            unit_price[won, uw] = best[won]

    def _reverse_until_clean(eps) -> None:
        """Reverse rounds: a free unit with a positive price lowers it to
        β₂ − ε and grabs its best supporter, or drops to 0 when no request
        supports it; at most one stale unit per agent (the lowest-index
        one) re-prices per round."""
        while True:
            stale = (unit_owner < 0) & (unit_price > 0.0) & valid
            si = np.nonzero(stale.any(axis=1))[0]
            if len(si) == 0:
                return
            rounds[0] += 1
            if rounds[0] > max_rounds:
                raise RuntimeError("dense auction reverse rounds exceeded "
                                   f"{max_rounds} (n={n}, m={m})")
            assigned = agent_of >= 0
            ai = np.maximum(agent_of, 0)
            pi = np.where(assigned,
                          W[rows, ai]
                          - unit_price[ai, np.maximum(unit_of, 0)], 0.0)
            V = W[:, si] - pi[:, None]            # support for each agent
            b1 = V.max(axis=0)
            j1 = V.argmax(axis=0)
            V[j1, np.arange(len(si))] = -np.inf
            b2 = V.max(axis=0) if n > 1 else np.full(len(si), -np.inf)
            weak = b1 <= eps                      # nobody worth grabbing
            weak_agents = np.zeros(m, dtype=bool)
            weak_agents[si[weak]] = True
            unit_price[stale & weak_agents[:, None]] = 0.0
            ks = si[~weak]
            if len(ks) == 0:
                continue
            js = j1[~weak]
            newp = np.maximum(b2[~weak] - eps, 0.0)
            # request-side conflicts: the best offer wins, ties to the lowest
            # agent index
            off = W[js, ks] - newp
            bestoff = np.full(n, -np.inf)
            np.maximum.at(bestoff, js, off)
            at_best = off == bestoff[js]
            take = np.full(n, m, dtype=np.int64)
            np.minimum.at(take, js[at_best], ks[at_best])
            sel = take[js] == ks
            ks, js, newp = ks[sel], js[sel], newp[sel]
            us = stale[ks].argmax(axis=1)         # lowest-index stale unit
            old_a, old_u = agent_of[js], unit_of[js]
            live = old_a >= 0
            # freed, keeps its price (maybe stale)
            unit_owner[old_a[live], old_u[live]] = -1
            unit_price[ks, us] = newp
            unit_owner[ks, us] = js
            agent_of[js] = ks
            unit_of[js] = us
            parked[js] = False

    while True:
        phases += 1
        # forward/reverse alternation at this ε until neither has work
        for _ in range(8 * (n + K) + 8):
            if _evict(eps):
                _bid_until_settled(eps)
                _reverse_until_clean(eps)
                continue
            if ((unit_owner < 0) & (unit_price > 0.0) & valid).any():
                _reverse_until_clean(eps)
                continue
            break
        else:
            raise RuntimeError("dense auction forward/reverse alternation "
                               f"failed to settle (n={n}, m={m}, eps={eps:g})")
        if eps <= eps_final * (1.0 + 1e-12):
            break
        eps = max(eps / theta, eps_final)

    assigned = agent_of >= 0
    ai = np.maximum(agent_of, 0)
    welfare = float(np.where(assigned, w[rows, ai], 0.0).sum())
    profits = np.where(assigned,
                       W[rows, ai] - unit_price[ai, np.maximum(unit_of, 0)],
                       0.0)
    agent_prices = [np.sort(unit_price[i, :int(c)])
                    for i, c in enumerate(counts)]
    return DenseAuctionResult(
        [int(a) for a in agent_of], welfare, agent_prices, counts, profits,
        eps, phases, rounds[0], 2.0 * n * eps)


# --------------------------------------------------------------------------
# Retained slot-expanded solver: the column market's parity oracle.
# --------------------------------------------------------------------------
def solve_dense_auction_slots(w: np.ndarray, caps, *,
                              eps_final: float | None = None,
                              theta: float = THETA,
                              max_rounds: int = 500_000,
                              start_prices: np.ndarray | None = None,
                              start_eps: float | None = None
                              ) -> DenseAuctionResult:
    """The classical per-unit slot expansion (agents split into min(b_i, n)
    identical slots), kept as the decision-parity oracle and the baseline
    the benchmarks measure the column market's ~K/m round cost cut against.
    Same result contract as :func:`solve_dense_auction` (per-agent ascending
    price vectors); O(n·K) per round instead of O(n·m + K).
    """
    w = np.asarray(w, dtype=np.float64)
    n, m = w.shape
    counts = column_counts(caps, n)
    slot_agent = expand_slots(caps, n)
    K = len(slot_agent)
    if n == 0 or K == 0:
        return empty_result(n, counts)
    B = np.maximum(w, 0.0)[:, slot_agent]          # (n, K) slot-level weights
    wmax = float(B.max(initial=0.0))
    if wmax <= 0.0:
        return empty_result(n, counts)
    if eps_final is None:
        eps_final = EPS_FINAL_REL * max(wmax, 1.0)
    cold_eps0 = max(wmax / theta, eps_final)
    if start_prices is None:
        return _solve_dense_slots(w, B, slot_agent, counts, np.zeros(K),
                                  cold_eps0, eps_final, theta, max_rounds)
    p0 = check_start_prices(start_prices, K)
    eps0 = start_eps if start_eps is not None \
        else warm_eps0(p0, wmax, eps_final, theta)
    eps0 = min(max(eps0, eps_final), cold_eps0)
    budget = warm_round_budget(n, K, max_rounds)
    try:
        res = _solve_dense_slots(w, B, slot_agent, counts, p0, eps0,
                                 eps_final, theta, budget)
        res.warm_started = True
        return res
    except RuntimeError:
        res = _solve_dense_slots(w, B, slot_agent, counts, np.zeros(K),
                                 cold_eps0, eps_final, theta, max_rounds)
        res.warm_started = True
        res.fallback = True
        return res


def _solve_dense_slots(w, B, slot_agent, counts, prices0, eps0, eps_final,
                       theta, max_rounds) -> DenseAuctionResult:
    """The forward/reverse ε-scaling loop over explicit unit slots."""
    n, K = B.shape
    m = w.shape[1]
    eps = eps0
    tol = eps_final / 8.0

    prices = prices0.copy()
    owner = np.full(K, -1, dtype=np.int64)          # slot -> request
    slot_of = np.full(n, -1, dtype=np.int64)        # request -> slot
    parked = np.zeros(n, dtype=bool)
    rows = np.arange(n)
    phases = 0
    rounds = [0]

    def _evict(eps) -> bool:
        v1 = (B - prices).max(axis=1)
        assigned = slot_of >= 0
        prof = np.where(assigned, B[rows, np.maximum(slot_of, 0)]
                        - prices[np.maximum(slot_of, 0)], 0.0)
        np.logical_and(parked, v1 <= eps + tol, out=parked)
        viol = assigned & (prof < np.maximum(v1, 0.0) - eps - tol)
        if viol.any():
            owner[slot_of[viol]] = -1
            slot_of[viol] = -1
        return bool(((slot_of < 0) & ~parked).any())

    def _bid_until_settled(eps):
        while True:
            active = np.nonzero((slot_of < 0) & ~parked)[0]
            if len(active) == 0:
                return
            rounds[0] += 1
            if rounds[0] > max_rounds:
                raise RuntimeError(
                    f"dense auction failed to converge in {max_rounds} rounds"
                    f" (n={n}, m={m}, eps={eps:g})")
            P = B[active] - prices                       # (A, K) profits
            v1 = P.max(axis=1)
            k1 = P.argmax(axis=1)
            P[np.arange(len(active)), k1] = -np.inf
            v2 = np.maximum(P.max(axis=1), 0.0)          # incl. outside option
            wants = v1 > 0.0
            parked[active[~wants]] = True
            bidders = active[wants]
            if len(bidders) == 0:
                continue
            kb = k1[wants]
            bid = prices[kb] + (v1[wants] - v2[wants]) + eps
            best = np.full(K, -np.inf)
            np.maximum.at(best, kb, bid)
            winner = np.full(K, n, dtype=np.int64)
            at_best = bid == best[kb]
            np.minimum.at(winner, kb[at_best], bidders[at_best])
            slots_won = np.nonzero(winner < n)[0]
            prev = owner[slots_won]
            slot_of[prev[prev >= 0]] = -1
            owner[slots_won] = winner[slots_won]
            slot_of[winner[slots_won]] = slots_won
            prices[slots_won] = best[slots_won]

    def _reverse_until_clean(eps) -> None:
        while True:
            stale = np.nonzero((owner < 0) & (prices > 0.0))[0]
            if len(stale) == 0:
                return
            rounds[0] += 1
            if rounds[0] > max_rounds:
                raise RuntimeError("dense auction reverse rounds exceeded "
                                   f"{max_rounds} (n={n}, m={m})")
            assigned = slot_of >= 0
            pi = np.where(assigned, B[rows, np.maximum(slot_of, 0)]
                          - prices[np.maximum(slot_of, 0)], 0.0)
            V = B[:, stale] - pi[:, None]
            b1 = V.max(axis=0)
            j1 = V.argmax(axis=0)
            V[j1, np.arange(len(stale))] = -np.inf
            b2 = V.max(axis=0) if n > 1 else np.full(len(stale), -np.inf)
            weak = b1 <= eps
            prices[stale[weak]] = 0.0
            ks = stale[~weak]
            if len(ks) == 0:
                continue
            js = j1[~weak]
            newp = np.maximum(b2[~weak] - eps, 0.0)
            off = B[js, ks] - newp
            bestoff = np.full(n, -np.inf)
            np.maximum.at(bestoff, js, off)
            at_best = off == bestoff[js]
            take = np.full(n, K, dtype=np.int64)
            np.minimum.at(take, js[at_best], ks[at_best])
            sel = take[js] == ks
            ks, js, newp = ks[sel], js[sel], newp[sel]
            old = slot_of[js]
            owner[old[old >= 0]] = -1    # freed, keeps price (maybe stale)
            prices[ks] = newp
            owner[ks] = js
            slot_of[js] = ks
            parked[js] = False

    while True:
        phases += 1
        for _ in range(8 * (n + K) + 8):
            if _evict(eps):
                _bid_until_settled(eps)
                _reverse_until_clean(eps)
                continue
            if ((owner < 0) & (prices > 0.0)).any():
                _reverse_until_clean(eps)
                continue
            break
        else:
            raise RuntimeError("dense auction forward/reverse alternation "
                               f"failed to settle (n={n}, m={m}, eps={eps:g})")
        if eps <= eps_final * (1.0 + 1e-12):
            break
        eps = max(eps / theta, eps_final)

    assignment = np.where(slot_of >= 0, slot_agent[np.maximum(slot_of, 0)], -1)
    welfare = float(np.where(slot_of >= 0,
                             w[rows, np.maximum(assignment, 0)], 0.0).sum())
    profits = np.where(slot_of >= 0,
                       B[rows, np.maximum(slot_of, 0)]
                       - prices[np.maximum(slot_of, 0)], 0.0)
    agent_prices = [np.sort(prices[slot_agent == i])
                    for i in range(len(counts))]
    return DenseAuctionResult(
        [int(a) for a in assignment], welfare, agent_prices, counts, profits,
        eps, phases, rounds[0], 2.0 * n * eps)


class DenseNumpyBackend:
    """``solver="dense"``: the float64 NumPy auction (DSIC-grade payments)."""

    name = "dense"
    supports_warm_start = True
    supports_batch = False

    def solve(self, w, costs, caps, *, payment_mode: str = "warmstart",
              start_prices=None, device="cpu") -> AuctionResult:
        """One market through the NumPy auction + batched Clarke payments,
        on the host whatever ``device`` says."""
        res = solve_dense_auction(w, caps, start_prices=start_prices)
        return package_dense(self.name, w, costs, caps, res)

    def solve_batch(self, ws, costs_list, caps_list, *,
                    payment_mode: str = "warmstart", start_prices_list=None,
                    device="cpu") -> list[AuctionResult]:
        """Sequential per-market solves (NumPy has no batched program)."""
        return sequential_solve_batch(
            self, ws, costs_list, caps_list, payment_mode=payment_mode,
            start_prices_list=start_prices_list, device=device)

    def certificate(self, result: AuctionResult) -> float:
        """2·n·ε_final — the ε-CS optimality bound of the returned solve."""
        return float(result.solver_stats["gap_bound"])
