"""Phase-2/3 façade: welfare matching (Eq. 7) + VCG payments (Eq. 8).

All solver selection goes through the ``core/solvers`` registry — this
module contains NO per-solver branching.  ``run_auction`` prunes the welfare
matrix and delegates to the named
:class:`~repro_torch.core.solvers.SolverBackend` (``dense-torch`` staged
auction with the plain round, ``cuda`` with the CUDA solve kernel, the host
solvers ``dense`` and ``mcmf`` — see ``available_solvers()``) on the
caller's ``device``;
``run_sharded_auction`` does the same per hub block, batching the blocks
through ``solve_batch`` when the backend supports it, and optionally runs a
cross-hub **spill** round: unmatched requests from saturated hubs re-auction
once over the residual capacity of every hub, recovering the welfare a hard
hub partition forfeits when one hub runs out of slots while another has
slack.

The dense family is certified within each result's
``solver_stats["gap_bound"]``; the port's tests hold its solvers against the
reference's staged solver round for round.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.solvers import (AuctionResult, available_solvers,
                                      get_solver)
from repro_torch.utils.timing import phase_scope

__all__ = ["AuctionResult", "run_auction", "run_sharded_auction",
           "available_solvers", "SPILL_HUB"]

#: pseudo hub id under which run_sharded_auction(..., spill=True) returns the
#: cross-hub second-round result; its request/agent indices are GLOBAL and
#: live in the result's solver_stats["spill"] block.
SPILL_HUB = -1


def _prune(values, costs) -> np.ndarray:
    """Welfare weights w_ij = v_ij - c_ij with non-positive pairs pruned."""
    w = np.asarray(values, dtype=np.float64) - np.asarray(costs,
                                                          dtype=np.float64)
    return np.where(w > 0, w, 0.0)


def run_auction(values: np.ndarray, costs: np.ndarray, caps,
                payment_mode: str = "warmstart",
                solver: str = "cuda",
                start_prices: np.ndarray | None = None,
                device="cuda") -> AuctionResult:
    """values/costs: [N requests, M agents] predicted v_ij and c_ij.

    Welfare weights w_ij = v_ij - c_ij; non-positive pairs pruned (Alg. 1).
    ``solver`` names a registered backend (``available_solvers()``); the
    dense family computes payments in one batched pass regardless of
    ``payment_mode`` and accepts a warm-start unit-price seed via
    ``start_prices`` (dropped for backends without persistent duals); the
    final duals come back in ``solver_stats["agent_prices"]`` for the
    caller's price book.  The solve runs on ``device``.
    """
    backend = get_solver(solver)
    if not backend.supports_warm_start:
        start_prices = None
    return backend.solve(_prune(values, costs),
                         np.asarray(costs, dtype=np.float64), caps,
                         payment_mode=payment_mode, start_prices=start_prices,
                         device=device)


def run_sharded_auction(values: np.ndarray, costs: np.ndarray, caps,
                        blocks: dict[int, tuple[list[int], list[int]]],
                        payment_mode: str = "warmstart",
                        solver: str = "cuda",
                        start_prices: dict[int, np.ndarray] | None = None,
                        spill: bool = False,
                        spill_agents: list[int] | None = None,
                        spill_warm: bool = True,
                        profiler=None,
                        device="cuda",
                        ) -> dict[int, AuctionResult]:
    """Phase 2 sharded across proxy hubs: one independent auction per block.

    ``blocks[h] = (request_indices, agent_indices)`` carves the global
    (values, costs, caps) market into hub h's sub-market; blocks must be
    agent-disjoint (the hub partition guarantees it), so the per-hub results
    splice into a global matching without capacity conflicts.  Every result
    is *identical* to calling :func:`run_auction` on that block alone — the
    only difference is scheduling: backends with ``supports_batch`` may
    solve all blocks in one batched call.

    ``start_prices[h]`` warm-starts hub h's dense solve (see
    `repro_torch.core.hub.SlotPriceBook` for the cache-keying contract).

    ``spill=True`` adds a cross-hub second round: requests left unmatched by
    their hub's auction bid once more over the residual capacity of ALL hub
    agents (hard hub pinning strands exactly this welfare when a hub
    saturates), and the extra result lands under :data:`SPILL_HUB` with its
    GLOBAL request/agent index lists in ``solver_stats["spill"]``.  First-
    round results are never altered, so the splice-parity contract above
    still holds hub by hub.  ``spill_agents`` widens the residual market to
    agents outside every block (a hub that received no requests this batch
    still has slack worth spilling onto); it defaults to the union of the
    blocks' agents.  With ``spill_warm=True`` (default) the spill round is
    seeded from the donor hubs' first-round duals: each agent's residual
    slots inherit its *lowest* first-round slot prices (the unsold slots —
    exactly the goods the spill market is selling), which the warm-capable
    dense backends use as ε-scaling start prices.  ``spill_warm=False``
    keeps the cold-start behaviour for A/B measurement.

    ``profiler`` (duck-typed ``phase(name)`` context manager) attributes
    wall-clock to ``phase2_solve[<solver>]`` and ``phase2_spill``.  Every
    solve runs on ``device``.

    Returns ``{hub_id: AuctionResult}`` — assignments/payments indexed
    *within* the block; the caller maps them back through ``blocks[h]``
    (and through ``solver_stats["spill"]`` for the spill round).
    """
    values = np.asarray(values, dtype=np.float64)
    costs = np.asarray(costs, dtype=np.float64)
    backend = get_solver(solver)
    sp = start_prices or {}
    hub_ids = sorted(blocks)
    ws, costs_b, caps_b, seeds = [], [], [], []
    for h in hub_ids:
        r_idx, a_idx = blocks[h]
        ws.append(_prune(values[np.ix_(r_idx, a_idx)],
                         costs[np.ix_(r_idx, a_idx)]))
        costs_b.append(costs[np.ix_(r_idx, a_idx)])
        caps_b.append([caps[i] for i in a_idx])
        seeds.append(sp.get(h) if backend.supports_warm_start else None)
    with phase_scope(profiler, f"phase2_solve[{solver}]"):
        if backend.supports_batch and len(blocks) > 1:
            results = backend.solve_batch(ws, costs_b, caps_b,
                                          payment_mode=payment_mode,
                                          start_prices_list=seeds,
                                          device=device)
        else:
            results = [backend.solve(w, c, cb, payment_mode=payment_mode,
                                     start_prices=s, device=device)
                       for w, c, cb, s in zip(ws, costs_b, caps_b, seeds)]
    out = dict(zip(hub_ids, results))
    if spill:
        with phase_scope(profiler, "phase2_spill"):
            spill_res = _spill_round(values, costs, caps, blocks, out,
                                     backend, payment_mode, spill_agents,
                                     warm=spill_warm, device=device)
        if spill_res is not None:
            out[SPILL_HUB] = spill_res
    return out


def _spill_seed(results, blocks, a_idx, residual, n_spill
                ) -> np.ndarray | None:
    """Warm-start seed for the spill market from the donor hubs' duals.

    The spill market sells each agent's ``min(residual, n_spill)`` leftover
    capacity units.  A first-round dense solve left per-agent ascending
    unit-price vectors behind (``solver_stats["agent_prices"]``); an
    agent's cheapest units are the unsold ones — the very goods on sale
    here — so they are a near-equilibrium seed for the residual market.
    Agents with no first-round dual state (e.g. members of a hub that
    received no requests this batch) seed at 0, the free-unit boundary
    price.  Returns None when no donor duals exist at all (exact backends
    without persistent duals).
    """
    per_agent: dict[int, np.ndarray] = {}
    for h, (_br, ba) in blocks.items():
        stats = results[h].solver_stats
        if "agent_prices" not in stats:
            continue
        for li, gi in enumerate(ba):
            per_agent[gi] = np.asarray(stats["agent_prices"][li],
                                       dtype=np.float64)
    if not per_agent:
        return None
    segs = []
    for gi in a_idx:
        k = min(int(residual[gi]), n_spill)
        seg = np.zeros(k)
        prev = per_agent.get(gi)
        if prev is not None and k:
            take = min(k, len(prev))
            seg[:take] = prev[:take]
        segs.append(seg)
    return np.concatenate(segs) if segs else None


def _spill_round(values, costs, caps, blocks, results, backend,
                 payment_mode, spill_agents=None, warm: bool = True,
                 device="cuda") -> AuctionResult | None:
    """One cross-hub re-auction of first-round losers over residual slots.

    Gathers every request its hub left unmatched, computes each agent's
    residual capacity after the first round, and runs ONE more auction
    (same backend) over that global residual market.  Welfare can only
    increase: first-round matches are untouched and residual capacity was,
    by construction, going unused.  With ``warm=True`` and a warm-capable
    backend the solve is seeded from the donor hubs' duals (`_spill_seed`);
    the budgeted warm attempt falls back to a cold solve transparently, so
    the result is identical within the solver's certificate either way.
    Returns None when there is nothing to re-auction (no losers, no slack,
    or no positive cross-hub edge).
    """
    r_idx: list[int] = []
    used: dict[int, int] = {}
    for h in sorted(blocks):
        br, ba = blocks[h]
        res = results[h]
        for lj, j in enumerate(br):
            li = res.assignment[lj]
            if li < 0:
                r_idx.append(j)
            else:
                used[ba[li]] = used.get(ba[li], 0) + 1
    universe = spill_agents if spill_agents is not None else \
        {i for h in blocks for i in blocks[h][1]}
    a_idx = sorted(i for i in set(universe)
                   if caps[i] - used.get(i, 0) > 0)
    if not r_idx or not a_idx:
        return None
    w = _prune(values[np.ix_(r_idx, a_idx)], costs[np.ix_(r_idx, a_idx)])
    if float(w.max(initial=0.0)) <= 0.0:
        return None
    residual = {i: caps[i] - used.get(i, 0) for i in a_idx}
    seed = None
    if warm and backend.supports_warm_start:
        seed = _spill_seed(results, blocks, a_idx, residual, len(r_idx))
    res = backend.solve(w, costs[np.ix_(r_idx, a_idx)],
                        [residual[i] for i in a_idx],
                        payment_mode=payment_mode, start_prices=seed,
                        device=device)
    res.solver_stats["spill"] = {
        "r_idx": r_idx, "a_idx": a_idx,
        "candidates": len(r_idx),
        "rescued": sum(1 for a in res.assignment if a >= 0),
        "warm_started": seed is not None,
    }
    return res
