"""``solver="mcmf"``: the exact MCMF welfare oracle + §4.3 VCG payments.

Max-weight b-matching via successive-shortest-paths min-cost max-flow
(`repro_torch.core.mcmf`, the port's copy) — pure Python, exact (Theorem 4.1), the ground truth the
dense auction family is validated against.  Two payment computation modes
(§4.3):

  * ``naive``     — re-solve the MCMF from scratch for every matched request
                    (the textbook N+1-solve VCG).
  * ``warmstart`` — ONE residual-graph shortest path per matched request:
                    W(C\\{j}) = (W(C) - w_ij) + max(0, -SP_cost(G_f - j)).
                    This is the paper's Hershberger-Suri-style reoptimization
                    and is validated against ``naive`` in tests.

The oracle keeps no persistent duals, so it neither accepts warm-start
seeds nor batches (``supports_warm_start = supports_batch = False``); its
certificate is exactly 0.

It runs on the host like the reference's.  Its ``solve`` takes the
``device=`` keyword every backend of the port receives from
``core/auction.py`` and moves nothing.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.mcmf import (FlowNetwork, residual_shortest_path,
                             solve_min_cost_flow)
from repro_torch.core.solvers.base import (AuctionResult, sequential_solve_batch)

__all__ = ["solve_allocation", "McmfBackend"]


def _build_network(w: np.ndarray, caps):
    n, m = w.shape
    s, t = n + m, n + m + 1
    g = FlowNetwork(n + m + 2)
    req_edges = []
    for j in range(n):
        req_edges.append(g.add_edge(s, j, 1.0, 0.0))
    match_edges = {}
    for j in range(n):
        for i in range(m):
            if w[j, i] > 0:
                match_edges[(j, i)] = g.add_edge(j, n + i, 1.0, -float(w[j, i]))
    sink_edges = [g.add_edge(n + i, t, float(caps[i]), 0.0) for i in range(m)]
    g.match_edges = match_edges
    g.sink_edges = sink_edges
    return g, s, t, match_edges


def solve_allocation(w: np.ndarray, caps) -> tuple[list, float, FlowNetwork]:
    """Max-weight b-matching via MCMF. Returns (assignment, welfare, residual)."""
    n, m = w.shape
    g, s, t, match_edges = _build_network(w, caps)
    flow, cost, _pot = solve_min_cost_flow(g, s, t)
    assignment = [-1] * n
    for (j, i), eid in match_edges.items():
        if g.cap[eid] <= 1e-9:  # saturated forward edge = matched
            assignment[j] = i
    return assignment, -cost, g


def _welfare_without(w: np.ndarray, caps, j: int) -> float:
    w2 = np.delete(w, j, axis=0)
    _, wf, _ = solve_allocation(w2, caps)
    return wf


def _cancel_unit(g: FlowNetwork, s: int, j: int, agent_node: int, t: int):
    """Remove one unit of flow along s->j->agent->t in a residual network."""
    def _undo(u, v):
        for eid in g.adj[u]:
            if g.to[eid] == v and eid % 2 == 0 and g.cap[eid ^ 1] > 1e-12:
                g.cap[eid] += 1.0
                g.cap[eid ^ 1] -= 1.0
                return True
        return False

    assert _undo(s, j), "request j was not matched"
    assert _undo(j, agent_node), "no flow j->i"
    assert _undo(agent_node, t), "no flow i->t"


class McmfBackend:
    """The exact oracle backend (see module docstring)."""

    name = "mcmf"
    supports_warm_start = False
    supports_batch = False

    def solve(self, w, costs, caps, *, payment_mode: str = "warmstart",
              start_prices=None, device="cpu") -> AuctionResult:
        """Exact allocation + per-request VCG payments (Eq. 7 + Eq. 8), on
        the host whatever ``device`` says."""
        w = np.asarray(w, dtype=np.float64)
        costs = np.asarray(costs, dtype=np.float64)
        n, m = w.shape
        assignment, welfare, gf = solve_allocation(w, caps)

        payments = [0.0] * n
        n_resolves = 0
        for j, i in enumerate(assignment):
            if i < 0:
                continue
            w_ij = w[j, i]
            c_ij = float(costs[j, i])
            if payment_mode == "naive":
                w_without = _welfare_without(w, caps, j)
                n_resolves += 1
            else:
                # warmstart: cancel j's unit; the only NEW residual capacity
                # is one unit on (agent i -> t). The optimum without j
                # improves over (W - w_ij) by at most one augmenting walk
                # that consumes that unit: either a path s~>i->t (a displaced
                # request gets matched) or a cycle t~>i->t (an existing match
                # reroutes onto agent i).
                g2 = gf.clone()
                s, t = n + m, n + m + 1
                _cancel_unit(g2, s, j, n + i, t)
                # block the i->t arc itself (both directions): the improving
                # walk ends there conceptually; traversing it mid-walk would
                # re-use the single freed unit and creates negative cycles
                # for BF.
                sink_eid = gf.sink_edges[i]
                be = {sink_eid, sink_eid ^ 1}
                d_s, _ = residual_shortest_path(g2, s, n + i, blocked={j},
                                                blocked_edges=be)
                d_t, _ = residual_shortest_path(g2, t, n + i, blocked={j},
                                                blocked_edges=be)
                d = min(d_s, d_t)
                gain = max(0.0, -d) if d != float("inf") else 0.0
                w_without = (welfare - w_ij) + gain
            # Eq. 8: p_j = W(C\{j}) - (W(C) - w_ij) + c_ij
            payments[j] = w_without - (welfare - w_ij) + c_ij

        return AuctionResult(
            assignment=assignment, welfare=welfare, payments=payments,
            weights=w, costs=costs,
            solver_stats={"solver": "mcmf", "payment_mode": payment_mode,
                          "resolves": n_resolves},
        )

    def solve_batch(self, ws, costs_list, caps_list, *,
                    payment_mode: str = "warmstart", start_prices_list=None,
                    device="cpu") -> list[AuctionResult]:
        """Sequential per-market solves (the oracle has no batched form)."""
        return sequential_solve_batch(
            self, ws, costs_list, caps_list, payment_mode=payment_mode,
            start_prices_list=start_prices_list, device=device)

    def certificate(self, result: AuctionResult) -> float:
        """The oracle is exact: certified gap 0."""
        return 0.0
