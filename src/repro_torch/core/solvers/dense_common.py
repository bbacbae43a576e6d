"""Shared machinery of the dense ε-scaling auction backends.

The port's staged backends (``dense-torch`` and ``cuda``) solve the same capacitated column
market (one column per agent holding a counter of ``min(b_i, n)`` unit
prices, requests bidding under ε-complementary slackness) and return the
same dual state; this module holds the pieces they share — the per-agent
column layout, the ε schedules and warm-start round budgets, the
:class:`DenseAuctionResult` dual-state record, the batched Clarke-pivot
payment solver, and the helpers that package a dense solve into the
registry-level :class:`~repro_torch.core.solvers.base.AuctionResult`.

Column market vs slot expansion
-------------------------------
Earlier revisions expanded every agent into ``min(b_i, n)`` explicit unit
slots, paying O(n·K) per bidding round with ``K = Σ min(b_i, n)``.  The
column market keeps one column per agent: a request's ask against agent i
is the agent's CHEAPEST unassigned-or-displaceable unit (the segment-min of
its unit-price vector), and a winning bid fills exactly one unit of the
counter.  Because all of an agent's slots carry identical weights, every
request in a slot-level round targets the same (cheapest) slot of its
favourite agent — so the column round is decision-identical to the
slot-expanded round while scanning O(n·m + K) instead of O(n·K).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.solvers.base import AuctionResult

THETA = 5.0
# warm solves skip the coarsest scaling phases (ε₀ = wmax/θ³ vs wmax/θ) and
# run under a bounded round budget; tripping it falls back to a cold solve
WARM_ROUNDS_PER_NODE = 40
WARM_ROUNDS_FLOOR = 2_000


class DenseAuctionResult:
    """Allocation + dual state of one dense-auction solve.

    ``agent_prices[i]`` is agent i's ascending unit-price vector (length
    ``unit_counts[i] = min(b_i, n)``): the duals of its capacity units,
    cheapest first.  The flat agent-major concatenation (``flat_prices``)
    is the warm-start wire format — units of one agent are interchangeable,
    so the ascending order is canonical and safe to reseed from.
    """

    __slots__ = ("assignment", "welfare", "agent_prices", "unit_counts",
                 "profits", "eps", "phases", "rounds", "gap_bound",
                 "warm_started", "fallback")

    def __init__(self, assignment, welfare, agent_prices, unit_counts,
                 profits, eps, phases, rounds, gap_bound, warm_started=False,
                 fallback=False):
        self.assignment = assignment        # request j -> agent index or -1
        self.welfare = welfare              # sum of matched w_ij
        self.agent_prices = agent_prices    # per-agent ascending unit duals
        self.unit_counts = unit_counts      # agent i -> min(b_i, n) units
        self.profits = profits              # per-request profit pi_j
        self.eps = eps                      # final epsilon
        self.phases = phases
        self.rounds = rounds                # total Jacobi bidding rounds
        self.gap_bound = gap_bound          # certified welfare gap (2*n*eps)
        self.warm_started = warm_started    # seeded from prior unit prices
        self.fallback = fallback            # warm attempt tripped -> re-ran cold

    @property
    def flat_prices(self) -> np.ndarray:
        """Agent-major flat concatenation of the per-agent price vectors."""
        if not len(self.agent_prices):
            return np.zeros(0)
        return np.concatenate([np.asarray(p, dtype=np.float64).ravel()
                               for p in self.agent_prices])


def column_counts(caps, n: int) -> np.ndarray:
    """Agent capacities -> per-agent unit counts (min(b_i, n) each)."""
    caps = np.asarray([int(c) for c in caps], dtype=np.int64)
    if (caps < 0).any():
        raise ValueError("negative capacity")
    return np.minimum(caps, n)


def warm_round_budget(n: int, K: int, max_rounds: int) -> int:
    """Round cap for a warm attempt before falling back to a cold solve."""
    return min(max_rounds, WARM_ROUNDS_PER_NODE * (n + K) + WARM_ROUNDS_FLOOR)


def warm_eps0(p0, wmax: float, eps_final: float,
              theta: float = THETA) -> float:
    """ε₀ for a warm attempt, scaled to how informative the seed is.

    The fine schedule (ε₀ = wmax/θ³, skipping the coarse scaling phases)
    only pays off when the seeded prices actually carry equilibrium signal
    worth protecting.  A seed that is ~zero everywhere (e.g. duals of units
    that never sold, or a spill market drawn mostly from idle donors) is
    indistinguishable from cold prices — running the fine schedule over it
    replaces a few coarse phases with long bidding wars and *costs* rounds.
    So: fine schedule iff the seed's price mass rises above the fine ε
    level; the coarse cold schedule otherwise (warm ≤ cold by construction).
    """
    fine = max(wmax / theta ** 3, eps_final)
    if float(np.asarray(p0).max(initial=0.0)) > fine:
        return fine
    return max(wmax / theta, eps_final)


def check_start_prices(start_prices, K: int, *, block: int | None = None
                       ) -> np.ndarray:
    """Validate a warm-start seed against this market's column layout.

    A seed of the wrong length means the caller is replaying duals from a
    DIFFERENT market (an agent's capacity changed, or the agent set moved
    under it) — silently clipping or padding such a seed re-anchors prices
    to the wrong units and costs correctness-adjacent rounds, so layout
    mismatches raise instead.  Negative entries are equally a layout bug
    (duals are non-negative by construction) and also raise.
    """
    p0 = np.asarray(start_prices, dtype=np.float64)
    where = f"start_prices for block {block}: " if block is not None \
        else "start_prices "
    if p0.shape != (int(K),):
        raise ValueError(f"{where}shape {p0.shape} does not match the "
                         f"column layout ({K},) for this (caps, n)")
    if (p0 < 0.0).any():
        raise ValueError(f"{where}contains negative prices; unit duals are "
                         "non-negative, a negative seed means the layout "
                         "is stale")
    return p0


def float32_eps_final(wmax: float, dtype) -> float:
    """Resolution-bounded ε_final for reduced-precision (float32) solves
    (the reference's ``jax_eps_final``)."""
    # ε (and the ε/8 slack) must stay well above one ulp at price
    # magnitude or CS tests cycle on rounding noise
    ulp = float(np.finfo(dtype).eps) * max(wmax, 1.0)
    return max(1e-5 * max(wmax, 1.0), 64.0 * ulp)


def _price_grid(flat, counts, cmax: int) -> np.ndarray:
    """Flat agent-major seed -> (m, cmax) unit-price grid (agent i's seed
    segment fills its units 0..count_i-1 in the given order)."""
    m = len(counts)
    grid = np.zeros((m, cmax), dtype=np.float64)
    pos = 0
    for i, c in enumerate(counts):
        c = int(c)
        grid[i, :c] = flat[pos:pos + c]
        pos += c
    return grid


def empty_result(n: int, counts) -> DenseAuctionResult:
    """The trivial result for a degenerate market (no requests/units/edges)."""
    counts = np.asarray(counts, dtype=np.int64)
    return DenseAuctionResult(
        [-1] * n, 0.0, [np.zeros(int(c)) for c in counts], counts,
        np.zeros(n), 0.0, 0, 0, 0.0)


def materialize_staged(w_np, counts, unit_price, agent_of, unit_of, rounds,
                       eps_final, *, warm_started=False, fallback=False
                       ) -> DenseAuctionResult:
    """Host-side DenseAuctionResult from one staged column solve's state.

    ``unit_price`` is the (m, cmax) unit-price grid (garbage beyond each
    agent's count), ``agent_of``/``unit_of`` the per-request assignment.
    """
    n = w_np.shape[0]
    counts = np.asarray(counts, dtype=np.int64)
    agent_of = np.asarray(agent_of)
    unit_of = np.asarray(unit_of)
    grid = np.asarray(unit_price, dtype=np.float64)
    rows = np.arange(n)
    assigned = agent_of >= 0
    ai = np.maximum(agent_of, 0)
    welfare = float(np.where(assigned, w_np[rows, ai], 0.0).sum())
    profits = np.where(
        assigned,
        np.maximum(w_np, 0.0)[rows, ai] - grid[ai, np.maximum(unit_of, 0)],
        0.0)
    agent_prices = [np.sort(grid[i, :int(c)]) for i, c in enumerate(counts)]
    return DenseAuctionResult(
        [int(a) for a in agent_of], welfare, agent_prices, counts, profits,
        float(eps_final), -1, int(rounds), 2.0 * n * float(eps_final),
        warm_started=warm_started, fallback=fallback)


def dense_stats(solver: str, res: DenseAuctionResult) -> dict:
    """The ``solver_stats`` dict a dense backend attaches to its result."""
    return {"solver": solver, "payment_mode": "dual-batched",
            "phases": res.phases, "rounds": res.rounds,
            "eps": res.eps, "gap_bound": res.gap_bound,
            "agent_prices": res.agent_prices, "unit_counts": res.unit_counts,
            "warm_started": res.warm_started, "warm_fallback": res.fallback}


def package_dense(solver: str, w: np.ndarray, costs: np.ndarray, caps,
                  res: DenseAuctionResult) -> AuctionResult:
    """DenseAuctionResult -> AuctionResult: batched Clarke payments + stats."""
    payments = dense_clarke_payments(w, costs, caps, res.assignment)
    return AuctionResult(
        assignment=list(res.assignment), welfare=res.welfare,
        payments=payments, weights=w, costs=costs,
        solver_stats=dense_stats(solver, res))


# --------------------------------------------------------------------------
# Batched Clarke-pivot payments from the final matching.
# --------------------------------------------------------------------------
def dense_clarke_payments(w: np.ndarray, costs: np.ndarray, caps,
                          assignment) -> list:
    """p_j = c_ij + max(0, -d_j) for matched j, where d_j is the cheapest
    residual walk absorbing the unit freed by removing request j — all
    matched requests solved at once by one batched Bellman-Ford.

    Mirrors the mcmf backend's ``payment_mode="warmstart"``: per batch member
    b, request j_b's node is blocked and agent i_b's sink arc is blocked; the
    target distance is min(dist_from_s[i_b], dist_from_t[i_b]).

    Contract: ``assignment`` must be (near-)welfare-optimal — the residual
    graph of an optimal matching has no negative cycles, which is what makes
    the iteration-capped Bellman-Ford exact. On an ε-optimal matching the
    error is bounded by (n+m+3)·2n·ε; the port's float32 staged solvers'
    payments are approximate to their reported gap_bound (as the
    reference's float32 staged paths are).
    """
    w = np.asarray(w, dtype=np.float64)
    costs = np.asarray(costs, dtype=np.float64)
    n, m = w.shape
    caps_arr = np.asarray([int(c) for c in caps], dtype=np.int64)
    payments = [0.0] * n
    matched = [j for j, i in enumerate(assignment) if i >= 0]
    if not matched:
        return payments
    B = len(matched)
    j_blk = np.asarray(matched)
    i_blk = np.asarray([assignment[j] for j in matched])

    X = np.zeros((n, m), dtype=bool)
    for j, i in enumerate(assignment):
        if i >= 0:
            X[j, i] = True
    used = X.sum(axis=0)
    row_matched = X.any(axis=1)
    mi = np.where(row_matched, np.argmax(X, axis=1), -1)   # agent of request
    inf = np.inf
    # forward matching arcs j -> i: cost -w where an unused edge exists
    Cf = np.where((w > 0) & ~X, -w, inf)                    # (n, m)
    # backward arcs i -> j (undo match): cost +w on matched pairs
    w_back = np.where(row_matched, w[np.arange(n), np.maximum(mi, 0)], inf)
    has_free = used < caps_arr                              # i -> t arcs
    has_flow = used > 0                                     # t -> i arcs
    brange = np.arange(B)

    def _bf(from_t: bool) -> np.ndarray:
        """Batched Bellman-Ford; returns dist-to-agent matrix (B, m)."""
        D_req = np.full((B, n), inf)
        D_ag = np.full((B, m), inf)
        D_s = np.full(B, 0.0 if not from_t else inf)
        D_t = np.full(B, 0.0 if from_t else inf)
        for _ in range(n + m + 3):
            changed = False
            # s -> j' (unmatched rows, cost 0)
            upd = np.where(~row_matched[None, :], D_s[:, None], inf)
            # i -> j' (matched rows, cost +w)
            upd_b = np.where(row_matched[None, :],
                             D_ag[:, np.maximum(mi, 0)] + w_back[None, :], inf)
            upd = np.minimum(upd, upd_b)
            upd[brange, j_blk] = inf                        # blocked request
            new = np.minimum(D_req, upd)
            changed |= (new < D_req).any()
            D_req = new
            # j' -> i (forward, cost -w): the big dense relaxation
            upd = (D_req[:, :, None] + Cf[None, :, :]).min(axis=1)
            # t -> i (cost 0) where flow exists, minus the blocked sink arc
            upd_t = np.where(has_flow[None, :], D_t[:, None], inf)
            upd_t[brange, i_blk] = inf
            new = np.minimum(D_ag, np.minimum(upd, upd_t))
            changed |= (new < D_ag).any()
            D_ag = new
            # i -> t (cost 0) where free capacity, minus the blocked sink arc
            cand = np.where(has_free[None, :], D_ag, inf)
            cand[brange, i_blk] = inf
            new = np.minimum(D_t, cand.min(axis=1))
            changed |= (new < D_t).any()
            D_t = new
            # j' -> s (matched rows, cost 0)
            cand = np.where(row_matched[None, :], D_req, inf)
            new = np.minimum(D_s, cand.min(axis=1))
            changed |= (new < D_s).any()
            D_s = new
            if not changed:
                break
        return D_ag

    d = np.minimum(_bf(from_t=False)[brange, i_blk],
                   _bf(from_t=True)[brange, i_blk])
    gain = np.where(np.isfinite(d), np.maximum(0.0, -d), 0.0)
    for b, j in enumerate(matched):
        payments[j] = float(gain[b] + costs[j, assignment[j]])
    return payments
