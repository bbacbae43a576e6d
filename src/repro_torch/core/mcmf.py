"""Min-cost max-flow via successive shortest paths (Johnson potentials).

Dependency-free (the paper's Appendix C.2.4 ships the same design: Bellman-
Ford potentials to absorb negative edge costs + Dijkstra augmentations).

Used by the auction layer as a *welfare maximizer*: with matching edges of
cost -w_ij (w_ij > 0 only), augmentation stops when the shortest residual
path has non-negative cost, which yields the min-cost flow over ALL flow
values = the max-weight b-matching (Theorem 4.1 / Hoffman-Kruskal).

Also provides the warm-start counterfactual solver used for VCG payments
(§4.3 "computational consistency"): W(C \\ {j}) from ONE Dijkstra on the
residual graph instead of a full re-solve.
"""
from __future__ import annotations

import heapq
import math


class FlowNetwork:
    """Residual flow network in paired-edge (forward, reverse) layout."""

    def __init__(self, n: int):
        self.n = n
        self.to: list[int] = []
        self.cap: list[float] = []
        self.cost: list[float] = []
        self.adj: list[list[int]] = [[] for _ in range(n)]

    def add_edge(self, u: int, v: int, cap: float, cost: float) -> int:
        """Add a u->v arc (and its zero-cap reverse); returns the edge id."""
        eid = len(self.to)
        self.to.append(v); self.cap.append(cap); self.cost.append(cost)
        self.adj[u].append(eid)
        self.to.append(u); self.cap.append(0.0); self.cost.append(-cost)
        self.adj[v].append(eid + 1)
        return eid

    def clone(self) -> "FlowNetwork":
        """Deep copy (for counterfactual re-solves on the residual graph)."""
        g = FlowNetwork(self.n)
        g.to = list(self.to); g.cap = list(self.cap); g.cost = list(self.cost)
        g.adj = [list(a) for a in self.adj]
        return g


def _bellman_ford_dag_potentials(g: FlowNetwork, s: int) -> list[float]:
    """Initial potentials: Bellman-Ford (queue-based SPFA, terminates for any
    graph without negative cycles; our auction graphs are DAGs)."""
    inf = math.inf
    dist = [inf] * g.n
    dist[s] = 0.0
    inq = [False] * g.n
    from collections import deque
    q = deque([s]); inq[s] = True
    while q:
        u = q.popleft(); inq[u] = False
        for eid in g.adj[u]:
            if g.cap[eid] <= 1e-12:
                continue
            v = g.to[eid]
            nd = dist[u] + g.cost[eid]
            if nd < dist[v] - 1e-12:
                dist[v] = nd
                if not inq[v]:
                    q.append(v); inq[v] = True
    return dist


def _dijkstra(g: FlowNetwork, s: int, t: int, pot: list[float]):
    """Shortest path with reduced costs. Returns (dist, parent_edge)."""
    inf = math.inf
    dist = [inf] * g.n
    parent = [-1] * g.n
    dist[s] = 0.0
    pq = [(0.0, s)]
    while pq:
        d, u = heapq.heappop(pq)
        if d > dist[u] + 1e-12:
            continue
        for eid in g.adj[u]:
            if g.cap[eid] <= 1e-12:
                continue
            v = g.to[eid]
            if pot[u] == inf:
                continue
            w = g.cost[eid] + pot[u] - (pot[v] if pot[v] != inf else 0.0)
            if w < -1e-7:
                w = 0.0  # clamp tiny negatives from float noise
            nd = d + w
            if nd < dist[v] - 1e-12:
                dist[v] = nd
                parent[v] = eid
                heapq.heappush(pq, (nd, v))
    return dist, parent


def solve_min_cost_flow(g: FlowNetwork, s: int, t: int,
                        stop_when_positive: bool = True):
    """Successive shortest paths. Mutates g (flow stored in caps).

    Returns (flow, cost, potentials). With ``stop_when_positive`` the result
    is the global min-cost flow over all flow values (= welfare maximum for
    negated-welfare edge costs).
    """
    inf = math.inf
    pot = _bellman_ford_dag_potentials(g, s)
    flow, cost = 0.0, 0.0
    while True:
        dist, parent = _dijkstra(g, s, t, pot)
        if dist[t] == inf:
            break
        # true path cost = reduced dist + pot[t] - pot[s]
        true_cost = dist[t] + (pot[t] if pot[t] != inf else 0.0) - pot[s]
        if stop_when_positive and true_cost >= -1e-12:
            break
        # update potentials
        for v in range(g.n):
            if dist[v] != inf and pot[v] != inf:
                pot[v] += dist[v]
        # bottleneck
        push = inf
        v = t
        while v != s:
            eid = parent[v]
            push = min(push, g.cap[eid])
            v = g.to[eid ^ 1]
        v = t
        while v != s:
            eid = parent[v]
            g.cap[eid] -= push
            g.cap[eid ^ 1] += push
            cost += push * g.cost[eid]
            v = g.to[eid ^ 1]
        flow += push
    return flow, cost, pot


def residual_shortest_path(g: FlowNetwork, s: int, t: int,
                           blocked: set[int] | None = None,
                           blocked_edges: set[int] | None = None):
    """(cost, parent_edges) of the cheapest residual s->t path, skipping
    ``blocked`` nodes and ``blocked_edges`` (edge ids, both directions).
    Bellman-Ford based; callers must ensure the explored subgraph has no
    negative cycles (see auction.run_auction warmstart). +inf if unreachable."""
    inf = math.inf
    dist = [inf] * g.n
    parent = [-1] * g.n
    dist[s] = 0.0
    from collections import deque
    q = deque([s])
    inq = [False] * g.n
    inq[s] = True
    blocked = blocked or set()
    blocked_edges = blocked_edges or set()
    while q:
        u = q.popleft(); inq[u] = False
        for eid in g.adj[u]:
            if g.cap[eid] <= 1e-12 or eid in blocked_edges:
                continue
            v = g.to[eid]
            if v in blocked:
                continue
            nd = dist[u] + g.cost[eid]
            if nd < dist[v] - 1e-9:
                dist[v] = nd
                parent[v] = eid
                if not inq[v]:
                    q.append(v); inq[v] = True
    return dist[t], parent


def augment_unit(g: FlowNetwork, s: int, t: int, parent) -> None:
    """Push one unit of flow along a parent-edge path t<-...<-s."""
    v = t
    while v != s:
        eid = parent[v]
        g.cap[eid] -= 1.0
        g.cap[eid ^ 1] += 1.0
        v = g.to[eid ^ 1]


def brute_force_matching(w: "list[list[float]]", caps: "list[int]"):
    """Exact max-weight b-matching by exhaustive search (test oracle).

    w[j][i] = welfare of assigning request j to agent i (<=0 means no edge).
    Returns (best_welfare, assignment list with -1 for unmatched).
    """
    n = len(w)
    m = len(caps) if caps else 0
    best = [0.0, [-1] * n]

    def rec(j, used, cur, assign):
        if j == n:
            if cur > best[0] + 1e-12:
                best[0] = cur
                best[1] = list(assign)
            return
        # option: leave j unmatched
        rec(j + 1, used, cur, assign + [-1])
        for i in range(m):
            if used[i] < caps[i] and w[j][i] > 0:
                used[i] += 1
                rec(j + 1, used, cur + w[j][i], assign + [i])
                used[i] -= 1

    rec(0, [0] * m, 0.0, [])
    return best[0], best[1]
