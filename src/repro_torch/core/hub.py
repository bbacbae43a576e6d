"""Proxy-hub architecture (§4.4): a-priori agent clustering + coarse routing.

Agents are clustered on static capability signals (domain specialization,
model scale); requests are routed to a hub with a lightweight domain
classifier; the fine-grained IEMAS auction then runs inside the hub only.
This bounds the Phase-2 problem size (Fig. 6) and reduces the agent
heterogeneity that drives Green-Laffont IR violations (Appendix B.1).

Clustering signals
------------------
``cluster_agents`` partitions on *static, published* metadata only — an
agent's primary domain tag (the paper's choice), its model scale, or
nothing (random control).  Nothing per-request enters the partition, so
hubs are stable across batches; that stability is what makes cross-round
slot-price warm starts (``SlotPriceBook``) sound.

Hub routing contract
--------------------
``route_to_hub`` is the coarse classifier in front of the per-hub auction:
every request lands in EXACTLY ONE hub, chosen by domain overlap with the
hub's members, with published free capacity and hub size as tie-breakers.
The fine-grained Phase-2 matching then sees only that hub's block of the
(requests × agents) welfare matrix, and the hub blocks are disjoint — so
per-hub auctions compose into a global matching with no slot double-spend
(the splice is exact; only cross-hub edges are forfeited, which is the
measured welfare-vs-speedup trade of Fig. 6).

Worked example
--------------
>>> from repro_torch.core.hub import cluster_agents, route_to_hub
>>> domains = [("code",), ("code",), ("math",), ("math",)]
>>> hubs = cluster_agents(domains, [7.0, 4.0, 7.0, 4.0], k=2)
>>> sorted(sorted(h.agent_indices) for h in hubs)
[[0, 1], [2, 3]]
>>> hubs[route_to_hub("math", hubs, domains)].domains
('math',)
"""
from __future__ import annotations

from dataclasses import dataclass, field

import zlib

import numpy as np


@dataclass
class Hub:
    """One proxy hub: a stable subset of agents plus published metadata."""

    hub_id: int
    agent_indices: list[int]
    domains: tuple[str, ...] = ()

    # periodically published, privacy-preserving metadata (§4.4)
    published: dict[str, float] = field(default_factory=dict)

    def publish(self, *, price_signal: float, free_capacity: int,
                cache_sessions: int) -> None:
        """Refresh the hub's published summary (price/capacity/cache)."""
        self.published = {
            "price_signal": price_signal,
            "free_capacity": free_capacity,
            "cache_sessions": cache_sessions,
        }


def cluster_agents(agent_domains: list[tuple[str, ...]],
                   agent_scales: list[float], k: int,
                   scheme: str = "domain", seed: int = 0) -> list[Hub]:
    """Partition agents into k hubs.

    schemes: ``domain`` (group by primary specialization — the paper's
    choice), ``scale`` (by model-size quantiles), ``random``.
    """
    m = len(agent_domains)
    k = max(1, min(k, m))
    rng = np.random.default_rng(seed)
    if scheme == "random":
        perm = rng.permutation(m)
        parts = np.array_split(perm, k)
        return [Hub(h, sorted(int(i) for i in p)) for h, p in enumerate(parts)]
    if scheme == "scale":
        order = np.argsort(np.asarray(agent_scales, dtype=float))
        parts = np.array_split(order, k)
        return [Hub(h, sorted(int(i) for i in p)) for h, p in enumerate(parts)]
    # domain scheme: hash primary domain into k buckets, then balance
    buckets: dict[int, list[int]] = {h: [] for h in range(k)}
    domains_of: dict[int, set[str]] = {h: set() for h in range(k)}
    order = sorted(range(m), key=lambda i: (agent_domains[i][0] if agent_domains[i] else "", i))
    for i in order:
        primary = agent_domains[i][0] if agent_domains[i] else ""
        h = zlib.crc32(primary.encode()) % k
        # balance: spill to the smallest bucket when 2x over average
        if len(buckets[h]) >= 2 * max(1, m // k):
            h = min(buckets, key=lambda b: len(buckets[b]))
        buckets[h].append(i)
        domains_of[h].update(agent_domains[i])
    hubs = [Hub(h, sorted(buckets[h]), tuple(sorted(domains_of[h])))
            for h in range(k) if buckets[h]]
    return hubs


def route_to_hub(request_domain: str, hubs: list[Hub],
                 agent_domains: list[tuple[str, ...]]) -> int:
    """Coarse-grained classifier: pick the hub with the best domain overlap;
    ties broken by published free capacity then hub size."""
    best, best_score = 0, -1.0
    for idx, hub in enumerate(hubs):
        match = sum(1 for i in hub.agent_indices
                    if request_domain in agent_domains[i])
        score = match / max(1, len(hub.agent_indices))
        cap = hub.published.get("free_capacity", 0)
        score += 1e-3 * cap + 1e-6 * len(hub.agent_indices)
        if score > best_score:
            best, best_score = idx, score
    return best


class SlotPriceBook:
    """Cross-round warm-start state: each hub's final unit-price duals.

    The dense ε-scaling auction's duals (one price per capacity unit,
    ascending per agent) from round t are a near-equilibrium seed for round
    t+1 — the serving loop re-auctions statistically overlapping request
    sets.  Prices are stored *per agent* (an agent's units are
    interchangeable), so the book can re-assemble a seed for the next
    round's column layout even when per-agent free capacity or the batch
    size changed; units that did not exist last round seed at price 0,
    which is exactly the free-unit (λ = 0) boundary condition the solver
    maintains anyway.  Because each stored vector is ascending, truncating
    to a smaller unit count keeps exactly the CHEAPEST units — the ones a
    shrunken market still sells.

    Safety contract: a stored entry is only replayed when the elastic
    agent-set version (bumped by the router on every membership or hub
    rebuild — `repro_torch.distributed.elastic.AgentSetVersion`), the hub's exact
    live-agent tuple, AND the agents' published capacities all match.  Any
    mismatch — an agent joined, left, was quarantined, hubs were recut, or
    an agent's capacity b_i changed — is a cold start; warm-starting across
    a changed unit layout would seed prices onto the wrong goods (and a
    capacity change moves the equilibrium price of every unit the agent
    sells, so the old splits are stale even at matching membership).
    """

    def __init__(self) -> None:
        # hub_id -> (agent-set version, live agent ids, published
        #            capacities, per-agent ascending unit prices)
        self._book: dict[int, tuple[int, tuple[str, ...], tuple[int, ...],
                                    dict[str, np.ndarray]]] = {}
        self.warm_hits = 0
        self.cold_starts = 0
        self.stores = 0

    def lookup(self, hub_id: int, version: int, agent_ids: tuple[str, ...],
               caps: list[int], unit_counts: list[int]) -> np.ndarray | None:
        """Seed prices for this round's column layout, or None (cold start).

        ``caps[i]`` is agent ``agent_ids[i]``'s published capacity (the
        layout key — a capacity change invalidates the entry) and
        ``unit_counts[i]`` the number of units it exposes this round
        (``min(free capacity, batch size)`` — the
        `repro_torch.core.solvers.dense_common.column_counts` layout, agents
        contiguous in ``agent_ids`` order).
        """
        entry = self._book.get(hub_id)
        if entry is None or entry[0] != version \
                or entry[1] != tuple(agent_ids) \
                or entry[2] != tuple(int(c) for c in caps):
            self.cold_starts += 1
            return None
        per_agent = entry[3]
        segs = []
        for aid, count in zip(agent_ids, unit_counts):
            seg = np.zeros(int(count))
            prev = per_agent.get(aid)
            if prev is not None and count:
                take = min(int(count), len(prev))
                seg[:take] = prev[:take]    # ascending: cheapest units first
            segs.append(seg)
        self.warm_hits += 1
        return np.concatenate(segs) if segs else np.zeros(0)

    def store(self, hub_id: int, version: int, agent_ids: tuple[str, ...],
              caps: list[int], agent_prices) -> None:
        """Record a solve's final duals (``agent_prices[i]`` is agent i's
        ascending unit-price vector), keyed by the published capacities."""
        per_agent = {aid: np.sort(np.asarray(p, dtype=np.float64))
                     for aid, p in zip(agent_ids, agent_prices)}
        self._book[hub_id] = (version, tuple(agent_ids),
                              tuple(int(c) for c in caps), per_agent)
        self.stores += 1

    def posted_asks(self, hub_id: int, version: int,
                    agent_ids: tuple[str, ...], caps: list[int]
                    ) -> dict[str, np.ndarray] | None:
        """Standing per-agent ascending unit duals for incremental bidding.

        A mid-window arrival bids against these posted prices directly (its
        k-th provisional unit at agent i costs ``asks[aid][k]``).  Returns
        None when no fresh entry exists — same staleness contract as
        `lookup`, without consuming a warm-hit/cold-start counter (posted
        asks are read many times per window).
        """
        entry = self._book.get(hub_id)
        if entry is None or entry[0] != version \
                or entry[1] != tuple(agent_ids) \
                or entry[2] != tuple(int(c) for c in caps):
            return None
        return entry[3]

    def invalidate(self, hub_id: int | None = None) -> None:
        """Drop one hub's entry, or the whole book (hub_id=None)."""
        if hub_id is None:
            self._book.clear()
        else:
            self._book.pop(hub_id, None)

    def stats(self) -> dict[str, int]:
        """Warm-start effectiveness counters for telemetry/benchmarks."""
        return {"warm_hits": self.warm_hits, "cold_starts": self.cold_starts,
                "stores": self.stores, "hubs_tracked": len(self._book)}
