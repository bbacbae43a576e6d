"""Baseline routers with the same interface & information set as IEMAS.

The paper compares against learned routers (GraphRouter, GMTRouter,
MFRouter, RouterDC) trained offline on logged preference data that is not
reproducible here; these stand-ins learn ONLINE from the same telemetry
IEMAS sees. ``RandomRouter`` is exact per the paper.

All baselines respect agent capacity (skip full agents) and implement
``route_batch`` / ``on_complete`` so the cluster driver treats every policy
identically.  They run on the host, as the reference's do (a copy of
`repro.core.baselines` over the port's ledger and mechanism types).
"""
from __future__ import annotations

import math
from collections import defaultdict

import numpy as np

from repro_torch.core.affinity import PrefixLedger
from repro_torch.core.mechanism import AgentInfo, CompletionObs, Request, RouteDecision
from repro_torch.core.pricing import observed_cost


class _BaseRouter:
    name = "base"

    def __init__(self, agents: list[AgentInfo], seed: int = 0):
        self.agents = list(agents)
        self.rng = np.random.default_rng(seed)
        self._pending: dict[str, AgentInfo] = {}
        self.accounts = defaultdict(float)

    def _free_agents(self, free_slots):
        out = []
        for a in self.agents:
            if (free_slots or {}).get(a.agent_id, a.capacity) > 0:
                out.append(a)
        return out

    def _decide(self, requests, pick, free_slots):
        decisions = []
        remaining = {a.agent_id: (free_slots or {}).get(a.agent_id, a.capacity)
                     for a in self.agents}
        for r in requests:
            cands = [a for a in self.agents if remaining[a.agent_id] > 0]
            agent = pick(r, cands) if cands else None
            if agent is None:
                decisions.append(RouteDecision(r, None, 0.0, None, 0.0, 0))
                continue
            remaining[agent.agent_id] -= 1
            self._pending[r.request_id] = (agent, r)
            decisions.append(RouteDecision(r, agent.agent_id, 0.0, None, 0.0, 0))
        return decisions

    def on_complete(self, request_id: str, obs: CompletionObs) -> None:
        entry = self._pending.pop(request_id, None)
        if entry is None:
            return
        agent, req = entry
        cost = observed_cost(agent.prices, obs.n_prompt, obs.n_hit, obs.n_gen)
        self.accounts["agent_costs"] += cost
        self._learn(agent, req, obs, cost)

    def _learn(self, agent, req, obs, cost):
        pass


class RandomRouter(_BaseRouter):
    """Uniform random routing (paper's Random baseline)."""
    name = "random"

    def route_batch(self, requests, telemetry, free_slots=None):
        """Assign each request to a uniformly random non-full agent."""
        return self._decide(
            requests, lambda r, cands: cands[self.rng.integers(len(cands))],
            free_slots)


class RoundRobinRouter(_BaseRouter):
    """Cycle through agents in order, skipping full ones."""

    name = "roundrobin"

    def __init__(self, agents, seed=0):
        super().__init__(agents, seed)
        self._next = 0

    def route_batch(self, requests, telemetry, free_slots=None):
        """Assign requests round-robin over the non-full agents."""
        def pick(r, cands):
            a = cands[self._next % len(cands)]
            self._next += 1
            return a
        return self._decide(requests, pick, free_slots)


class LeastLoadedRouter(_BaseRouter):
    """Classic load balancing — the paper's 'naive load balancing destroys
    cache locality' strawman."""
    name = "leastloaded"

    def route_batch(self, requests, telemetry, free_slots=None):
        """Assign each request to the least-utilized agent."""
        inflight = telemetry.get("agent_inflight", {})

        def pick(r, cands):
            return min(cands, key=lambda a: (inflight.get(a.agent_id, 0)
                                             / max(1, a.capacity),
                                             a.agent_id))
        return self._decide(requests, pick, free_slots)


class GreedyAffinityRouter(_BaseRouter):
    """Cache-affinity-first routing WITHOUT the auction (mechanism ablation):
    session stickiness, ties broken by load."""
    name = "greedyaffinity"

    def __init__(self, agents, seed=0):
        super().__init__(agents, seed)
        self.ledger = PrefixLedger()

    def route_batch(self, requests, telemetry, free_slots=None):
        """Assign each request to its best (affinity, domain, load) score."""
        inflight = telemetry.get("agent_inflight", {})

        def pick(r, cands):
            scored = []
            for a in cands:
                o = self.ledger.affinity(a.agent_id, r.dialogue_id, r.tokens,
                                         extension_only=a.recurrent)
                load = inflight.get(a.agent_id, 0) / max(1, a.capacity)
                dom = 0.1 * (r.domain in a.domains)
                scored.append((o + dom - 0.05 * load, a))
            return max(scored, key=lambda t: t[0])[1]
        return self._decide(requests, pick, free_slots)

    def _learn(self, agent, req, obs, cost):
        self.ledger.update(agent.agent_id, req.dialogue_id, req.tokens)


class BanditRouter(_BaseRouter):
    """UCB1 over (domain, agent) reward = quality - lambda*cost - mu*latency.
    Stand-in for learned per-query routers (MFRouter/RouterDC class)."""
    name = "bandit"

    def __init__(self, agents, seed=0, lam=0.02, mu=0.5):
        super().__init__(agents, seed)
        self.lam, self.mu = lam, mu
        self.stats = defaultdict(lambda: [0, 0.0])  # (domain, agent) -> [n, sum]
        self.total = 0

    def route_batch(self, requests, telemetry, free_slots=None):
        """Assign each request to the UCB1-optimal (domain, agent) arm."""
        def pick(r, cands):
            best, best_u = None, -math.inf
            for a in cands:
                n, s = self.stats[(r.domain, a.agent_id)]
                if n == 0:
                    u = math.inf  # explore
                else:
                    u = s / n + math.sqrt(2 * math.log(max(2, self.total)) / n)
                if u > best_u:
                    best, best_u = a, u
            return best
        return self._decide(requests, pick, free_slots)

    def _learn(self, agent, req, obs, cost):
        reward = obs.quality - self.lam * cost - self.mu * obs.latency
        st = self.stats[(req.domain, agent.agent_id)]
        st[0] += 1
        st[1] += reward
        self.total += 1


class EwmaScoreRouter(_BaseRouter):
    """Softmax over EWMA utility scores per (domain, agent) — stand-in for
    embedding-similarity routers (GraphRouter/GMTRouter class)."""
    name = "ewmascore"

    def __init__(self, agents, seed=0, lam=0.02, mu=0.5, temp=0.15,
                 alpha=0.2):
        super().__init__(agents, seed)
        self.lam, self.mu, self.temp, self.alpha = lam, mu, temp, alpha
        self.score = defaultdict(float)

    def route_batch(self, requests, telemetry, free_slots=None):
        """Sample each request's agent from the softmaxed EWMA scores."""
        def pick(r, cands):
            s = np.array([self.score[(r.domain, a.agent_id)] for a in cands])
            p = np.exp((s - s.max()) / self.temp)
            p /= p.sum()
            return cands[self.rng.choice(len(cands), p=p)]
        return self._decide(requests, pick, free_slots)

    def _learn(self, agent, req, obs, cost):
        reward = obs.quality - self.lam * cost - self.mu * obs.latency
        key = (req.domain, agent.agent_id)
        self.score[key] = (1 - self.alpha) * self.score[key] + self.alpha * reward


class GraphSchedulerRouter(_BaseRouter):
    """Affinity-blind workflow-graph scheduler — the dag_routing baseline.

    What a classic DAG scheduler (HEFT-style list scheduling) does when
    dropped into an agent marketplace: it sees the precedence structure
    (the simulator only hands it ready steps) and places each one by
    skill match, then load, then hardware scale — but it is blind to KV
    prefix state, so a handoff step lands wherever the queue is shortest
    and the producer's cached context is re-prefilled from scratch.  The
    gap to IEMAS's precedence-aware affinity auction is what a DAG
    workload served by both routers shows.
    """

    name = "graphsched"

    def route_batch(self, requests, telemetry, free_slots=None):
        """Assign each ready step by (domain match, load, -scale)."""
        inflight = telemetry.get("agent_inflight", {})

        def pick(r, cands):
            return min(cands, key=lambda a: (
                0 if r.domain in a.domains else 1,
                inflight.get(a.agent_id, 0) / max(1, a.capacity),
                -a.scale, a.agent_id))
        return self._decide(requests, pick, free_slots)


BASELINES = {
    c.name: c for c in (RandomRouter, RoundRobinRouter, LeastLoadedRouter,
                        GreedyAffinityRouter, BanditRouter, EwmaScoreRouter,
                        GraphSchedulerRouter)
}
