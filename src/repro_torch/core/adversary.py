"""Strategic-agent adversary layer (economic stress model).

IEMAS proves per-round DSIC for truthful, independent agents; a production
routing market faces strategic populations.  This module supplies them:
an ``AdversaryPolicy`` mutates only what an agent *reports* — its
published ``AgentInfo`` profile (Phase 0), its Phase-4 ``CompletionObs``
feedback — or its membership behavior (churn).  Ground-truth execution is
never touched: the cluster's ``RequestRecord`` keeps measured latency,
cost-at-true-prices and audited quality, so a run can price exactly what
each lie bought.

The audit channel: whenever any adversary is active, every report carries
``CompletionObs.audit_quality`` — the ground-truth evaluator score.  The
router settles value at the audited quality and feeds the inflation
residual ``max(0, reported - audited)`` into the agent's reputation
(`repro_torch.core.predictor`), which scales the Hoeffding w-blend so habitual
inflators see their predicted QoS (hence Eq.-1 value) decay instead of
poisoning the estimate.  An honest agent's residual is identically zero
and its reputation stays at exactly 1.0, which the blend multiplies
through bit-neutrally — adversary-free runs are bit-identical with or
without the audit channel.

Policies:

* ``CostMisreportPolicy``   — publishes deflated token prices, so the
  router's cost prior (and the costs it books) understate the truth and
  the cheater wins matches its real cost cannot justify.
* ``CollusionRingPolicy``   — a domain-clustered cartel publishing jointly
  inflated prices: each member's Clarke pivot is propped up by its
  ring-mates' inflated "next-best" costs.
* ``FreeRiderPolicy``       — inflates reported quality in Phase-4
  feedback while the audit channel carries the truth; reputation is the
  countermeasure under test.
* ``ChurnStormPolicy``      — membership/capacity/quarantine flapping that
  thrashes hub cuts and the ``SlotPriceBook`` (every flip must cold-start
  the warm-start cache; tests/test_churn_storm.py).

``AdversaryMix`` deterministically (seeded) assigns a policy to a fraction
of the fleet; ``fraction=0`` assigns nobody and leaves the run
bit-identical to an honest one.

A copy of the reference's `repro.core.adversary` over the port's mechanism
types; every draw is made in the reference's order.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np

from repro_torch.core.mechanism import AgentInfo, CompletionObs
from repro_torch.core.pricing import TokenPrices

#: policy names ``AdversaryMix`` accepts
POLICIES = ("misreport", "collusion", "freerider", "churn")


def _scaled_prices(prices: TokenPrices, factor: float) -> TokenPrices:
    """Uniformly rescaled token prices (a proportional price misreport)."""
    return TokenPrices(prices.miss * factor, prices.hit * factor,
                       prices.out * factor)


class AdversaryPolicy:
    """Base strategic policy: truthful, but wired into the audit channel.

    Subclasses override any of the three hooks; every hook mutates
    *reported* state only, never ground truth.
    """

    name = "honest"

    def publish(self, info: AgentInfo) -> AgentInfo:
        """The profile this agent reports to the router (true by default;
        overrides must return a copy, leaving the runtime's info intact)."""
        return info

    def report(self, obs: CompletionObs, true_quality: float) -> CompletionObs:
        """The Phase-4 feedback this agent reports.  The base policy reports
        truthfully but attaches the audited ground truth, so the settlement
        residual is exactly zero and reputation stays at exactly 1.0."""
        return dataclasses.replace(obs, audit_quality=float(true_quality))

    def tick(self, cluster, router, agent_id: str) -> None:
        """Per-round action hook (membership/capacity churn); no-op here."""


class CostMisreportPolicy(AdversaryPolicy):
    """Publishes token prices deflated by ``theta`` (reported capability
    misreport): the router's Eq.-6 cost prior and booked settlement costs
    understate the agent's true cost, buying matches honest pricing would
    lose.  The cluster keeps charging true prices in its ground-truth
    records, so the welfare gap is measurable."""

    name = "misreport"

    def __init__(self, theta: float = 0.4):
        self.theta = float(theta)

    def publish(self, info: AgentInfo) -> AgentInfo:
        """Deflate every published token price by ``1 - theta``."""
        return dataclasses.replace(
            info, prices=_scaled_prices(info.prices, 1.0 - self.theta))


class CollusionRingPolicy(AdversaryPolicy):
    """Domain-clustered cartel jointly inflating published prices by
    ``1 + theta``.  One shared instance serves every ring member: a
    member's Clarke pivot is computed against its ring-mates' inflated
    next-best costs, so the cartel extracts payments above the competitive
    level inside its domain hub."""

    name = "collusion"

    def __init__(self, theta: float = 0.4, members: tuple[str, ...] = ()):
        self.theta = float(theta)
        self.members = tuple(members)

    def publish(self, info: AgentInfo) -> AgentInfo:
        """Inflate every published token price by ``1 + theta``."""
        return dataclasses.replace(
            info, prices=_scaled_prices(info.prices, 1.0 + self.theta))


class FreeRiderPolicy(AdversaryPolicy):
    """Inflates reported quality by ``theta`` (clipped to 1.0) while the
    audit channel carries the evaluator's truth.  The inflation residual
    decays the agent's reputation, which scales its predicted quality —
    the reputation-weighted prior is the countermeasure under test."""

    name = "freerider"

    def __init__(self, theta: float = 0.4):
        self.theta = float(theta)

    def report(self, obs: CompletionObs, true_quality: float) -> CompletionObs:
        """Report ``min(1, quality + theta)``; audit carries the truth."""
        return dataclasses.replace(
            obs, quality=min(1.0, float(true_quality) + self.theta),
            audit_quality=float(true_quality))


class ChurnStormPolicy(AdversaryPolicy):
    """Membership flapping: every ``period`` ticks the agent takes one
    seeded action — flip its published capacity, leave and immediately
    rejoin (losing engine caches, recutting hubs), or self-quarantine for
    one cycle.  Each flip invalidates the ``SlotPriceBook`` warm-start key
    (capacity, membership, or agent-set version), so a storm of them
    stress-tests cold-start correctness and exactly-once settlement."""

    name = "churn"

    def __init__(self, theta: float = 0.4, period: int = 4, seed: int = 0):
        self.theta = float(theta)
        self.period = max(1, int(period))
        self.rng = np.random.default_rng(seed)
        self._ticks = 0
        self._quarantined = False

    def tick(self, cluster, router, agent_id: str) -> None:
        """One churn action every ``period`` ticks (see class docstring)."""
        self._ticks += 1
        if self._ticks % self.period:
            return
        if self._quarantined:
            router.reinstate(agent_id)
            self._quarantined = False
            return
        rt = cluster.agents.get(agent_id)
        if rt is None:
            return
        action = int(self.rng.integers(0, 3))
        if action == 0:
            # capacity flap on the profile the router prices with — the
            # price book's capacity staleness key must cold-start on it
            info = next((a for a in router.agents
                         if a.agent_id == agent_id), None)
            if info is not None:
                info.capacity = max(
                    1, info.capacity + int(self.rng.choice((-1, 1))))
        elif action == 1 and \
                cluster.telemetry.agent_inflight.get(agent_id, 0) == 0:
            # leave + rejoin: only when idle, so no completion is orphaned
            # against a runtime that no longer exists (the router-side
            # orphan guard covers the racing case regardless)
            profile = rt.profile
            cluster.remove_agent(agent_id, router)
            cluster.add_agent(profile, router)
        else:
            router.quarantine(agent_id)
            self._quarantined = True


@dataclass
class AdversaryMix:
    """Seeded assignment of one strategic policy to a fleet fraction.

    ``assign`` is deterministic in ``seed``; ``fraction=0`` returns an
    empty mapping, leaving the run bit-identical to an honest one.
    ``collusion``
    picks its ring from the largest shared-domain cluster so the cartel
    actually shares a hub; the other policies sample uniformly.
    """

    policy: str = "misreport"
    fraction: float = 0.25
    theta: float = 0.4
    seed: int = 0
    churn_period: int = 4

    def n_adversaries(self, n_agents: int) -> int:
        """Number of strategic agents at this fraction of ``n_agents``."""
        return int(round(self.fraction * n_agents))

    def assign(self, infos: list[AgentInfo]) -> dict[str, AdversaryPolicy]:
        """Deterministically map chosen agent ids to policy instances."""
        if self.policy not in POLICIES:
            raise ValueError(f"unknown adversary policy {self.policy!r}; "
                             f"known: {POLICIES}")
        k = self.n_adversaries(len(infos))
        if k <= 0:
            return {}
        if self.policy == "collusion":
            ring = self._domain_ring(infos, k)
            shared = CollusionRingPolicy(theta=self.theta, members=ring)
            return {aid: shared for aid in ring}
        rng = np.random.default_rng(self.seed)
        ids = [a.agent_id for a in infos]
        chosen = rng.choice(len(ids), size=k, replace=False)
        out: dict[str, AdversaryPolicy] = {}
        for j in sorted(int(c) for c in chosen):
            aid = ids[j]
            if self.policy == "misreport":
                out[aid] = CostMisreportPolicy(theta=self.theta)
            elif self.policy == "freerider":
                out[aid] = FreeRiderPolicy(theta=self.theta)
            else:
                out[aid] = ChurnStormPolicy(theta=self.theta,
                                            period=self.churn_period,
                                            seed=self.seed + j)
        return out

    def _domain_ring(self, infos: list[AgentInfo], k: int) -> tuple[str, ...]:
        """The ``k`` ring members, filled from the largest domain cluster
        outward (deterministic tie-break on domain name)."""
        by_dom: dict[str, list[str]] = {}
        for a in infos:
            for d in a.domains:
                by_dom.setdefault(d, []).append(a.agent_id)
        ring: list[str] = []
        for d in sorted(by_dom, key=lambda d: (-len(by_dom[d]), d)):
            for aid in by_dom[d]:
                if aid not in ring:
                    ring.append(aid)
                if len(ring) == k:
                    return tuple(ring)
        return tuple(ring)
