"""Online QoS prediction (§4.1): per-agent Hoeffding trees over Eq. 5 features.

    x_ij = (|p_j|, t_j, o_ij, I_r, R_r, I_i, R_i, B_i, u_i, xi_j)

Latency and cost use HoeffdingTreeRegressor; quality ("performance") uses
HoeffdingTreeClassifier, exactly as in the paper. Cold start is handled by a
structural prior (token pricing + a latency model linear in uncached tokens)
until ``warm_n`` observations arrive.

Batched path (router Phase 1b hot loop): ``feature_tensor`` assembles the
full (n requests, m agents, N_FEATURES) Eq.-5 tensor with broadcasting,
and ``PredictorPool.predict_matrix`` scores it in a handful of array ops —
all m agents' trees stacked into one node pool (one vectorized descend per
target), the structural prior and the ``w = min(1, n_obs/60)`` blend applied
as arrays. Every operation mirrors ``AgentPredictor.predict`` double-for-
double, so the batched path is a pure oracle-parity optimization.

Reputation-weighted priors (adversarial stress):
each agent carries a multiplicative reputation in [0, 1], EWMA-updated from
settled report-vs-audit quality-inflation residuals
(``note_residual``).  Reputation scales the w-blend (``w_eff = w * rep``,
leaning a distrusted agent's latency/cost back onto the structural prior)
and multiplies predicted quality in both the warm and cold paths, so an
inflating agent's Eq.-1 value decays instead of its lies poisoning the
estimate.  At reputation exactly 1.0 — the honest fixed point, preserved
exactly by the EWMA — every scaling is a bit-neutral multiply-by-one, so
honest runs are bit-identical to the pre-reputation router.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.hoeffding import (HoeffdingTreeClassifier,
                                        HoeffdingTreeRegressor, descend,
                                        stack_compiled)
from repro_torch.core.pricing import TokenPrices, predicted_cost

N_FEATURES = 10


def feature_tensor(prompt_lens, turns, affinity, *, router_inflight=0.0,
                   router_rps=0.0, agent_inflight, agent_rps, capacity,
                   domain_match) -> np.ndarray:
    """(n, m, N_FEATURES) tensor; X[j, i] equals the ``PredictorInput(...)
    .vector()`` the scalar router builds for pair (request j, agent i).

    ``prompt_lens``/``turns``: (n,); ``affinity``/``domain_match``: (n, m);
    ``agent_inflight``/``agent_rps``/``capacity``: (m,); router_* scalars.
    Utilization is derived per agent exactly as the scalar path does:
    inflight / max(1, capacity).
    """
    affinity = np.asarray(affinity, dtype=np.float64)
    n, m = affinity.shape
    inflight = np.asarray(agent_inflight, dtype=np.float64)
    cap = np.asarray(capacity, dtype=np.float64)
    X = np.empty((n, m, N_FEATURES), dtype=np.float64)
    X[..., 0] = np.asarray(prompt_lens, dtype=np.float64)[:, None]
    X[..., 1] = np.asarray(turns, dtype=np.float64)[:, None]
    X[..., 2] = affinity
    X[..., 3] = float(router_inflight)
    X[..., 4] = float(router_rps)
    X[..., 5] = inflight[None, :]
    X[..., 6] = np.asarray(agent_rps, dtype=np.float64)[None, :]
    X[..., 7] = cap[None, :]
    X[..., 8] = (inflight / np.maximum(1.0, cap))[None, :]
    X[..., 9] = np.asarray(domain_match, dtype=np.float64)
    return X


def _blend_with_prior(X, *, lpt, lb, miss, hit, out, ewma, n_obs, warm_n,
                      prior_q, rep, raw_lat, raw_cst, raw_q, explore=0.0):
    """Structural cold-start prior + ``w = min(1, n_obs/60)`` tree blend as
    array ops — the single vectorized transcription of the scalar
    ``AgentPredictor.predict`` math (kept bit-equivalent: same op order,
    same ``trunc``/``maximum``/``clip`` semantics), used by
    ``predict_matrix`` with (m,) per-agent param arrays broadcast against
    (n, m) features.
    ``rep`` is the reputation weight: it scales the tree-blend weight and
    multiplies quality in both warm and cold branches (exactly neutral at
    1.0, the honest fixed point).  ``explore`` is the per-agent optimism
    bonus (`AgentPredictor.explore`); quality is lifted by
    ``explore / sqrt(1 + n_obs)`` (capped at 1.0) ONLY for agents whose
    bonus is nonzero, so the default 0.0 leaves the arrays untouched."""
    pl, aff, util = X[..., 0], X[..., 2], X[..., 8]
    uncached = pl * (1.0 - aff)
    prior_lat = (lb + lpt * uncached) * (1.0 + util)
    npmt = np.trunc(pl)  # == int(prompt_len) for non-negative lengths
    nhit = aff * npmt
    prior_cst = miss * (npmt - nhit) + hit * nhit + out * ewma
    w = np.minimum(1.0, n_obs / 60.0) * rep
    lat = (1 - w) * prior_lat + w * np.maximum(0.0, raw_lat)
    cst = (1 - w) * prior_cst + w * np.maximum(0.0, raw_cst)
    cold = n_obs < warm_n
    qual = np.where(cold, prior_q * rep, np.clip(raw_q, 0.0, 1.0) * rep)
    expl = np.asarray(explore, dtype=np.float64)
    if np.any(expl != 0.0):
        qual = np.where(expl != 0.0,
                        np.minimum(1.0, qual + expl / np.sqrt(1.0 + n_obs)),
                        qual)
    return (np.where(cold, prior_lat, lat),
            np.where(cold, prior_cst, cst),
            qual)


@dataclass
class PredictorInput:
    """One (request, agent) Eq.-5 feature row x_ij, field-per-feature."""

    prompt_len: float
    turn: float
    affinity: float
    router_inflight: float
    router_rps: float
    agent_inflight: float
    agent_rps: float
    capacity: float
    utilization: float
    domain_match: float

    def vector(self) -> np.ndarray:
        """The N_FEATURES-long float64 array the trees consume."""
        return np.array([
            self.prompt_len, self.turn, self.affinity,
            self.router_inflight, self.router_rps,
            self.agent_inflight, self.agent_rps,
            self.capacity, self.utilization, self.domain_match,
        ], dtype=np.float64)


@dataclass
class QoSEstimate:
    """Predicted (Lat, Cost, Perf) triple for one (request, agent) pair."""

    latency: float
    cost: float
    quality: float


class AgentPredictor:
    """One agent's three Hoeffding targets + structural cold-start prior."""

    def __init__(self, agent_id: str, prices: TokenPrices, *,
                 warm_n: int = 6, prior_latency_per_tok: float = 1e-3,
                 prior_latency_base: float = 0.02, prior_quality: float = 0.6,
                 rep_alpha: float = 0.25, explore: float = 0.0):
        self.agent_id = agent_id
        self.prices = prices
        self.lat = HoeffdingTreeRegressor(N_FEATURES)
        self.cost = HoeffdingTreeRegressor(N_FEATURES)
        self.quality = HoeffdingTreeClassifier(N_FEATURES)
        self.n_obs = 0
        self.warm_n = warm_n
        self.prior_lpt = prior_latency_per_tok
        self.prior_lb = prior_latency_base
        self.prior_q = prior_quality
        self.ewma_gen = 32.0  # expected generation length
        self.reputation = 1.0  # report-trust weight in [0, 1]; 1.0 = honest
        self.rep_alpha = rep_alpha
        # optimism bonus against affinity entrenchment:
        # predicted quality is lifted by explore/sqrt(1+n_obs), capped at
        # 1.0, so a rarely-sampled specialist can outbid an entrenched
        # cache-warm generalist until real observations arrive.  The
        # default 0.0 is an exact IEEE no-op (the lift is never applied).
        self.explore = float(explore)

    def _optimism(self, q: float) -> float:
        """Apply the exploration lift (exact passthrough at ``explore=0``)."""
        if self.explore == 0.0:
            return q
        return min(1.0, q + self.explore / float(np.sqrt(1.0 + self.n_obs)))

    def note_residual(self, residual: float) -> None:
        """Fold one settled report-vs-audit residual into reputation.

        ``residual`` is the quality inflation ``max(0, reported - audited)``
        in [0, 1]; the EWMA target is ``1 - residual``.  A zero residual
        leaves a 1.0 reputation at exactly 1.0 (``0.75*1.0 + 0.25*1.0``
        is exact in IEEE arithmetic), so honest fleets stay bit-identical
        with or without the audit channel attached.
        """
        target = 1.0 - min(1.0, max(0.0, float(residual)))
        self.reputation = ((1.0 - self.rep_alpha) * self.reputation
                           + self.rep_alpha * target)

    def predict(self, x: PredictorInput) -> QoSEstimate:
        """Eq.-5 QoS estimate: structural prior blended into tree output,
        scaled by the agent's reputation (neutral at 1.0)."""
        uncached = x.prompt_len * (1.0 - x.affinity)
        prior_lat = (self.prior_lb + self.prior_lpt * uncached) * (1.0 + x.utilization)
        prior_cst = predicted_cost(self.prices, int(x.prompt_len), x.affinity,
                                   self.ewma_gen)
        rep = self.reputation
        if self.n_obs < self.warm_n:
            return QoSEstimate(prior_lat, prior_cst,
                               self._optimism(self.prior_q * rep))
        v = x.vector()
        # blend structural prior -> tree as evidence accumulates: the Eq.6
        # cost prior is nearly exact given affinity, so a barely-trained tree
        # must not displace it abruptly.
        # Reputation scales the blend: a distrusted agent's self-reported
        # telemetry counts for less, and its quality is discounted outright.
        w = min(1.0, self.n_obs / 60.0) * rep
        lat = (1 - w) * prior_lat + w * max(0.0, self.lat.predict_one(v))
        cst = (1 - w) * prior_cst + w * max(0.0, self.cost.predict_one(v))
        return QoSEstimate(
            latency=lat,
            cost=cst,
            quality=self._optimism(
                float(np.clip(self.quality.predict_one(v), 0.0, 1.0)) * rep),
        )

    def update(self, x: PredictorInput, latency_obs: float, cost_obs: float,
               quality_obs: float) -> None:
        """Phase-4 feedback: one observed (Lat, Cost, Perf) triple."""
        v = x.vector()
        self.lat.learn_one(v, float(latency_obs))
        self.cost.learn_one(v, float(cost_obs))
        self.quality.learn_one(v, float(quality_obs))
        self.n_obs += 1


def identity_fingerprint(agent_id: str, prices: TokenPrices) -> str:
    """Stable identity key for reputation persistence across churn.

    An agent that leaves and rejoins under the same id and published
    token prices is the SAME market identity — ``float.hex`` makes the
    price part exact (no repr rounding), so the fingerprint never
    aliases two distinct price points.  Changing any published price
    creates a fresh identity (and a fresh reputation): re-entering at a
    different market position is a new offer, not a laundered one.
    """
    return "|".join((str(agent_id), float(prices.miss).hex(),
                     float(prices.hit).hex(), float(prices.out).hex()))


class PredictorPool:
    """Independent AgentPredictor per backend (Appendix C.2.3).

    Reputation is keyed on `identity_fingerprint` and survives
    leave/rejoin churn: `remove_agent` parks the departing predictor's
    reputation in a pool-lifetime ledger and `add_agent` restores it for
    a matching fingerprint, so the laundering move — decay your
    reputation, churn out, rejoin with fresh 1.0 trust — inherits the
    decayed weight instead.  Honest agents (reputation exactly 1.0) are
    bit-unaffected: restoring 1.0 equals the fresh-predictor default.
    """

    def __init__(self, prices_by_agent: dict[str, TokenPrices], **kw):
        self._default_kw = dict(kw)
        self._preds = {aid: AgentPredictor(aid, pr, **kw)
                       for aid, pr in prices_by_agent.items()}
        # per-target stacked-forest cache, invalidated by membership or any
        # tree version change (any learn_one shifts leaf means)
        self._stacks: dict[str, dict] = {}
        # identity_fingerprint -> parked reputation of departed agents
        self._rep_ledger: dict[str, float] = {}

    def __getitem__(self, agent_id: str) -> AgentPredictor:
        return self._preds[agent_id]

    def __contains__(self, agent_id):
        return agent_id in self._preds

    def add_agent(self, agent_id: str, prices: TokenPrices, **kw) -> None:
        """Elastic scale-out: a new agent joins mid-flight.

        Predictor knobs default to the pool's construction-time ``**kw``
        (so e.g. an exploration bonus survives churn); a rejoining
        identity inherits its parked reputation (see class docstring).
        """
        kw = {**self._default_kw, **kw}
        pred = AgentPredictor(agent_id, prices, **kw)
        parked = self._rep_ledger.get(identity_fingerprint(agent_id, prices))
        if parked is not None:
            pred.reputation = parked
        self._preds[agent_id] = pred
        # a re-added id gets FRESH trees whose version counters restart, so
        # a version-keyed cache entry could collide with the old trees' —
        # membership changes always drop the stacks
        self._stacks.clear()

    def remove_agent(self, agent_id: str) -> None:
        """Elastic scale-in: drop an agent and its stacked-forest caches.

        The departing reputation is parked under the agent's identity
        fingerprint so churn cannot reset it (anti-laundering layer).
        """
        pred = self._preds.pop(agent_id, None)
        if pred is not None:
            fp = identity_fingerprint(pred.agent_id, pred.prices)
            self._rep_ledger[fp] = pred.reputation
        self._stacks.clear()

    def agents(self):
        """Agent ids currently in the pool."""
        return list(self._preds)

    def note_residual(self, agent_id: str, residual: float) -> None:
        """Route one settled quality-inflation residual into the agent's
        reputation (no-op for unknown/removed agents).  Reputation lives
        blend-side, not in the trees, so no stacked-forest invalidation."""
        pred = self._preds.get(agent_id)
        if pred is not None:
            pred.note_residual(residual)

    def reputations(self) -> dict[str, float]:
        """Current reputation weight per agent (1.0 = fully trusted)."""
        return {aid: p.reputation for aid, p in self._preds.items()}

    # ---------------- batched Phase-1 scoring ----------------
    def _stacked_forest(self, name: str, agent_ids: list[str]):
        """Stacked node pool for one target, refreshed incrementally: a
        ``learn_one`` without a split only shifts leaf values (node count
        unchanged), so the changed tree is recompiled and written back into
        its slice of the pool; a split (or membership change) triggers a
        full restack. Per-round cost is thus proportional to the number of
        trees feedback actually touched, not the fleet size."""
        trees = [getattr(self._preds[a], name) for a in agent_ids]
        versions = [t._version for t in trees]
        entry = self._stacks.get(name)
        if entry is not None and entry["ids"] == tuple(agent_ids):
            changed = [k for k in range(len(trees))
                       if entry["versions"][k] != versions[k]]
            fresh = {k: trees[k].compiled() for k in changed}
            if all(len(c.feature) == entry["sizes"][k]
                   for k, c in fresh.items()):
                # unchanged node count == unchanged structure (nodes are only
                # ever added, by splits): only leaf values moved, so refresh
                # just the value slices of the touched trees
                st, roots = entry["stacked"], entry["roots"]
                for k, c in fresh.items():
                    off = roots[k]
                    st.value[off:off + entry["sizes"][k]] = c.value
                entry["versions"] = versions
                return st, roots
        compiled = [t.compiled() for t in trees]
        stacked, roots = stack_compiled(compiled)
        self._stacks[name] = {"ids": tuple(agent_ids), "versions": versions,
                              "sizes": [len(c.feature) for c in compiled],
                              "stacked": stacked, "roots": roots}
        return stacked, roots

    def predict_matrix(self, agent_ids: list[str], X: np.ndarray):
        """Score the full (n, m, N_FEATURES) feature tensor in array ops.

        Returns (latency, cost, quality) matrices, (n, m) each, equal to
        looping ``self[agent_ids[i]].predict(PredictorInput(*X[j, i]))``
        over every pair — the m agents' trees are stacked into one node
        pool per target (one vectorized descend over the (n·m, F) matrix),
        and the structural cold-start prior + the ``min(1, n_obs/60)``
        blend are applied as broadcast array ops.
        """
        X = np.asarray(X, dtype=np.float64)
        n, m = X.shape[:2]
        preds = [self._preds[a] for a in agent_ids]
        flat = X.reshape(n * m, N_FEATURES)
        col = np.tile(np.arange(m), n)  # agent index of each flat row
        raw = {}
        for name in ("lat", "cost", "quality"):
            stacked, roots = self._stacked_forest(name, agent_ids)
            raw[name] = descend(stacked, flat, roots[col]).reshape(n, m)

        return _blend_with_prior(
            X,
            lpt=np.array([p.prior_lpt for p in preds]),
            lb=np.array([p.prior_lb for p in preds]),
            miss=np.array([p.prices.miss for p in preds]),
            hit=np.array([p.prices.hit for p in preds]),
            out=np.array([p.prices.out for p in preds]),
            ewma=np.array([p.ewma_gen for p in preds]),
            n_obs=np.array([p.n_obs for p in preds], dtype=np.float64),
            warm_n=np.array([p.warm_n for p in preds], dtype=np.float64),
            prior_q=np.array([p.prior_q for p in preds]),
            rep=np.array([p.reputation for p in preds]),
            raw_lat=raw["lat"], raw_cst=raw["cost"], raw_q=raw["quality"],
            explore=np.array([p.explore for p in preds]))
