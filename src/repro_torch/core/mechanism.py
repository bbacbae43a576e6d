"""IEMAS router — the paper's Algorithm 1 as a deployable component.

Per micro-batch of requests:
  Phase 1  cache-aware prediction & valuation (ledger LCP -> o_ij; Hoeffding
           QoS -> (L,C,P); Eq. 1 -> v_ij; w_ij = v_ij - c_ij, pruned).
           The Eq.-4 LCP runs on the router's ``device`` (the CUDA kernel
           on a card, its plain version on the CPU); batched by default,
           the full (n, m, F) Eq.-5 feature tensor is scored by
           ``PredictorPool.predict_matrix`` in one vectorized pass (NumPy,
           bit-identical to the reference's serving default, or
           ``predictor_backend="torch"``: float32 on ``device``);
           ``batched=False`` keeps the per-pair scalar loop as the semantic
           oracle.  ``fused=True`` runs Phase 1 and the single hub's Phase
           2 as one device step per batch (`core/routing_fused.py`).
  Phase 2  welfare maximization per proxy hub (Eq. 7 / Thm 4.1): any
           backend in the port's ``core/solvers`` registry (``solver=``
           kwarg — ``cuda``, the staged float32 column auction as one CUDA
           launch, ``dense-torch`` with the plain round, the float64 NumPy
           ``dense`` auction or the exact ``mcmf`` oracle), on the router's
           ``device`` (``dense`` and ``mcmf`` run on the host).  With ``n_hubs > 1`` the batch's
           welfare matrix is carved into per-hub blocks and each block is
           auctioned independently (``run_sharded_auction``), with
           ``warm_start=True`` each hub's final slot prices
           seed the next round's ε-scaling — keyed by hub id + elastic
           agent-set version, cold-starting whenever membership changed —
           and with ``spill=True`` (default) requests a saturated hub left
           unmatched re-auction once over every hub's residual capacity
           (cross-hub spill), so hard hub pinning no longer strands
           welfare when another hub has slack.  Incentive caveat: payments
           are Clarke pivots *within each round's market*.  Hub sharding
           already trades exact global VCG for speed (Fig. 6), and the
           spill round inherits that: a bidder who tanks round 1 to buy
           uncontested residual capacity in round 2 can profit, so the
           DSIC theorems hold per-market, not across rounds.  Deployments
           that need strict DSIC at ``n_hubs > 1`` should run
           ``spill=False`` and accept the stranded-welfare tail.
  Phase 3  VCG Clarke-pivot payments (Eq. 8) + dispatch.
  Phase 4  execution feedback: predictor updates + prefix-ledger updates.

The router never touches engine internals — it sees only the telemetry the
proxy layer exposes (Appendix C), so it drops onto any backend that reports
(latency, usage, quality) per completed request.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.affinity import PrefixLedger
from repro_torch.core.auction import (SPILL_HUB, _spill_round,
                                      run_sharded_auction)
from repro_torch.core.hub import SlotPriceBook, cluster_agents, route_to_hub
from repro_torch.core.ledger import SettlementLedger
from repro_torch.core.predictor import (PredictorInput, PredictorPool,
                                        QoSEstimate, feature_tensor)
from repro_torch.core.pricing import TokenPrices, observed_cost
from repro_torch.core.solvers import get_solver
from repro_torch.core.valuation import ValuationConfig, client_value
from repro_torch.distributed.elastic import AgentSetVersion
from repro_torch.utils.device import resolve_device
from repro_torch.utils.timing import phase_scope


@dataclass
class AgentInfo:
    """Published profile of one market participant (prices, capacity, tags)."""

    agent_id: str
    prices: TokenPrices
    capacity: int
    domains: tuple[str, ...]
    scale: float = 1.0
    recurrent: bool = False  # extension-only cache semantics (rwkv/zamba)
    cache_slots: int = 0     # published cache capacity (0 = unknown/unbounded)


@dataclass
class Request:
    """One dialogue turn to route: prompt tokens + domain + metadata."""

    request_id: str
    dialogue_id: str
    tokens: np.ndarray          # prompt token ids (full conversation so far)
    turn: int
    domain: str = ""
    max_new_tokens: int = 32
    meta: dict = field(default_factory=dict)


@dataclass
class RouteDecision:
    """Algorithm-1 output for one request: winner, payment, QoS estimate."""

    request: Request
    agent_id: str | None
    payment: float
    estimate: QoSEstimate | None
    welfare_weight: float
    hub_id: int


@dataclass
class CompletionObs:
    """Engine telemetry for one completed request (Phase-4 feedback)."""

    latency: float          # TTFT seconds (paper's Lat)
    n_prompt: int
    n_hit: int              # cached prompt tokens reported by the engine
    n_gen: int
    quality: float          # evaluator score in [0,1] as REPORTED
    failed: bool = False
    # audited ground-truth quality (settlement audit channel): None means no
    # audit ran and the report is taken at face value — bit-identical to the
    # pre-audit router.  When set, value is settled at the audited score and
    # the inflation residual max(0, quality - audit_quality) feeds the
    # agent's reputation.
    audit_quality: float | None = None


class IEMASRouter:
    """The paper's Algorithm 1 (see module docstring for the four phases)."""

    name = "iemas"

    def __init__(self, agents: list[AgentInfo], *,
                 valuation: ValuationConfig | None = None,
                 payment_mode: str = "warmstart",
                 solver: str = "cuda",
                 n_hubs: int = 1, hub_scheme: str = "domain",
                 warm_start: bool = False, spill: bool = True,
                 use_kernel_affinity: bool = True,
                 batched: bool = True, predictor_backend: str = "numpy",
                 predictor_kw: dict | None = None,
                 reputation: bool = True, audit_ledger: bool = False,
                 fused: bool = False, device="cuda"):
        # where the Phase-1a LCP and the Phase-2 solve run; raises when CUDA
        # is asked for and absent (nothing moves to the CPU by itself)
        self.device = resolve_device(device)
        self.agents = list(agents)
        self.valuation = valuation or ValuationConfig()
        self.payment_mode = payment_mode
        # optional serving-layer RoutingProfiler (duck-typed: anything with a
        # phase(name) context manager); attributes per-phase wall-clock for
        # the overhead-crossover study — None keeps every section a no-op
        self.profiler = None
        self.solver = solver
        self.spill = spill
        # cross-round slot-price reuse needs persistent duals; the registry
        # capability flag says which backends have them — silently a no-op
        # otherwise
        self.warm_start = warm_start and get_solver(solver).supports_warm_start
        self.use_kernel_affinity = use_kernel_affinity
        self.batched = batched
        self.predictor_backend = predictor_backend
        self.ledger = PrefixLedger()
        self._refresh_ledger_cap()
        self.pool = PredictorPool({a.agent_id: a.prices for a in agents},
                                  **(predictor_kw or {}))
        # reputation-weighted priors (on by default, exactly neutral without
        # an audit channel) + the optional hash-chained settlement ledger
        self.use_reputation = reputation
        self.settlement = SettlementLedger() if audit_ledger else None
        self._pending: dict[str, tuple] = {}  # request_id -> (x, agent, req)
        self.accounts = {"payments": 0.0, "agent_costs": 0.0,
                         "welfare_realized": 0.0, "surplus": 0.0,
                         "matched": 0, "unmatched": 0, "spill_rescued": 0,
                         "incremental_routed": 0, "incremental_confirmed": 0,
                         "incremental_rerouted": 0}
        # provisional routes issued since the last batch auction: the next
        # route_batch re-equilibrates them (request_id -> decision, plus the
        # per-agent count of provisionally consumed units)
        self._provisional: dict[str, RouteDecision] = {}
        self._prov_units: dict[str, int] = {}
        self.n_hubs = n_hubs
        self.hub_scheme = hub_scheme
        self.agent_set_version = AgentSetVersion()
        self.price_book = SlotPriceBook()
        self._rebuild_hubs()
        self.quarantined: set[str] = set()
        # fused device step (core/routing_fused.py): one step replaces
        # _phase1 + the hub-0 solve; host-side spill, price-book splice and
        # payments are shared with the staged path
        self.fused = fused
        self._fused = None
        if fused:
            from repro_torch.core.routing_fused import (FUSED_SOLVERS,
                                                        FusedRoutingStep)
            if n_hubs != 1:
                raise ValueError(
                    "fused=True runs one global device-resident column "
                    f"market and requires n_hubs=1 (got {n_hubs}); use the "
                    "staged path for hub sharding")
            if solver not in FUSED_SOLVERS:
                raise ValueError(
                    "fused=True requires a solver whose bidding loop stages "
                    f"inside the fused program {FUSED_SOLVERS}; got "
                    f"{solver!r}")
            self._fused = FusedRoutingStep(self)

    # ---------------- elastic membership ----------------
    def _refresh_ledger_cap(self):
        """Bound ledger memory when every agent publishes a cache size.

        Sessions older than an agent's ``cache_slots`` most recent are
        presumed evicted and affinity-masked by ``apply_lru`` regardless, so
        an LRU cap at 2x the largest published cache is behavior-neutral on
        the routing path while keeping streamed runs' ledger bounded.  Any
        agent publishing 0 (= unknown/unbounded cache) disables the cap.
        """
        slots = [a.cache_slots for a in self.agents]
        if slots and all(s > 0 for s in slots):
            self.ledger.max_sessions_per_agent = 2 * max(slots)
        else:
            self.ledger.max_sessions_per_agent = None

    def _rebuild_hubs(self):
        self.hubs = cluster_agents([a.domains for a in self.agents],
                                   [a.scale for a in self.agents],
                                   self.n_hubs, self.hub_scheme)
        # hub cuts moved -> every stored slot-price vector is for a dead
        # layout; stamp a new agent-set version so lookups cold-start
        self.agent_set_version.bump()
        self.price_book.invalidate()

    def add_agent(self, agent: AgentInfo) -> None:
        """Elastic scale-out: admit an agent and recut the proxy hubs."""
        self.agents.append(agent)
        self.pool.add_agent(agent.agent_id, agent.prices)
        self._refresh_ledger_cap()
        self._rebuild_hubs()

    def remove_agent(self, agent_id: str) -> None:
        """Elastic scale-in: drop an agent, its predictors and ledger state."""
        self.agents = [a for a in self.agents if a.agent_id != agent_id]
        self.pool.remove_agent(agent_id)
        self.ledger.evict(agent_id)
        self.quarantined.discard(agent_id)
        self._refresh_ledger_cap()
        self._rebuild_hubs()

    def quarantine(self, agent_id: str) -> None:
        """Fault isolation: exclude a failed/timing-out agent from auctions."""
        self.quarantined.add(agent_id)

    def reinstate(self, agent_id: str) -> None:
        """Lift a quarantine after the cluster-layer cooldown."""
        self.quarantined.discard(agent_id)

    # ---------------- Algorithm 1 ----------------
    def _phase(self, name: str):
        """Profiler section ``name`` — a no-op unless a profiler is attached."""
        return phase_scope(self.profiler, name)

    def _phase1(self, requests, live, telemetry):
        """Phase 1a/1b: affinity + QoS matrices + Eq.-1 values (see
        route_batch); returns (lat, cst, qual, values, X, xs)."""
        # Phase 1a: affinity matrix over LIVE agents.  DAG steps carry their
        # own session key (``meta["session"]``) distinct from the dialogue id
        # so sibling steps do not clobber each other's ledger entries; linear
        # requests fall back to the dialogue id — bit-identical to before.
        prompts = [r.tokens for r in requests]
        sess = [r.meta.get("session", r.dialogue_id) for r in requests]
        ext_mask = [a.recurrent for a in live]
        o = self.ledger.affinity_matrix(
            prompts, sess, [a.agent_id for a in live],
            extension_only_mask=ext_mask,
            use_kernel=self.use_kernel_affinity, device=self.device)
        # LRU cache model (§4.4 published cache summaries): zero the affinity
        # of sessions the backend has presumably evicted, so the auction does
        # not pay for dead caches (and Eq.6 predictions stay calibrated under
        # the paper's constrained-memory / frequent-eviction regime).
        o = self.ledger.apply_lru(o, sess, [a.agent_id for a in live],
                                  [a.cache_slots for a in live])
        # Precedence-aware credit (workflow DAGs): a handoff step's prompt
        # starts with its parents' contexts, so an agent holding a PARENT
        # step's KV prefix is as warm as one holding the step's own — fold
        # that into o before it enters the Eq.-5 feature tensor.
        parents = [r.meta.get("parent_sessions", ()) for r in requests]
        if any(parents):
            o = self.ledger.parent_credit(
                o, prompts, parents, [a.agent_id for a in live],
                extension_only_mask=ext_mask,
                cache_slots=[a.cache_slots for a in live])

        # Phase 1b: QoS prediction per candidate pair — the whole (n, m, F)
        # Eq.-5 tensor in one vectorized pass (default), or the scalar
        # per-pair oracle loop (batched=False); PredictorInput objects are
        # then materialized only for the pairs the auction actually matches.
        n, m = len(requests), len(live)
        inflight = telemetry.get("agent_inflight", {})
        agent_rps = telemetry.get("agent_rps", {})
        if self.batched:
            # domain membership via a per-unique-domain lookup row (a batch
            # has few distinct domains; avoids n*m Python membership tests)
            dom_rows: dict[str, np.ndarray] = {}
            for r in requests:
                if r.domain not in dom_rows:
                    dom_rows[r.domain] = np.array(
                        [float(r.domain in a.domains) for a in live])
            X = feature_tensor(
                [float(len(r.tokens)) for r in requests],
                [float(r.turn) for r in requests], o,
                router_inflight=float(telemetry.get("router_inflight", 0)),
                router_rps=float(telemetry.get("router_rps", 0.0)),
                agent_inflight=[float(inflight.get(a.agent_id, 0))
                                for a in live],
                agent_rps=[float(agent_rps.get(a.agent_id, 0.0))
                           for a in live],
                capacity=[float(a.capacity) for a in live],
                domain_match=np.stack([dom_rows[r.domain] for r in requests]))
            lat, cst, qual = self.pool.predict_matrix(
                [a.agent_id for a in live], X,
                backend=self.predictor_backend, device=self.device)
            xs = None
        else:
            lat = np.zeros((n, m))
            cst = np.zeros((n, m))
            qual = np.zeros((n, m))
            xs = []
            for j, r in enumerate(requests):
                row = []
                for i, a in enumerate(live):
                    util = inflight.get(a.agent_id, 0) / max(1, a.capacity)
                    x = PredictorInput(
                        prompt_len=float(len(r.tokens)), turn=float(r.turn),
                        affinity=float(o[j, i]),
                        router_inflight=float(
                            telemetry.get("router_inflight", 0)),
                        router_rps=float(telemetry.get("router_rps", 0.0)),
                        agent_inflight=float(inflight.get(a.agent_id, 0)),
                        agent_rps=float(agent_rps.get(a.agent_id, 0.0)),
                        capacity=float(a.capacity), utilization=float(util),
                        domain_match=float(r.domain in a.domains),
                    )
                    est = self.pool[a.agent_id].predict(x)
                    lat[j, i], cst[j, i], qual[j, i] = (est.latency, est.cost,
                                                        est.quality)
                    row.append((x, est))
                xs.append(row)

        values = client_value(qual, lat, self.valuation)
        return lat, cst, qual, values, (X if self.batched else None), xs

    def route_batch(self, requests: list[Request], telemetry: dict,
                    free_slots: dict | None = None) -> list[RouteDecision]:
        """telemetry: router_inflight, router_rps, per-agent inflight/rps.
        free_slots (optional) caps per-agent concurrency below capacity.

        Also the window's re-equilibration oracle for provisional routes
        issued by :meth:`route_incremental` since the last batch: the
        provisionals re-enter the market as SHADOW participants (with the
        units they consumed returned to the pool) and the batch solution
        confirms each one (same agent ->
        ``accounts["incremental_confirmed"]``) or disavows it
        (``accounts["incremental_rerouted"]``); the dispatched execution is
        never moved — the counters quantify how often the posted-price
        greedy agreed with the equilibrium.  Every *batch* request is
        tallied exactly once per window — matched or unmatched, with spill
        rescues counted inside matched (plus ``spill_rescued``), never as
        an unmatched-then-rescued double entry.
        """
        if self.profiler is not None and \
                hasattr(self.profiler, "note_route_batch"):
            self.profiler.note_route_batch(len(requests))
        prov = list(self._provisional.values())
        prov_units = self._prov_units
        self._provisional = {}
        self._prov_units = {}
        shadow = len(prov)
        all_reqs = [d.request for d in prov] + list(requests)
        if not all_reqs:
            return []
        if prov_units and free_slots is not None:
            # shadow participants re-bid for the units they already consumed
            free_slots = dict(free_slots)
            for aid, k in prov_units.items():
                free_slots[aid] = free_slots.get(aid, 0) + k
        live = [a for a in self.agents if a.agent_id not in self.quarantined]
        if not live:
            decisions = [RouteDecision(r, None, 0.0, None, 0.0, -1)
                         for r in all_reqs]
            return self._finish_window(prov, decisions, shadow)
        n, m = len(all_reqs), len(live)

        # Phase 1c/2/3 per hub (capacities, hub blocks and warm-start seeds
        # are pure functions of membership/telemetry, so they are assembled
        # before Phase 1 — the fused path feeds them INTO its device step)
        caps = []
        for a in live:
            free = (free_slots or {}).get(a.agent_id, a.capacity)
            caps.append(max(0, int(free)))
        decisions: list[RouteDecision] = [None] * n  # type: ignore
        live_pos = {a.agent_id: i for i, a in enumerate(live)}
        hub_of_agent = {}
        for h, hub in enumerate(self.hubs):
            for gi in hub.agent_indices:
                aid = self.agents[gi].agent_id
                if aid in live_pos:
                    hub_of_agent[live_pos[aid]] = h

        req_hub = [route_to_hub(r.domain, self.hubs,
                                [a.domains for a in self.agents])
                   for r in all_reqs]
        blocks: dict[int, tuple[list[int], list[int]]] = {}
        for h in range(len(self.hubs)):
            r_idx = [j for j in range(n) if req_hub[j] == h]
            a_idx = [i for i in range(m) if hub_of_agent.get(i, -1) == h]
            if not r_idx:
                continue
            # a hub whose live agents are all gone (quarantine/scale-in)
            # still gets an EMPTY block: its requests trivially lose round 1
            # there, which keeps them eligible for the cross-hub spill round
            # and keeps the matched/unmatched ledger honest
            blocks[h] = (r_idx, a_idx)

        # warm-start seeds: last round's duals, replayed only when the hub's
        # exact live-agent set, the elastic version AND the agents'
        # published capacities still match
        start_prices: dict[int, np.ndarray] = {}
        if self.warm_start:
            with self._phase("price_book"):
                for h, (r_idx, a_idx) in blocks.items():
                    if not a_idx:
                        continue
                    version, ids = self.agent_set_version.fingerprint(
                        live[i].agent_id for i in a_idx)
                    counts = [min(caps[i], len(r_idx)) for i in a_idx]
                    seed = self.price_book.lookup(
                        h, version, ids, [live[i].capacity for i in a_idx],
                        counts)
                    if seed is not None:
                        start_prices[h] = seed

        if self._fused is not None:
            # one device step from the ledger gather to the settled auction
            # (n_hubs == 1, so block 0 IS the global market); the cross-hub
            # spill helper still runs host-side for parity with the staged
            # path (it is vacuous unless capacity ran out)
            with self._phase("fused_route"):
                lat, cst, qual, values, X, result = self._fused.step(
                    all_reqs, live, telemetry, caps,
                    start_prices=start_prices.get(0))
            xs = None
            results = {0: result}
            if self.spill:
                with self._phase("phase2_spill"):
                    sres = _spill_round(values, cst, caps, blocks, results,
                                        get_solver(self.solver),
                                        self.payment_mode,
                                        sorted(hub_of_agent),
                                        device=self.device)
                if sres is not None:
                    results[SPILL_HUB] = sres
        else:
            with self._phase("phase1_predict"):
                lat, cst, qual, values, X, xs = self._phase1(all_reqs, live,
                                                             telemetry)
            results = run_sharded_auction(values, cst, caps, blocks,
                                          payment_mode=self.payment_mode,
                                          solver=self.solver,
                                          start_prices=start_prices,
                                          spill=self.spill,
                                          spill_agents=sorted(hub_of_agent),
                                          profiler=self.profiler,
                                          device=self.device)

        def _record_match(j, i, pay, weight, pred_cost, h):
            """Decision (+ a pending-feedback entry for real batch members —
            shadow provisionals are already pending from their dispatch)."""
            agent = live[i]
            if xs is None:  # batched: materialize matched pairs only
                x = PredictorInput(*(float(v) for v in X[j, i]))
                est = QoSEstimate(float(lat[j, i]), float(cst[j, i]),
                                  float(qual[j, i]))
            else:
                x, est = xs[j][i]
            decisions[j] = RouteDecision(all_reqs[j], agent.agent_id, pay,
                                         est, weight, h)
            if j >= shadow:
                self._pending[all_reqs[j].request_id] = (x, agent,
                                                         all_reqs[j], pay,
                                                         pred_cost)

        for h, result in results.items():
            if h == SPILL_HUB:
                continue  # cross-hub second round, spliced below
            r_idx, a_idx = blocks[h]
            cc = result.costs
            if self.warm_start and a_idx and \
                    "agent_prices" in result.solver_stats:
                with self._phase("price_book"):
                    version, ids = self.agent_set_version.fingerprint(
                        live[i].agent_id for i in a_idx)
                    self.price_book.store(
                        h, version, ids,
                        [live[i].capacity for i in a_idx],
                        result.solver_stats["agent_prices"])
            for local_j, j in enumerate(r_idx):
                li = result.assignment[local_j]
                if li < 0:
                    decisions[j] = RouteDecision(all_reqs[j], None, 0.0, None,
                                                 0.0, h)
                    continue
                _record_match(j, a_idx[li], result.payments[local_j],
                              result.weights[local_j, li], cc[local_j, li], h)

        spill_result = results.get(SPILL_HUB)
        if spill_result is not None:
            # second-round winners override their first-round "unmatched"
            # decisions; payments are Clarke pivots within the spill market
            blk = spill_result.solver_stats["spill"]
            for local_j, j in enumerate(blk["r_idx"]):
                li = spill_result.assignment[local_j]
                if li < 0:
                    continue
                i = blk["a_idx"][li]
                _record_match(j, i, spill_result.payments[local_j],
                              spill_result.weights[local_j, li],
                              spill_result.costs[local_j, li],
                              hub_of_agent.get(i, -1))
                if j >= shadow:
                    self.accounts["spill_rescued"] += 1
        return self._finish_window(prov, decisions, shadow)

    def _finish_window(self, prov, decisions, shadow) -> list[RouteDecision]:
        """Provisional confirmation + the exactly-once-per-window tally.

        The first ``shadow`` decisions are the re-equilibrated provisionals:
        each is compared against its dispatched agent (confirm/disavow
        counters only — they were tallied as matched when provisionally
        routed, and their execution is not moved).  The remaining decisions
        are this batch's requests, each counted exactly once as matched or
        unmatched — spill rescues land directly in matched, so a rescued
        request never transits the unmatched tally.
        """
        for d0, d1 in zip(prov, decisions[:shadow]):
            if d1 is not None and d1.agent_id == d0.agent_id:
                self.accounts["incremental_confirmed"] += 1
            else:
                self.accounts["incremental_rerouted"] += 1
        out = decisions[shadow:]
        matched = sum(1 for d in out if d is not None
                      and d.agent_id is not None)
        self.accounts["matched"] += matched
        self.accounts["unmatched"] += len(out) - matched
        return out

    def route_incremental(self, requests: list[Request], telemetry: dict,
                          free_slots: dict | None = None
                          ) -> list[RouteDecision]:
        """Mid-window arrivals bid directly into the standing duals.

        Each request is routed greedily at posted prices: against every
        live agent of its hub, agent i's next provisional unit is offered
        at the standing dual ``asks[i][k]`` (k = units already provisionally
        taken from i this window, so repeated arrivals walk up the agent's
        ascending price vector exactly like auction bids would); the
        request takes the agent maximizing ``w_ij − ask`` when that profit
        is positive, paying predicted cost + the posted ask.  The route is
        PROVISIONAL: the next :meth:`route_batch` re-equilibrates the
        window's market with the provisionals as shadow participants and
        confirms or disavows each one.

        Requests that cannot be routed provisionally — warm starts
        disabled, no fresh duals for their hub, no free unit left at a
        posted price, or no positive profit — come back with ``agent_id
        None`` and are NOT tallied as unmatched: they are deferred to the
        next batch auction, which owns their accounting.
        """
        if not requests:
            return []
        misses = [RouteDecision(r, None, 0.0, None, 0.0, -1)
                  for r in requests]
        live = [a for a in self.agents if a.agent_id not in self.quarantined]
        if not live or not self.warm_start:
            return misses
        with self._phase("phase1_predict"):
            lat, cst, qual, values, X, xs = self._phase1(requests, live,
                                                         telemetry)
        w = np.asarray(values, dtype=np.float64) - np.asarray(
            cst, dtype=np.float64)
        w = np.where(w > 0, w, 0.0)
        live_pos = {a.agent_id: i for i, a in enumerate(live)}
        hub_agents: dict[int, list[int]] = {}
        for h, hub in enumerate(self.hubs):
            for gi in hub.agent_indices:
                aid = self.agents[gi].agent_id
                if aid in live_pos:
                    hub_agents.setdefault(h, []).append(live_pos[aid])
        asks_of: dict[int, dict | None] = {}
        decisions: list[RouteDecision] = []
        for j, r in enumerate(requests):
            h = route_to_hub(r.domain, self.hubs,
                             [a.domains for a in self.agents])
            a_idx = sorted(hub_agents.get(h, []))
            if h not in asks_of:
                asks_of[h] = None
                if a_idx:
                    with self._phase("price_book"):
                        version, ids = self.agent_set_version.fingerprint(
                            live[i].agent_id for i in a_idx)
                        asks_of[h] = self.price_book.posted_asks(
                            h, version, ids,
                            [live[i].capacity for i in a_idx])
            asks = asks_of[h]
            if asks is None:
                decisions.append(misses[j])
                continue
            best = None          # (profit, live index, posted ask)
            for i in a_idx:      # ascending i: ties keep the lowest index
                aid = live[i].agent_id
                k = self._prov_units.get(aid, 0)
                free = (free_slots or {}).get(aid, live[i].capacity) - k
                prev = asks.get(aid)
                if free <= 0 or prev is None or k >= len(prev):
                    continue
                profit = float(w[j, i]) - float(prev[k])
                if profit > 0.0 and (best is None or profit > best[0]):
                    best = (profit, i, float(prev[k]))
            if best is None:
                decisions.append(misses[j])
                continue
            _, i, ask = best
            agent = live[i]
            if xs is None:
                x = PredictorInput(*(float(v) for v in X[j, i]))
                est = QoSEstimate(float(lat[j, i]), float(cst[j, i]),
                                  float(qual[j, i]))
            else:
                x, est = xs[j][i]
            pay = float(cst[j, i]) + ask
            d = RouteDecision(r, agent.agent_id, pay, est, float(w[j, i]), h)
            decisions.append(d)
            self._pending[r.request_id] = (x, agent, r, pay,
                                           float(cst[j, i]))
            self._provisional[r.request_id] = d
            self._prov_units[agent.agent_id] = \
                self._prov_units.get(agent.agent_id, 0) + 1
            self.accounts["matched"] += 1
            self.accounts["incremental_routed"] += 1
        return decisions

    # ---------------- Phase 4: feedback ----------------
    def on_complete(self, request_id: str, obs: CompletionObs) -> None:
        """Phase 4: predictor/ledger updates + market accounting (or the
        fault path: quarantine, no payment) for one completed request."""
        entry = self._pending.pop(request_id, None)
        # a provisional that completed before the next batch auction needs no
        # re-equilibration: retire it and release its provisional unit
        prov = self._provisional.pop(request_id, None)
        if prov is not None and prov.agent_id is not None:
            k = self._prov_units.get(prov.agent_id, 0) - 1
            if k > 0:
                self._prov_units[prov.agent_id] = k
            else:
                self._prov_units.pop(prov.agent_id, None)
        if entry is None:
            return
        x, agent, req, payment, pred_cost = entry
        if obs.failed:
            # fault path: no payment, quarantine the agent; the request is
            # re-auctioned by the cluster layer.
            self.quarantine(agent.agent_id)
            if self.settlement is not None:
                rep = (self.pool[agent.agent_id].reputation
                       if agent.agent_id in self.pool else 1.0)
                self.settlement.append(
                    kind="fault", request_id=request_id,
                    agent_id=agent.agent_id,
                    reputation_before=rep, reputation_after=rep)
            return
        if agent.agent_id not in self.pool:
            # churn: the agent left between dispatch and completion — no
            # predictor to teach and nothing to settle against (the cluster
            # keeps the ground-truth record; accounts and ledger stay
            # consistent by both skipping the orphan)
            return
        cost = observed_cost(agent.prices, obs.n_prompt, obs.n_hit, obs.n_gen)
        pred = self.pool[agent.agent_id]
        rep_before = pred.reputation
        # settlement audit channel: when ground truth rides along, settle
        # value at the audited quality and charge the inflation residual to
        # the agent's reputation; a None channel reproduces the pre-audit
        # router bit for bit (audited == reported, no residual update)
        audited_q = (obs.quality if obs.audit_quality is None
                     else float(obs.audit_quality))
        if self.use_reputation and obs.audit_quality is not None:
            pred.note_residual(max(0.0, obs.quality - audited_q))
        pred.update(x, obs.latency, cost, obs.quality)
        pred.ewma_gen = 0.9 * pred.ewma_gen + 0.1 * obs.n_gen
        # eviction resync (Appendix C.2.2): the engine reported zero cached
        # tokens despite a confident ledger match -> the backend evicted its
        # KV; drop our record so affinity reflects reality next round.  DAG
        # steps live under their own session key; the confident match may
        # have come from a parent entry (parent_credit), so drop those too.
        sess = req.meta.get("session", req.dialogue_id)
        if obs.n_hit == 0 and x.affinity > 0.3:
            self.ledger.evict(agent.agent_id, sess)
            for ps in req.meta.get("parent_sessions", ()):
                self.ledger.evict(agent.agent_id, ps)
        self.ledger.update(agent.agent_id, sess, req.tokens)
        # market accounting (weak budget balance bookkeeping, Thm 4.3);
        # realized value settles at the AUDITED quality when available
        true_value = client_value(audited_q, obs.latency, self.valuation)
        self.accounts["payments"] += payment
        self.accounts["agent_costs"] += cost
        self.accounts["surplus"] += payment - cost
        self.accounts["welfare_realized"] += float(true_value) - cost
        if self.settlement is not None:
            self.settlement.append(
                kind="settle", request_id=request_id,
                agent_id=agent.agent_id, payment=payment, cost=cost,
                reported_quality=float(obs.quality),
                audited_quality=float(audited_q),
                true_value=float(true_value),
                reputation_before=rep_before,
                reputation_after=pred.reputation)
