"""Simulated heterogeneous serving cluster with a virtual clock.

The port of the reference's `repro.serving.cluster`.  Engines run real
compute; the cluster adds queueing, heterogeneous hardware speeds,
stragglers and failures on a deterministic virtual clock.

Fault tolerance:
  * agent failure  -> request marked failed, agent quarantined, request
                      re-enqueued and re-auctioned next round;
  * recovery       -> quarantined agents reinstate after a cooldown;
  * stragglers     -> per-agent slowdown spikes; the router's latency
                      predictor learns them and prices them out;
  * elastic scale  -> add_agent/remove_agent rebuild hubs + predictor pool.

Engine modes: ``engine_mode="real"`` (default) runs the reduced models of
``_engine_config`` (`repro_torch.serving.engine.AgentEngine`, measured
compute) on the cluster's ``device`` — ``"cuda"`` by default, where every
prefill and decode step launches the hand-written attention kernels, or
``"cpu"`` with their plain versions; ``"analytic"`` swaps in
`repro_torch.serving.analytic.AnalyticEngine` (roofline service times, on
the host), enabling the 128-agent / 10k-dialogue scale runs of
`repro_torch.serving.simulator`.  In analytic mode only the router uses the
device (`make_router` builds it on ``cluster.device``).

`run_workload` below is the closed-loop, fixed-population oracle loop; the
event-driven open-loop driver lives in
`repro_torch.serving.simulator.EventSimulator` and reproduces this loop's
decisions bit-for-bit under synchronous arrivals.  Both keep the
reference's order of draws (the failure draw, then the straggle draw, on
``self.rng``; the evaluator's generator seeded ``seed + 1``; engine seeds
``crc32(agent_id)``), its ``_seq`` tie-break on the completion heap and its
float expressions, so an analytic cluster gives the reference's results bit
for bit (tests/torch_port/test_torch_cluster.py).
"""
from __future__ import annotations

import heapq
import warnings
import zlib
from collections import Counter, deque
from dataclasses import dataclass, field, replace

import numpy as np

from repro_torch.configs import get_config
from repro_torch.configs.iemas_cluster import (DEFAULT_ROUTER, MODEL_CLASSES,
                                               AgentProfile, RouterConfig,
                                               agent_profiles)
from repro_torch.core.adversary import AdversaryMix, AdversaryPolicy
from repro_torch.core.mechanism import (AgentInfo, CompletionObs,
                                        IEMASRouter, Request)
from repro_torch.core.pricing import TokenPrices
from repro_torch.serving.analytic import AnalyticEngine
from repro_torch.serving.engine import AgentEngine
from repro_torch.serving.evaluator import SimulatedSkillEvaluator
from repro_torch.serving.telemetry import TelemetryTracker
from repro_torch.serving.workload import DialogueScript
from repro_torch.utils.device import resolve_device
from repro_torch.utils.timing import phase_scope


def _engine_config(model_class: str, vocab: int):
    """The reduced dense model of one `MODEL_CLASSES` entry, derived from
    ``qwen3-8b`` in float32 as the reference's cluster derives it."""
    n_layers, d_model, n_heads, d_ff, _scale = MODEL_CLASSES[model_class]
    base = get_config("qwen3-8b").scaled(dtype="float32")
    return replace(
        base, name=f"engine-{model_class}", n_layers=n_layers, d_model=d_model,
        n_heads=n_heads, n_kv_heads=n_heads, head_dim=d_model // n_heads,
        d_ff=d_ff, vocab_size=vocab + 1, qk_norm=False)


@dataclass
class RequestRecord:
    """Ledger entry for one dispatched request (metrics + turn threading)."""

    request: Request
    agent_id: str
    dispatched_at: float
    ttft: float
    latency: float            # reported TTFT incl. queue + straggler effects
    cost: float
    n_prompt: int
    n_hit: int
    n_gen: int
    quality: float
    payment: float
    welfare_weight: float
    failed: bool = False
    # the engine's generated ids; run_workload threads them into the next
    # turn's prompt (dialogue causality, Appendix C.1)
    output_tokens: np.ndarray = field(
        default_factory=lambda: np.zeros(0, np.int32))


@dataclass
class AgentRuntime:
    """One live agent: published info + engine + fault-injection knobs."""

    info: AgentInfo
    profile: AgentProfile
    engine: AgentEngine
    fail_prob: float = 0.0
    straggle_prob: float = 0.0
    straggle_factor: float = 6.0
    down_until: float = -1.0


class SimCluster:
    """Heterogeneous simulated cluster: engines + queueing + faults on a
    deterministic virtual clock (see module docstring)."""

    def __init__(self, n_agents: int = 9, *, vocab: int = 255, seed: int = 0,
                 max_new_tokens: int = 6, fail_prob: float = 0.0,
                 straggle_prob: float = 0.0, cache_slots: int | None = None,
                 quarantine_cooldown: float = 30.0, warmup: bool = False,
                 engine_mode: str = "real",
                 adversary_mix: AdversaryMix | None = None,
                 profiles: list[AgentProfile] | None = None,
                 device="cuda"):
        if engine_mode not in ("real", "analytic"):
            raise ValueError(f"engine_mode must be real|analytic, "
                             f"got {engine_mode!r}")
        # where the real engines and (through make_router) the router run;
        # raises when CUDA is asked for and absent, in either engine mode
        self.device = resolve_device(device)
        self.rng = np.random.default_rng(seed)
        self.vocab = vocab
        self.engine_mode = engine_mode
        self.telemetry = TelemetryTracker()
        self.evaluator = SimulatedSkillEvaluator(seed=seed + 1)
        self.quarantine_cooldown = quarantine_cooldown
        # attached by serving-layer profilers (serving/simulator.py):
        # receives add_engine_compute() per dispatch + phase() around Phase 4
        self.profiler = None
        self.agents: dict[str, AgentRuntime] = {}
        # ``profiles`` overrides the generated population: federated shards
        # pass their partition of the GLOBAL agent_profiles() list so ids,
        # prices and engine seeds match the single-heap fleet exactly
        for prof in (profiles if profiles is not None
                     else agent_profiles(n_agents, seed=seed)):
            self._add_runtime(prof, fail_prob, straggle_prob, cache_slots,
                              max_new_tokens)
        # strategic-agent injection (core/adversary.py): policies keyed by
        # agent id mutate published profiles / Phase-4 reports / membership;
        # an empty dict (no mix, or fraction 0) is bit-identical honest play
        self.adversaries: dict[str, AdversaryPolicy] = (
            adversary_mix.assign([rt.info for rt in self.agents.values()])
            if adversary_mix is not None else {})
        if warmup:
            for rt in self.agents.values():
                rt.engine.warmup()
        self.records: list[RequestRecord] = []
        self.now = 0.0
        self._completions: list = []  # heap of (time, seq, record, router_obs)
        self._seq = 0

    def _add_runtime(self, prof: AgentProfile, fail_prob, straggle_prob,
                     cache_slots, max_new_tokens):
        eng_seed = zlib.crc32(prof.agent_id.encode()) % (2**31)
        if self.engine_mode == "analytic":
            engine = AnalyticEngine(
                prof.model_class, vocab=self.vocab, seed=eng_seed,
                speed=prof.speed, cache_slots=cache_slots or prof.cache_slots,
                max_new_tokens=max_new_tokens)
        else:
            cfg = _engine_config(prof.model_class, self.vocab)
            engine = AgentEngine(
                cfg, seed=eng_seed, speed=prof.speed,
                cache_slots=cache_slots or prof.cache_slots,
                max_new_tokens=max_new_tokens, device=self.device)
        info = AgentInfo(
            agent_id=prof.agent_id,
            prices=TokenPrices(prof.price_miss, prof.price_hit, prof.price_out),
            capacity=prof.capacity, domains=prof.domains, scale=prof.scale,
            recurrent=engine.recurrent, cache_slots=engine.cache_slots)
        self.agents[prof.agent_id] = AgentRuntime(
            info, prof, engine, fail_prob=fail_prob,
            straggle_prob=straggle_prob)

    # ---------------- elastic membership ----------------
    def agent_infos(self) -> list[AgentInfo]:
        """Published AgentInfo profiles of every live runtime.

        Strategic agents publish through their policy (a mutated COPY —
        e.g. misreported prices); everyone else publishes their true
        ``rt.info`` object itself, preserving the seed behavior where the
        router and cluster share one AgentInfo instance."""
        out = []
        for aid, rt in self.agents.items():
            pol = self.adversaries.get(aid)
            out.append(pol.publish(rt.info) if pol is not None else rt.info)
        return out

    def add_agent(self, profile: AgentProfile, router=None) -> None:
        """Elastic scale-out: spin up a runtime (and tell the router)."""
        self._add_runtime(profile, 0.0, 0.0, None, 6)
        if router is not None and hasattr(router, "add_agent"):
            router.add_agent(self.agents[profile.agent_id].info)

    def remove_agent(self, agent_id: str, router=None) -> None:
        """Elastic scale-in: drop a runtime (and tell the router)."""
        self.agents.pop(agent_id, None)
        if router is not None and hasattr(router, "remove_agent"):
            router.remove_agent(agent_id)

    def adversary_tick(self, router) -> None:
        """Give every strategic agent its per-round action hook (churn
        policies flap membership/capacity/quarantine here).  A no-op when
        no adversaries are assigned, so honest serving loops keep their
        bit-exact lockstep parity."""
        if not self.adversaries:
            return
        for aid, pol in list(self.adversaries.items()):
            pol.tick(self, router, aid)

    # ---------------- serving rounds ----------------
    def free_slots(self) -> dict:
        """Per-agent free concurrency slots (capacity minus inflight)."""
        inflight = self.telemetry.agent_inflight
        return {aid: max(0, rt.info.capacity - inflight.get(aid, 0))
                for aid, rt in self.agents.items()}

    def execute(self, decision, router) -> RequestRecord | None:
        """Dispatch one routed request to its agent and schedule completion."""
        req = decision.request
        if decision.agent_id is None or decision.agent_id not in self.agents:
            return None
        rt = self.agents[decision.agent_id]
        self.telemetry.on_dispatch(rt.info.agent_id, self.now)

        # failure injection
        if rt.down_until > self.now or self.rng.random() < rt.fail_prob:
            rt.down_until = max(rt.down_until, self.now + self.quarantine_cooldown)
            rec = RequestRecord(req, rt.info.agent_id, self.now, 0.0, 0.0, 0.0,
                                len(req.tokens), 0, 0, 0.0, 0.0,
                                decision.welfare_weight, failed=True)
            obs = CompletionObs(0.0, len(req.tokens), 0, 0, 0.0, failed=True)
            heapq.heappush(self._completions,
                           (self.now + 0.05, self._seq, rec, obs))
            self._seq += 1
            return rec

        # DAG steps serve under their own session key with parent-session
        # fork candidates (handoff prefix reuse); linear requests carry no
        # such meta and serve under the dialogue id exactly as before.
        session = req.meta.get("session", req.dialogue_id)
        result = rt.engine.serve(session, req.tokens, now=self.now,
                                 max_new_tokens=req.max_new_tokens,
                                 parents=req.meta.get("parent_sessions", ()))
        queue = self.telemetry.agent_inflight.get(rt.info.agent_id, 1) - 1
        straggle = (rt.straggle_factor
                    if self.rng.random() < rt.straggle_prob else 1.0)
        latency = result.ttft * straggle + 0.001 * max(0, queue)
        total = result.total_time * straggle + 0.001 * max(0, queue)

        dom_match = req.domain in rt.info.domains
        difficulty = float(req.meta.get("difficulty", 0.5))
        quality = self.evaluator.score(rt.info.scale, dom_match, difficulty)

        cost = (rt.info.prices.miss * (result.n_prompt - result.n_hit)
                + rt.info.prices.hit * result.n_hit
                + rt.info.prices.out * result.n_gen)
        rec = RequestRecord(req, rt.info.agent_id, self.now, result.ttft,
                            latency, cost, result.n_prompt, result.n_hit,
                            result.n_gen, quality, decision.payment,
                            decision.welfare_weight,
                            output_tokens=result.output_tokens)
        obs = CompletionObs(latency, result.n_prompt, result.n_hit,
                            result.n_gen, quality)
        if self.adversaries:
            # adversarial run: every Phase-4 report flows through a policy
            # (strategic agents may lie; honest ones attach the audit truth,
            # whose zero residual is reputation-neutral by construction)
            pol = self.adversaries.get(rt.info.agent_id)
            obs = (pol.report(obs, quality) if pol is not None
                   else replace(obs, audit_quality=quality))
        self.telemetry.on_busy(rt.info.agent_id, total)
        if self.profiler is not None:
            # virtual engine seconds — the overhead-attribution denominator
            self.profiler.add_engine_compute(total)
        heapq.heappush(self._completions, (self.now + total, self._seq, rec, obs))
        self._seq += 1
        return rec

    def next_completion_time(self) -> float | None:
        """Virtual time of the earliest scheduled completion (event hook)."""
        return self._completions[0][0] if self._completions else None

    def advance(self, dt: float, router) -> list[RequestRecord]:
        """Advance the virtual clock by ``dt``, delivering completions."""
        return self.advance_to(self.now + dt, router)

    def advance_to(self, t: float, router) -> list[RequestRecord]:
        """Advance the clock to absolute virtual time ``t`` (>= now),
        delivering every completion due by then to the router.

        The event simulator jumps straight to the next event with this hook
        (setting ``now`` exactly, no float drift against heap timestamps);
        the closed-loop ``advance`` above is a thin wrapper.
        """
        self.now = max(self.now, float(t))
        done = []
        while self._completions and self._completions[0][0] <= self.now:
            _, _, rec, obs = heapq.heappop(self._completions)
            self.telemetry.on_complete(rec.agent_id, self.now)
            with phase_scope(self.profiler, "phase4_feedback"):
                router.on_complete(rec.request.request_id, obs)
            if not rec.failed:
                self.records.append(rec)
            done.append(rec)
        # reinstate recovered agents
        if hasattr(router, "reinstate"):
            for aid, rt in self.agents.items():
                if 0 <= rt.down_until <= self.now:
                    router.reinstate(aid)
                    rt.down_until = -1.0
        return done

    # ---------------- metrics ----------------
    def metrics(self) -> dict:
        """Aggregate request-level metrics over completed (non-failed)
        records: KV hit rate, latency, cost, quality."""
        if not self.records:
            return {"n": 0}
        hits = np.array([r.n_hit / max(1, r.n_prompt) for r in self.records])
        lat = np.array([r.latency for r in self.records])
        cost = np.array([r.cost for r in self.records])
        qual = np.array([r.quality for r in self.records])
        return {
            "n": len(self.records),
            "kv_hit_rate": float(hits.mean()),
            "latency_ms_median": float(np.median(lat) * 1e3),
            "latency_ms_mean": float(lat.mean() * 1e3),
            "latency_ms_p95": float(np.percentile(lat, 95) * 1e3),
            "cost_mean": float(cost.mean()),
            "quality_mean": float(qual.mean()),
        }


def make_router(cluster: SimCluster, config: RouterConfig | None = None,
                **overrides) -> IEMASRouter:
    """Build the IEMAS router for a cluster from a RouterConfig, on
    ``cluster.device`` unless ``device=`` is among the overrides.

    ``overrides`` land on top of the config and are passed straight to
    IEMASRouter (e.g. ``solver="dense"``, ``predictor_kw={...}``), so the
    Phase-2 solver choice threads from configs/CLI down to run_auction."""
    kwargs = (config or DEFAULT_ROUTER).router_kwargs()
    kwargs["device"] = cluster.device
    kwargs.update(overrides)
    return IEMASRouter(cluster.agent_infos(), **kwargs)


def run_workload(cluster: SimCluster, router, dialogues: list[DialogueScript],
                 *, round_dt: float = 0.05, max_rounds: int = 4000,
                 batch_per_round: int = 16, max_new_tokens: int = 6,
                 on_round=None) -> dict:
    """Drive multi-turn dialogues through router+cluster to completion.

    Dialogue causality: turn t+1 is issued only after turn t completes, with
    the engine's actual answer appended to the conversation (Appendix C.1).

    Fairness: ready dialogues queue through a FIFO deque ordered by when
    their turn became ready — a request skipped by the ``batch_per_round``
    cap keeps its place at the head next round.  (The seed scanned the
    ``state`` dict in insertion order every round and broke at the cap, so
    late-inserted dialogues were starved whenever the ready count exceeded
    it.)  Requests the auction leaves unmatched return to the *front* of
    the queue in order; failed requests re-enter at the back when their
    failure is delivered, like any other newly-ready turn.

    Truncation: exhausting ``max_rounds`` is no longer silent — the result
    carries ``unfinished_dialogues`` / ``completed_turns`` / ``truncated``
    and a ``RuntimeWarning`` fires, so scaled runs cannot quietly drop the
    tail of the latency distribution.  ``dispatched_requests`` and the
    ``requests_per_dialogue_*`` stats attribute dispatch counts (including
    fault-path retries) per dialogue.

    This loop is the closed-loop oracle: `repro_torch.serving.simulator` must
    reproduce its decisions bit-for-bit under synchronous arrivals.
    """
    for d in dialogues:
        if not isinstance(d, DialogueScript):
            raise TypeError(
                f"run_workload drives linear DialogueScripts only; got "
                f"{type(d).__name__} for {getattr(d, 'dialogue_id', '?')!r} — "
                f"DAG workloads need repro_torch.serving.simulator."
                f"EventSimulator")
    state = {d.dialogue_id: {"script": d, "turn": 0, "history": np.zeros(0, np.int32),
                             "busy": False} for d in dialogues}
    pending_next: dict[str, np.ndarray] = {
        d.dialogue_id: d.turns[0] for d in dialogues}
    ready: deque[str] = deque(d.dialogue_id for d in dialogues)
    rid = 0
    rounds = 0
    # per-dialogue dispatch attribution (includes fault-path retries); this
    # replaces the seed's write-only record_of dict
    dispatch_count: Counter = Counter()
    dispatched = 0
    while rounds < max_rounds:
        rounds += 1
        # collect up to batch_per_round ready requests (micro-batching,
        # C.2.1), FIFO by readiness time
        batch = []
        while ready and len(batch) < batch_per_round:
            did = ready.popleft()
            st = state[did]
            script = st["script"]
            prompt = np.concatenate([st["history"], pending_next[did]])
            batch.append(Request(request_id=f"r{rid}", dialogue_id=did,
                                 tokens=prompt.astype(np.int32), turn=st["turn"],
                                 domain=script.domain,
                                 max_new_tokens=max_new_tokens,
                                 meta={"difficulty": script.difficulty}))
            rid += 1
        if batch:
            telem = cluster.telemetry.snapshot(cluster.now)
            decisions = router.route_batch(batch, telem,
                                           free_slots=cluster.free_slots())
            unmatched = []
            for dec in decisions:
                did = dec.request.dialogue_id
                if dec.agent_id is None:
                    unmatched.append(did)  # retry, keeping queue priority
                    continue
                if cluster.execute(dec, router) is None:
                    # dead dispatch target (agent removed from the cluster
                    # but not the router): report it as a failure so the
                    # router quarantines it and clears its pending entry,
                    # instead of re-matching the same dead agent forever
                    router.on_complete(dec.request.request_id, CompletionObs(
                        0.0, len(dec.request.tokens), 0, 0, 0.0, failed=True))
                    unmatched.append(did)
                    continue
                state[did]["busy"] = True
                dispatch_count[did] += 1
                dispatched += 1
            ready.extendleft(reversed(unmatched))
        done = cluster.advance(round_dt, router)
        for rec in done:
            did = rec.request.dialogue_id
            st = state[did]
            st["busy"] = False
            if rec.failed:
                ready.append(did)  # re-issue the same turn next round
                continue
            new_user = pending_next.pop(did)
            st["history"] = np.concatenate(
                [st["history"], new_user, rec.output_tokens]).astype(np.int32)
            st["turn"] += 1
            script = st["script"]
            if st["turn"] < len(script.turns):
                pending_next[did] = script.turns[st["turn"]]
                ready.append(did)
        # strategic-agent round hook (no-op without an adversary mix)
        cluster.adversary_tick(router)
        if not pending_next and not any(st["busy"] for st in state.values()):
            break
        if on_round is not None:
            on_round(rounds, cluster)
    out = cluster.metrics()
    out["rounds"] = rounds
    out["completed_turns"] = sum(st["turn"] for st in state.values())
    # a dialogue is unfinished iff a turn of it is still pending (waiting,
    # in the ready queue, or in flight when the round budget ran out)
    out["unfinished_dialogues"] = len(pending_next)
    out["truncated"] = bool(pending_next)
    out["dispatched_requests"] = dispatched
    if dispatch_count:
        # same definition as EventSimulator: mean over dialogues that were
        # actually dispatched (identical when nothing truncated)
        out["requests_per_dialogue_mean"] = dispatched / len(dispatch_count)
        out["requests_per_dialogue_max"] = max(dispatch_count.values())
    if pending_next:
        warnings.warn(
            f"run_workload: round budget ({max_rounds}) exhausted with "
            f"{len(pending_next)}/{len(state)} dialogues unfinished "
            f"({out['completed_turns']} turns completed); metrics cover "
            f"completed requests only", RuntimeWarning, stacklevel=2)
    # warm-start effectiveness (IEMASRouter only): how often a hub's auction
    # was seeded from the previous round's slot prices vs cold-started
    book = getattr(router, "price_book", None)
    if book is not None and getattr(router, "warm_start", False):
        out["warm_start"] = book.stats()
    return out
