"""Hubs-of-hubs federation: S super-hub shards + epoch-synchronized markets.

One level above `EventSimulator`: the fleet is partitioned into S
super-hubs (`repro_torch.core.hub.cluster_super_hubs`), each owning its own
`IEMASRouter` (with its own inner proxy hubs and `SlotPriceBook`), its
own `SimCluster` shard of the agent fleet, and its own independently-
advancing `ShardEventLoop` event heap.  `FederatedSimulator` drives the
shards through synchronization **epochs**:

  1. **advance** — every shard processes its own events up to the epoch
     boundary, with no cross-shard communication (this is what the
     process-parallel path overlaps across cores —
     `repro_torch.distributed.federation.ProcessShardHandle`);
  2. **gossip** — each shard cuts a `GossipDigest` (per-agent free
     slack + standing `SlotPriceBook` asks, epoch-stamped so staleness
     is measurable; cold books gossip price-0 asks — the same
     capacity-keyed cold-start rule the book applies locally);
  3. **spill** — dialogues stuck in a shard's ready queue at least
     ``spill_min_wait`` re-auction against the gossiped REMOTE slack:
     one `run_auction` over (residuals x remote agents), valued by the
     structural cold-start prior alone (affinity 0 remotely, a domain-
     mismatch discount on prior quality) minus a flat dispatch penalty
     — `run_sharded_auction(spill=True)` generalized one level up, with
     the penalty keeping KV-affinity anchored to the home shard;
  4. **migrate** — winners hand their session state to the destination
     shard exactly once (`ShardEventLoop.extract_dialogue` /
     `admit_migrant`: only dialogues with zero in-flight work move, the
     arrival stays counted at home, the completion settles wherever the
     dialogue finishes, and per-shard request-id prefixes keep the
     settlement ledgers globally collision-free).

Bit-exact oracle: at S=1 the single shard runs with INTERNAL arrivals —
the same lazy pull path as `EventSimulator` — and epoch boundaries are
pure pauses (`advance_until` never touches a clock), so the federated
run replays the exact event sequence, decisions, accounts and ledger
head of today's single-heap simulator (tests/torch_port/
test_torch_federation.py, which also holds the S > 1 runs against the
reference package's federation).

Device: every shard's router runs on the ``device`` given to
`build_federation` (the card by default: its `lcp_gather` and
`auction_solve` kernels launch once per batch in each shard), inline in
this process or in one spawned process per shard with its own CUDA
context.  The federation's own work — gossip, the spill round's
float64 `dense` auction and migration — stays on the host.
"""
from __future__ import annotations

import math
import time
import warnings
from collections import defaultdict
from contextlib import contextmanager

import numpy as np

from repro_torch.core.hub import (AgentAsk, GossipBook, GossipDigest,
                                  SuperHub, cluster_super_hubs,
                                  route_to_super_hub)
from repro_torch.core.auction import run_auction
from repro_torch.core.valuation import ValuationConfig, client_value
from repro_torch.serving.simulator import RoutingProfiler, ShardEventLoop
from repro_torch.serving.workload import SyncArrivals
from repro_torch.utils.device import resolve_device

__all__ = ["InlineShard", "FederatedSimulator", "build_federation"]

#: structural-prior constants shared with `AgentPredictor` defaults — the
#: federation prices remote bids from gossiped metadata only, so it uses
#: the same cold-start latency model the shard predictors would
PRIOR_LPT, PRIOR_LB, PRIOR_Q = 1e-3, 0.02, 0.6


class InlineShard:
    """One federation shard in-process: (cluster, router, loop) + control API.

    The control surface (`start`/`inject`/`advance`/`digest`/`residuals`/
    `extract`/`admit`/`close_arrivals`/`finalize`) is exactly what
    `repro_torch.distributed.federation.ProcessShardHandle` proxies over a
    pipe, so `FederatedSimulator` treats inline and process shards
    identically.
    """

    def __init__(self, super_id: int, cluster, router,
                 loop: ShardEventLoop):
        self.super_id = int(super_id)
        self.cluster = cluster
        self.router = router
        self.loop = loop

    @classmethod
    def from_spec(cls, spec, dialogues=(), arrivals=None,
                  external: bool = True) -> "InlineShard":
        """Materialize a shard from a picklable `ShardSpec`.

        Both the inline and the worker-process paths build through here,
        which is what keeps them bit-identical.  ``external=False`` (the
        S=1 oracle) hands the loop the global ``dialogues``/``arrivals``
        stream directly — the exact `EventSimulator` pull path — and
        drops the request-id prefix for ledger-head parity.
        ``spec.loop_kwargs["profile"]`` is True (the default: a
        `RoutingProfiler`), False (none) or a picklable zero-argument
        factory of a `RoutingProfiler` (a measurement hook, built inside
        the shard's own process).
        """
        from repro_torch.core.mechanism import IEMASRouter
        from repro_torch.serving.cluster import SimCluster

        cluster = SimCluster(profiles=spec.profiles, seed=spec.seed,
                             device=spec.device, **spec.cluster_kwargs)
        router = IEMASRouter(cluster.agent_infos(), device=cluster.device,
                             **spec.router_kwargs)
        lkw = dict(spec.loop_kwargs)
        profile = lkw.pop("profile", True)
        profiler = (profile() if callable(profile)
                    else RoutingProfiler() if profile else None)
        loop = ShardEventLoop(
            cluster, router, dialogues, arrivals=arrivals,
            profiler=profiler,
            rid_prefix=f"s{spec.super_id}:" if external else "",
            external_arrivals=external, **lkw)
        return cls(spec.super_id, cluster, router, loop)

    # ---------------- control surface ----------------
    def start(self) -> None:
        """Idempotent initial scheduling (delegates to the loop)."""
        self.loop.start()

    def is_external(self) -> bool:
        """True when this shard is fed by the parent (`inject`)."""
        return self.loop._external

    def inject(self, items: list[tuple[float, object]]) -> None:
        """Feed this epoch's home-routed arrivals: ``[(t, script), ...]``."""
        for t, script in items:
            self.loop.inject_arrival(t, script)

    def close_arrivals(self) -> None:
        """Parent signal: the global dialogue stream is exhausted."""
        self.loop.close_arrivals()

    def advance(self, t_end: float | None) -> dict:
        """Advance the shard's event loop to the epoch boundary."""
        before = self.loop._n_processed
        self.loop.advance_until(t_end)
        return {"work": self.loop._work_remains(),
                "stopped": self.loop._stopped,
                "truncated": self.loop._truncated_reason,
                "processed": self.loop._n_processed - before,
                "now": self.cluster.now}

    def residuals(self, now: float, min_wait: float,
                  max_migrations: int = 2) -> list[dict]:
        """Spill candidates (delegates to `ShardEventLoop.residual_units`)."""
        return self.loop.residual_units(now, min_wait,
                                        max_migrations=max_migrations)

    def extract(self, dialogue_ids: list[str]) -> list:
        """Surrender the listed dialogues' state for migration."""
        return [self.loop.extract_dialogue(d) for d in dialogue_ids]

    def admit(self, migrants: list, t: float) -> None:
        """Adopt migrated dialogues at virtual time ``t``."""
        for st in migrants:
            self.loop.admit_migrant(st, t)

    def digest(self, epoch: int) -> GossipDigest:
        """Cut this shard's epoch-stamped gossip payload.

        Standing asks come out of the shard's `SlotPriceBook` under the
        SAME staleness contract `route_incremental` applies locally
        (agent-set version + exact live-id tuple + published
        capacities); hubs whose entry is stale or cold contribute empty
        ask vectors — the price-0 free-unit boundary.
        """
        cluster, router = self.cluster, self.router
        free = cluster.free_slots()
        telem = cluster.telemetry.snapshot(cluster.now)
        inflight = telem.get("agent_inflight", {})
        asks_map: dict[str, np.ndarray] = {}
        book = getattr(router, "price_book", None)
        if book is not None and getattr(router, "warm_start", False):
            live_ids = {a.agent_id for a in router.agents
                        if a.agent_id not in router.quarantined}
            for h, hub in enumerate(router.hubs):
                hub_live = [router.agents[gi] for gi in hub.agent_indices
                            if router.agents[gi].agent_id in live_ids]
                if not hub_live:
                    continue
                version, ids = router.agent_set_version.fingerprint(
                    a.agent_id for a in hub_live)
                asks = book.posted_asks(h, version, ids,
                                        [a.capacity for a in hub_live])
                if asks:
                    for aid, vec in asks.items():
                        asks_map[aid] = np.asarray(vec, dtype=np.float64)
        entries = []
        for a in router.agents:
            aid = a.agent_id
            if aid in router.quarantined:
                continue
            pred = router.pool[aid] if aid in router.pool else None
            entries.append(AgentAsk(
                agent_id=aid, free=int(free.get(aid, a.capacity)),
                capacity=int(a.capacity),
                price_miss=float(a.prices.miss),
                price_hit=float(a.prices.hit),
                price_out=float(a.prices.out),
                scale=float(a.scale), domains=tuple(a.domains),
                utilization=float(inflight.get(aid, 0.0))
                / max(1.0, float(a.capacity)),
                ewma_gen=(float(pred.ewma_gen) if pred is not None
                          else 32.0),
                asks=asks_map.get(aid, np.zeros(0))))
        return GossipDigest(super_id=self.super_id, epoch=int(epoch),
                            asks=entries)

    def finalize(self) -> dict:
        """Shard metrics + accounts + (optional) settlement-ledger audit."""
        out = self.loop._finalize(time.perf_counter() - self.loop._wall0)
        out["super_id"] = self.super_id
        out["n_agents"] = len(self.cluster.agents)
        out["rid_prefix"] = self.loop.rid_prefix
        if hasattr(self.router, "accounts"):
            out["accounts"] = dict(self.router.accounts)
        settlement = getattr(self.router, "settlement", None)
        if settlement is not None:
            ledger = {"head": settlement.head,
                      "entries": len(settlement.entries)}
            try:
                settlement.audit(self.router.accounts)
                ledger["ok"] = True
            except ValueError as e:     # replay divergence / broken chain
                ledger["ok"] = False
                ledger["error"] = str(e)
            out["ledger"] = ledger
        return out


class FederatedSimulator:
    """Advance S shard event loops between synchronization epochs.

    Parameters
    ----------
    shards : list of `InlineShard` / ``ProcessShardHandle``, positionally
        aligned with ``super_hubs``.
    super_hubs : the `SuperHub` partition (home-shard routing metadata).
    agent_domains : GLOBAL per-agent domain tuples (home-shard scoring).
    dialogues, arrivals : the global dialogue stream + arrival process;
        consumed by the parent and partitioned to external shards by
        `route_to_super_hub`.  Ignored when every shard feeds itself
        (the S=1 internal-arrivals oracle).
    epoch : virtual seconds between synchronization boundaries.
    spill / spill_penalty / spill_min_wait / mismatch_discount /
    max_migrations : cross-super-hub spill knobs — the flat dispatch
        penalty keeps KV-affinity anchored at home, the quality discount
        prices domain mismatch, ``spill_min_wait`` (default: one epoch)
        is how long a dialogue must starve before it may emigrate.
    gossip_every : epochs between digest refreshes (1 = every boundary,
        which bounds consumed staleness at one epoch).
    shard_schedule : optional permutation (or callable ``epoch ->
        permutation``) of shard indices fixing the advance order —
        results are bit-identical under ANY schedule (seed-split RNGs,
        tests/test_federation.py), so this exists to PROVE it, not to
        tune it.
    quantize : forwarded epoch alignment for lockstep shards (the
        boundary itself never needs alignment — pauses are pure).
    device : where the spill round's auction is asked to run; its
        ``dense`` solver is the float64 host backend, as in the reference,
        so nothing of the federation's own work moves to the card (raises
        for ``"cuda"`` without a card, as every entry point does).
    """

    def __init__(self, shards: list, super_hubs: list[SuperHub],
                 agent_domains: list[tuple[str, ...]], dialogues=None, *,
                 arrivals=None, epoch: float = 0.25,
                 spill: bool = True, spill_penalty: float = 0.5,
                 spill_min_wait: float | None = None,
                 mismatch_discount: float = 0.5, max_migrations: int = 2,
                 gossip_every: int = 1,
                 valuation: ValuationConfig | None = None,
                 payment_mode: str = "warmstart",
                 shard_schedule=None, max_epochs: int = 1_000_000,
                 device="cuda"):
        if len(shards) != len(super_hubs):
            raise ValueError(f"{len(shards)} shards vs {len(super_hubs)} "
                             "super-hubs")
        self.device = resolve_device(device)
        self.shards = shards
        self.super_hubs = super_hubs
        self._agent_domains = list(agent_domains)
        self.epoch = float(epoch)
        if self.epoch <= 0:
            raise ValueError(f"epoch must be > 0, got {epoch}")
        self.spill = bool(spill) and len(shards) > 1
        self.spill_penalty = float(spill_penalty)
        self.spill_min_wait = (float(spill_min_wait)
                               if spill_min_wait is not None else self.epoch)
        self.mismatch_discount = float(mismatch_discount)
        self.max_migrations = int(max_migrations)
        self.gossip_every = max(1, int(gossip_every))
        self.valuation = valuation or ValuationConfig()
        self.payment_mode = payment_mode
        self.max_epochs = int(max_epochs)
        self._schedule = shard_schedule
        self.gossip = GossipBook()

        self._external = [h.is_external() for h in shards]
        self._stream_open = any(self._external)
        self._buffered: tuple[float, object] | None = None
        self._dialogue_iter = iter(dialogues if dialogues is not None else ())
        self._arrivals = arrivals if arrivals is not None else SyncArrivals()
        self._arrival_times = self._arrivals.times()
        self._truncated_reason: str | None = None
        self.n_fed = 0
        self.epochs = 0
        self.spill_candidates = 0
        self.spill_migrated = 0
        self._fed_phases: dict[str, list] = {}  # name -> [wall_s, calls]

    # ---------------- internals ----------------
    @contextmanager
    def _phase(self, name: str):
        """Accumulate federation-level wall-clock (gossip/spill/migrate)."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            slot = self._fed_phases.setdefault(name, [0.0, 0])
            slot[0] += time.perf_counter() - t0
            slot[1] += 1

    def _order(self, epoch_idx: int) -> list[int]:
        """Shard advance order this epoch (any order is bit-equivalent)."""
        if self._schedule is None:
            return list(range(len(self.shards)))
        sched = (self._schedule(epoch_idx) if callable(self._schedule)
                 else self._schedule)
        order = [int(k) for k in sched]
        if sorted(order) != list(range(len(self.shards))):
            raise ValueError(f"shard_schedule {order} is not a permutation "
                             f"of range({len(self.shards)})")
        return order

    def _feed_arrivals(self, t_end: float) -> None:
        """Partition global arrivals with ``t <= t_end`` to home shards."""
        if not self._stream_open:
            return
        batches: dict[int, list] = defaultdict(list)
        while True:
            if self._buffered is None:
                script = next(self._dialogue_iter, None)
                if script is None:
                    self._close_stream()
                    break
                t = next(self._arrival_times, None)
                if t is None:
                    # zip semantics, same loud truncation as the loop's
                    # internal pull path
                    self._truncated_reason = ("arrival process exhausted "
                                              "before the dialogue stream")
                    self._close_stream()
                    break
                self._buffered = (max(float(t), 0.0), script)
            t, script = self._buffered
            if t > t_end:
                break                   # held for a later epoch
            self._buffered = None
            k = route_to_super_hub(script.domain, self.super_hubs,
                                   self._agent_domains)
            batches[k].append((t, script))
            self.n_fed += 1
        for k in sorted(batches):
            self.shards[k].inject(batches[k])

    def _close_stream(self) -> None:
        self._stream_open = False
        for h, ext in zip(self.shards, self._external):
            if ext:
                h.close_arrivals()

    def _advance_all(self, order: list[int], t_end: float) -> dict:
        """One epoch of shard advances; process shards overlap for real."""
        statuses: dict[int, dict] = {}
        for k in order:
            h = self.shards[k]
            if hasattr(h, "advance_async"):
                h.advance_async(t_end)
        for k in order:
            h = self.shards[k]
            statuses[k] = h.wait() if hasattr(h, "advance_async") \
                else h.advance(t_end)
        return statuses

    def _spill_round(self, epoch_idx: int, t_end: float) -> list:
        """Re-auction stuck residuals against gossiped remote capacity.

        Returns migration moves ``(src_shard, dialogue_id, dst_shard)``.
        One `run_auction` prices every residual against every remote
        agent with free slack: value = Eq.-1 on the structural prior
        (affinity 0, domain-mismatch discount on prior quality) minus
        the flat dispatch penalty; cost = the Eq.-6 prior from gossiped
        prices; the warm seed replays each agent's gossiped ascending
        asks (price-0-padded — the cold-start boundary).
        """
        residuals = []                  # (src shard idx, summary row)
        for k, h in enumerate(self.shards):
            for row in h.residuals(t_end, self.spill_min_wait,
                                   self.max_migrations):
                residuals.append((k, row))
        if not residuals:
            return []
        self.spill_candidates += len(residuals)
        # one global remote-capacity column set from the consumed digests
        consumed: dict[int, GossipDigest] = {}
        for k in sorted({src for src, _ in residuals}):
            for d in self.gossip.fresh(k, epoch_idx):
                consumed.setdefault(d.super_id, d)
        cols: list[tuple[int, AgentAsk]] = []
        pos_of: dict[int, int] = {}     # super_id -> shard list position
        for pos, sh in enumerate(self.super_hubs):
            pos_of[sh.hub_id] = pos
        for sid in sorted(consumed):
            for ask in consumed[sid].asks:
                if ask.free > 0:
                    cols.append((pos_of[sid], ask))
        if not cols:
            return []
        n, m = len(residuals), len(cols)
        values = np.zeros((n, m))
        costs = np.zeros((n, m))
        for j, (src, row) in enumerate(residuals):
            pl = float(row["prompt_len"])
            for i, (owner, ask) in enumerate(cols):
                if owner == src:
                    continue            # home market owns its own agents
                prior_lat = (PRIOR_LB + PRIOR_LPT * pl) \
                    * (1.0 + ask.utilization)
                prior_cst = ask.price_miss * pl \
                    + ask.price_out * ask.ewma_gen
                q = PRIOR_Q if row["domain"] in ask.domains \
                    else PRIOR_Q * self.mismatch_discount
                values[j, i] = client_value(q, prior_lat, self.valuation) \
                    - self.spill_penalty
                costs[j, i] = prior_cst
        caps = [min(int(ask.free), n) for _, ask in cols]
        seed = np.concatenate([
            np.pad(np.asarray(ask.asks[:c], dtype=np.float64),
                   (0, c - min(len(ask.asks), c)))
            for (_, ask), c in zip(cols, caps)]) if cols else None
        result = run_auction(values, costs, caps,
                             payment_mode=self.payment_mode,
                             solver="dense", start_prices=seed,
                             device=self.device)
        moves = []
        for j, i in enumerate(result.assignment):
            if i >= 0 and result.weights[j, i] > 0.0:
                moves.append((residuals[j][0], residuals[j][1]["dialogue_id"],
                              cols[i][0]))
        return moves

    def _boundary(self, epoch_idx: int, t_end: float) -> list:
        """Epoch synchronization: gossip, spill, migrate."""
        if epoch_idx % self.gossip_every == 0:
            with self._phase("gossip"):
                for pos, h in enumerate(self.shards):
                    d = h.digest(epoch_idx)
                    self.gossip.publish(d)
                    # refresh the published free-capacity tie-breaker the
                    # home-shard classifier reads (route_to_hub contract)
                    self.super_hubs[pos].published["free_capacity"] = \
                        d.total_slack()
        if not self.spill:
            return []
        with self._phase("spill"):
            moves = self._spill_round(epoch_idx, t_end)
        if moves:
            with self._phase("migrate"):
                by_src: dict[int, list[str]] = defaultdict(list)
                dst_of: dict[str, int] = {}
                for src, did, dst in moves:
                    by_src[src].append(did)
                    dst_of[did] = dst
                for src in sorted(by_src):
                    migrants = self.shards[src].extract(by_src[src])
                    by_dst: dict[int, list] = defaultdict(list)
                    for st in migrants:
                        by_dst[dst_of[st.script.dialogue_id]].append(st)
                    for dst in sorted(by_dst):
                        self.shards[dst].admit(by_dst[dst], t_end)
            self.spill_migrated += len(moves)
        return moves

    # ---------------- main loop ----------------
    def run(self) -> dict:
        """Run the federation to completion and return merged metrics."""
        wall0 = time.perf_counter()
        for h in self.shards:
            h.start()
        epoch_idx = 0
        t_end = self.epoch
        while True:
            self._feed_arrivals(t_end)
            statuses = self._advance_all(self._order(epoch_idx), t_end)
            stopped = [k for k, s in statuses.items() if s["stopped"]]
            if stopped:
                k = stopped[0]
                self._truncated_reason = (
                    f"shard {k}: {statuses[k].get('truncated')}")
                break
            work = any(s["work"] for s in statuses.values()) \
                or self._buffered is not None or self._stream_open
            if not work:
                break
            if epoch_idx >= self.max_epochs:
                self._truncated_reason = f"max_epochs ({self.max_epochs})"
                break
            moves = self._boundary(epoch_idx, t_end)
            epoch_idx += 1
            idle = all(s["processed"] == 0 for s in statuses.values())
            if idle and not moves and self._buffered is not None \
                    and self._buffered[0] > t_end + self.epoch:
                # every shard is drained until the next global arrival:
                # jump the boundary there instead of spinning empty epochs
                t_end = self._buffered[0]
            else:
                t_end += self.epoch
        self.epochs = epoch_idx
        return self._finalize(time.perf_counter() - wall0)

    # ---------------- reporting ----------------
    def _finalize(self, wall_s: float) -> dict:
        shard_outs = [h.finalize() for h in self.shards]
        for h in self.shards:
            if hasattr(h, "close"):
                h.close()
        out = self._merge_metrics(shard_outs, wall_s)
        if self._truncated_reason is not None:
            out["truncated"] = True
            warnings.warn(
                f"FederatedSimulator: truncated by {self._truncated_reason}",
                RuntimeWarning, stacklevel=2)
        return out

    def _merge_metrics(self, shard_outs: list[dict], wall_s: float) -> dict:
        """Fold per-shard reports into one federation-level metrics dict."""
        out: dict = {"shards": shard_outs, "epochs": self.epochs,
                     "wall_time_s": wall_s}
        sums = ("n", "rounds", "events", "dialogues_arrived",
                "dialogues_completed", "unfinished_dialogues",
                "dispatched_requests", "incremental_dispatched",
                "migrated_in", "migrated_out", "completed_turns",
                "peak_inflight")
        for key in sums:
            out[key] = sum(s.get(key, 0) for s in shard_outs)
        weights = np.array([max(1, s.get("n", 0)) for s in shard_outs],
                           dtype=np.float64)
        for key in ("kv_hit_rate", "latency_ms_mean", "latency_ms_median",
                    "latency_ms_p95", "cost_mean", "quality_mean",
                    "dialogue_latency_mean_s", "queue_wait_mean_s"):
            vals = np.array([s.get(key, 0.0) or 0.0 for s in shard_outs])
            out[key] = float((vals * weights).sum() / weights.sum())
        now = max((s.get("sim_time_s", 0.0) for s in shard_outs),
                  default=0.0)
        out["sim_time_s"] = now
        out["truncated"] = any(s.get("truncated") for s in shard_outs)
        if now > 0:
            out["throughput_rps"] = out["n"] / now
            total_agents = sum(s.get("n_agents", 0) for s in shard_outs)
            busy = sum(s.get("utilization", 0.0) * s.get("sim_time_s", 0.0)
                       * s.get("n_agents", 0) for s in shard_outs)
            out["utilization"] = busy / (now * max(1, total_agents))
        accounts: dict[str, float] = defaultdict(float)
        for s in shard_outs:
            for k, v in (s.get("accounts") or {}).items():
                accounts[k] += v
        out["accounts"] = dict(accounts)
        out["routing"] = self._merge_routing(shard_outs)
        out["federation"] = {
            "super_hubs": len(self.shards),
            "epoch_s": self.epoch,
            "arrivals_fed": self.n_fed,
            "spill_candidates": self.spill_candidates,
            "spill_migrated": self.spill_migrated,
            "gossip": self.gossip.stats(),
            "exactly_once": self.exactly_once(shard_outs),
        }
        return out

    def _merge_routing(self, shard_outs: list[dict]) -> dict:
        """Sum shard profiler reports + fold in federation-level phases."""
        engine = sum((s.get("routing") or {}).get("engine_compute_s", 0.0)
                     for s in shard_outs)
        routing = sum((s.get("routing") or {}).get("routing_wall_s", 0.0)
                      for s in shard_outs)
        phases: dict[str, dict] = defaultdict(
            lambda: {"wall_s": 0.0, "calls": 0})
        for s in shard_outs:
            for name, ph in ((s.get("routing") or {}).get("phases")
                             or {}).items():
                phases[name]["wall_s"] += ph.get("wall_s", 0.0)
                phases[name]["calls"] += ph.get("calls", 0)
        fed_wall = 0.0
        for name, (w, c) in sorted(self._fed_phases.items()):
            phases[f"federation_{name}"] = {"wall_s": w, "calls": c}
            fed_wall += w
        total = routing + fed_wall
        for ph in phases.values():
            ph["frac_of_engine"] = (ph["wall_s"] / engine) if engine > 0 \
                else None
        return {
            "engine_compute_s": engine,
            "routing_wall_s": total,
            "shard_routing_wall_s": routing,
            "federation_wall_s": fed_wall,
            "overhead_frac": (total / engine) if engine > 0 else None,
            "phases": dict(sorted(phases.items())),
        }

    def exactly_once(self, shard_outs: list[dict]) -> dict:
        """Global exactly-once settlement audit.

        Per shard: the hash-chained ledger replay must reproduce the
        accounts (when a ledger is attached).  Globally: request-id
        prefixes must be pairwise distinct (so per-shard ledger
        uniqueness implies global uniqueness), migration hand-offs must
        conserve dialogues (in == out), and every arrived dialogue must
        be either completed or still accounted for — none lost, none
        double-completed.
        """
        prefixes = [s.get("rid_prefix", "") for s in shard_outs]
        ledgers = [s.get("ledger") for s in shard_outs]
        ledger_ok = all(lg is None or lg.get("ok", False) for lg in ledgers)
        arrived = sum(s.get("dialogues_arrived", 0) for s in shard_outs)
        completed = sum(s.get("dialogues_completed", 0) for s in shard_outs)
        unfinished = sum(s.get("unfinished_dialogues", 0)
                         for s in shard_outs)
        m_in = sum(s.get("migrated_in", 0) for s in shard_outs)
        m_out = sum(s.get("migrated_out", 0) for s in shard_outs)
        conserved = (arrived == completed + unfinished) and (m_in == m_out)
        return {
            "ledger_replay_ok": ledger_ok,
            "ledgers_attached": sum(1 for lg in ledgers if lg is not None),
            "rid_prefixes_distinct": len(set(prefixes)) == len(prefixes),
            "dialogues_conserved": conserved,
            "lost_dialogues": arrived - completed - unfinished,
            "migrations_balanced": m_in == m_out,
            "ok": ledger_ok and conserved
            and len(set(prefixes)) == len(prefixes),
        }


def build_federation(dialogues, *, n_agents: int, super_hubs: int,
                     arrivals=None, seed: int = 0,
                     engine_mode: str = "analytic",
                     hub_scheme: str = "domain", agents_per_hub: int = 16,
                     max_inflight: int | None = None,
                     router_kwargs: dict | None = None,
                     loop_kwargs: dict | None = None,
                     cluster_kwargs: dict | None = None,
                     parallel: str = "inline", device="cuda",
                     **fed_kwargs) -> FederatedSimulator:
    """Construct an S-shard federation over one global fleet + stream.

    The fleet is ``agent_profiles(n_agents, seed)`` — the SAME profile
    list a single-heap run would build — partitioned by
    `cluster_super_hubs`; each shard gets `shard_seed(seed, k)` (the
    fold_in-style split that makes runs independent of shard advance
    order) and ``max_inflight // S`` of the global admission window.
    ``parallel="process"`` puts each shard in its own OS process
    (`ProcessShardHandle`); at S=1 the single inline shard consumes
    ``dialogues``/``arrivals`` directly — the bit-exact
    `EventSimulator` oracle configuration.  ``fed_kwargs`` pass through
    to `FederatedSimulator` (epoch, spill knobs, shard_schedule, ...).

    Every shard's cluster and router are built on ``device`` (``"cuda"``
    raises without a card); process shards on a CUDA device each open
    their own context on it, after this process has built the router's
    kernel libraries once.
    """
    from repro_torch.configs.iemas_cluster import agent_profiles
    from repro_torch.distributed.federation import (ProcessShardHandle,
                                                    ShardSpec,
                                                    build_router_kernels,
                                                    shard_seed)

    dev = resolve_device(device)
    if parallel == "process" and dev.type == "cuda":
        build_router_kernels()
    profiles = agent_profiles(n_agents, seed=seed)
    supers = cluster_super_hubs([p.domains for p in profiles],
                                [p.scale for p in profiles], super_hubs,
                                scheme=hub_scheme, seed=seed,
                                agents_per_hub=agents_per_hub)
    s = len(supers)
    quantize = (loop_kwargs or {}).get("quantize")
    shards = []
    for pos, sh in enumerate(supers):
        rkw = dict(router_kwargs or {})
        rkw.setdefault("n_hubs", sh.n_inner_hubs)
        lkw = dict(loop_kwargs or {})
        if max_inflight is not None:
            lkw["max_inflight"] = max(1, max_inflight // s)
        # S=1: the lone shard IS the global simulator — keep the base seed
        # (fault/evaluator rng parity with EventSimulator); S>1: fold_in
        spec = ShardSpec(super_id=sh.hub_id,
                         profiles=[profiles[i] for i in sh.agent_indices],
                         seed=seed if s == 1 else shard_seed(seed, sh.hub_id),
                         router_kwargs=rkw, loop_kwargs=lkw,
                         cluster_kwargs=dict(
                             cluster_kwargs or {},
                             engine_mode=engine_mode),
                         device=str(dev))
        if s == 1:
            shards.append(InlineShard.from_spec(
                spec, dialogues=dialogues, arrivals=arrivals,
                external=False))
        elif parallel == "process":
            # started together; their acks are collected below
            shards.append(ProcessShardHandle(spec))
        else:
            shards.append(InlineShard.from_spec(spec))
    try:
        for h in shards:
            if isinstance(h, ProcessShardHandle):
                h.ready()
    except Exception:
        for h in shards:
            if isinstance(h, ProcessShardHandle):
                h.close()
        raise
    if quantize is not None:
        fed_kwargs.setdefault("epoch", max(
            quantize, math.ceil(fed_kwargs.get("epoch", 0.25) / quantize)
            * quantize))
    return FederatedSimulator(
        shards, supers, [p.domains for p in profiles],
        dialogues if s > 1 else None,
        arrivals=arrivals if s > 1 else None, device=dev, **fed_kwargs)
