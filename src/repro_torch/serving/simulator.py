"""Event-driven, open-loop serving simulator for 100+-agent scale runs.

`repro_torch.serving.cluster.run_workload` is a closed-loop, fixed-population
round loop: the whole dialogue population is pre-materialized into one
``state`` dict and the clock ticks in fixed ``round_dt`` steps whether or
not anything happens.  That is the right *oracle* for small bit-comparable
runs, but it cannot express the paper's system-level regime — sustained
many-to-many load at 100+ agents and 10k dialogues, where arrivals are an
open-loop process and routing overhead must be attributed against engine
compute.  This module replaces it for scale runs:

  * **event queue** — a single heap carries dialogue ARRIVAL events (from a
    Poisson/trace `repro_torch.serving.workload.ArrivalProcess`) and ROUTE
    (router-invocation) events; engine completions stay in the cluster's
    own completion heap and the simulator jumps the virtual clock straight
    to the next of the three (``SimCluster.next_completion_time`` /
    ``advance_to`` hooks) — no empty rounds are ever spun.
  * **streaming admission** — dialogue scripts are pulled lazily from an
    iterator (`repro_torch.serving.workload.iter_dialogues`) one arrival at a
    time, and at most ``max_inflight`` dialogues hold state concurrently;
    the rest wait in an admission backlog.  10k dialogues flow through a
    bounded window instead of one pre-built dict.
  * **`RoutingProfiler`** — attributes real wall-clock per routing phase
    (Phase-1 predict, Phase-2 solve per backend, the cross-hub spill round,
    price-book ops, Phase-4 feedback) against *simulated engine compute*
    (the virtual busy-seconds the engines report), so a scale run can
    report where routing overhead crosses 10% of engine compute as n_agents
    and batch size grow.  The router's phases end with their results on
    the host, so on a CUDA router the host clock covers their device work.

Workflow DAGs: alongside linear `DialogueScript` turns, the simulator
drives `repro_torch.serving.workload.DagScript` task graphs — a step becomes
ready only when ALL its parent steps have completed, its prompt is the
concatenation of its parents' contexts (their prompt + generated output,
ascending step order) followed by its own instruction tokens, and sibling
steps dispatch concurrently.  Each step routes under its own session key
(``meta["session"] = "<dialogue>#s<step>"``) with its parents' session
keys in ``meta["parent_sessions"]``, which is what lets the router's
precedence-aware affinity and the engines' cache fork reuse the producer's
KV prefix across the handoff.

Closed-loop parity: with ``quantize=round_dt`` the ROUTE events fall on the
exact round boundaries of ``run_workload`` and completions are delivered at
those boundaries only — under `SyncArrivals` the simulator then reproduces
``run_workload``'s decisions bit-for-bit, which keeps the old loop useful
as the oracle while this one owns the scale runs.

The port of the reference's `repro.serving.simulator`: the same event
order, id scheme and metrics, so a seeded run gives the reference's
metrics (wall-clock fields aside) whatever device the router runs on
(tests/torch_port/test_torch_simulator.py).
"""
from __future__ import annotations

import heapq
import math
import time
import warnings
from collections import Counter, deque
from contextlib import contextmanager
from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.mechanism import CompletionObs, Request
from repro_torch.serving.workload import (ArrivalProcess, DagScript, DialogueScript,
                                    SyncArrivals)
from repro_torch.utils.timing import phase_scope

# heap-event kinds; completions live in the cluster's heap.  ARRIVAL <
# MIGRATE < ROUTE so same-instant arrivals and migration hand-offs are
# admitted before the batch is formed.
_ARRIVAL, _MIGRATE, _ROUTE = 0, 1, 2
_EMPTY = np.zeros(0, np.int32)


class RoutingProfiler:
    """Wall-clock-per-phase accounting against simulated engine compute.

    The router and cluster wrap their sections in ``phase(name)`` (no-ops
    until a profiler is attached): ``route_batch`` is the umbrella around
    one router invocation, inside which the IEMAS router nests
    ``phase1_predict``, ``price_book``, ``phase2_solve[<backend>]`` and
    ``phase2_spill``; ``phase4_feedback`` wraps completion feedback.  The
    cluster reports each dispatch's virtual engine seconds through
    ``add_engine_compute``.  ``report()`` divides the top-level routing
    wall-clock (``route_batch`` + ``phase4_feedback`` — nested phases are
    *inside* the umbrella and not double-counted) by the engine compute to
    give the routing-overhead fraction the scale benchmark tables.
    """

    #: top-level (non-nested) phases whose sum is "routing overhead"
    TOP_PHASES = ("route_batch", "phase4_feedback")

    def __init__(self):
        self.phases: dict[str, float] = {}
        self.calls: dict[str, int] = {}
        self.engine_compute = 0.0   # virtual engine busy seconds
        self.route_requests = 0     # requests seen across route_batch calls
        self.empty_route_calls = 0  # route_batch invocations with 0 requests
        # fused routing step counters (core/routing_fused.py): device->host
        # materialization boundaries, syncs that fired BEFORE decisions
        # materialized (must stay 0 — the no-mid-sync contract), and fused
        # jit-cache growth (the pow-2 retrace bound)
        self.fused_host_transfers = 0
        self.fused_mid_syncs = 0
        self.fused_retraces = 0

    @contextmanager
    def phase(self, name: str):
        """Time one section under ``name`` (re-entrant safe, additive)."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.phases[name] = self.phases.get(name, 0.0) + dt
            self.calls[name] = self.calls.get(name, 0) + 1

    def add_engine_compute(self, seconds: float) -> None:
        """Accumulate one dispatch's simulated engine seconds."""
        self.engine_compute += float(seconds)

    def note_route_batch(self, n_requests: int) -> None:
        """Record one router invocation's batch size (called by the router).

        ``n_requests == 0`` flags a wasted invocation — the event loop is
        expected to never fire the router without work (EventSimulator's
        empty-round guard), so ``empty_route_calls`` staying at 0 is a
        regression-tested invariant.
        """
        self.route_requests += int(n_requests)
        if n_requests == 0:
            self.empty_route_calls += 1

    def note_fused_step(self, host_transfers: int = 0, mid_syncs: int = 0,
                        retraces: int = 0) -> None:
        """Record one fused routing step's host-boundary accounting.

        Called by `repro_torch.core.routing_fused.FusedRoutingStep` after its
        single materialization: ``host_transfers`` counts device->host
        boundaries (exactly one per fused batch), ``mid_syncs`` counts any
        sync performed before RouteDecisions materialized (zero by
        construction — a nonzero value means the fused program was split),
        and ``retraces`` is the fused jit-cache growth since the last step
        (bounded by the pow-2 shape buckets).
        """
        self.fused_host_transfers += int(host_transfers)
        self.fused_mid_syncs += int(mid_syncs)
        self.fused_retraces += int(retraces)

    def attach(self, cluster, router) -> "RoutingProfiler":
        """Hook this profiler into a cluster + router pair; returns self."""
        cluster.profiler = self
        router.profiler = self
        return self

    def routing_wall(self) -> float:
        """Total top-level routing wall-clock seconds."""
        return sum(self.phases.get(p, 0.0) for p in self.TOP_PHASES)

    def report(self) -> dict:
        """JSON-friendly attribution table (fractions of engine compute).

        With zero engine compute (e.g. every dispatch failed) the fractions
        are undefined and reported as ``None`` — strict-JSON safe, unlike
        ``inf``.
        """
        ec = self.engine_compute
        routing = self.routing_wall()
        return {
            "engine_compute_s": ec,
            "routing_wall_s": routing,
            "overhead_frac": (routing / ec) if ec > 0 else None,
            "route_requests": self.route_requests,
            "empty_route_calls": self.empty_route_calls,
            "fused": {
                "host_transfers": self.fused_host_transfers,
                "mid_pipeline_syncs": self.fused_mid_syncs,
                "retraces": self.fused_retraces,
            },
            "phases": {
                name: {
                    "wall_s": wall,
                    "calls": self.calls.get(name, 0),
                    "frac_of_engine": (wall / ec) if ec > 0 else None,
                }
                for name, wall in sorted(self.phases.items())
            },
        }


@dataclass
class _Dialogue:
    """In-flight dialogue state (exists only between admission and finish).

    Linear scripts use ``turn``/``history``/``pending``/``busy``; DAG
    scripts (`DagScript`) instead track per-step state: a step's prompt is
    built the moment its last parent completes (concatenated parent
    contexts + the step's own tokens), ``waiting`` counts incomplete
    parents per step, ``inflight`` holds dispatched step ids (several may
    run concurrently), and the dialogue finishes when ``remaining`` hits 0.
    """

    script: DialogueScript | DagScript
    arrived_at: float
    turn: int = 0
    history: np.ndarray = field(default_factory=lambda: _EMPTY)
    pending: np.ndarray | None = None   # next user turn awaiting dispatch
    busy: bool = False
    ready_since: float = 0.0
    # ---- DAG-mode fields (unused for linear scripts) ----
    step_prompt: dict = field(default_factory=dict)   # step -> prompt tokens
    step_ctx: dict = field(default_factory=dict)      # step -> prompt+output
    step_ready_since: dict = field(default_factory=dict)
    waiting: dict = field(default_factory=dict)       # step -> open parents
    children: dict = field(default_factory=dict)      # step -> child steps
    inflight: set = field(default_factory=set)        # dispatched step ids
    remaining: int = 0                                # steps not yet done
    migrations: int = 0   # cross-super-hub hand-offs this dialogue survived


class ShardEventLoop:
    """Open-loop event-driven serving driver (see module docstring).

    This class is the reusable *shard* event loop: one heap, one clock,
    one ready deque, one admission window over ONE ``(cluster, router)``
    pair.  `EventSimulator` (the public single-heap simulator) is a thin
    subclass that treats the whole fleet as a single shard; the
    federation (`repro_torch.serving.federation.FederatedSimulator`)
    composes S of these — one per super-hub — and advances them
    independently between synchronization epochs via `advance_until`.

    Parameters
    ----------
    cluster, router : the `SimCluster` + router pair to drive.
    dialogues : iterable of `DialogueScript` / `DagScript` — consumed
        lazily, one script per arrival (pass
        `repro_torch.serving.workload.iter_dialogues` output for streaming scale
        runs); DAG scripts run their steps under precedence constraints.
    arrivals : `ArrivalProcess` pacing dialogue arrivals (default: all at
        t=0, the closed-loop population).
    batch_cap : max requests per router invocation (micro-batch size).
    batch_window : seconds a ROUTE event waits after work appears, letting
        a micro-batch accumulate (also the retry pacing for unmatched
        requests).  Ignored when ``quantize`` is set.
    quantize : when set, ROUTE events tick on exact multiples of this
        round length and completions are delivered only at those
        boundaries — the bit-comparable ``run_workload`` lockstep regime.
    incremental : when True, a dialogue that becomes ready (arrival or
        next turn) is first offered to ``router.route_incremental`` — a
        greedy posted-price bid against the standing warm-start duals —
        and dispatched IMMEDIATELY on success instead of waiting out the
        batch window; the next batch auction re-equilibrates the
        provisional routes (see `repro_torch.core.mechanism.IEMASRouter`).
        Dialogues the posted-price pass declines fall back to the normal
        batch path unchanged.  Requires a router exposing
        ``route_incremental`` (and warm starts for any effect).
    max_inflight : admission-window bound on concurrently-active dialogues
        (None = unbounded, required for closed-loop parity).
    max_new_tokens : generation budget per request.
    profiler : optional `RoutingProfiler`; attached to cluster + router.
    max_rounds : router-invocation budget (mirrors ``run_workload``'s
        ``max_rounds``); exceeding it truncates the run with a warning.
    max_events : hard safety cap on processed events.
    horizon : optional virtual-time cap; reaching it truncates the run.
    lean : drop per-request token arrays once a completion is fully
        processed (bounds memory on 10k-dialogue runs; decisions are
        unaffected — the ledger/engines hold their own copies).
    on_round : optional callback ``(n_rounds, cluster)`` after each ROUTE.
    rid_prefix : prepended to every request id (``"s3:r17"``); federated
        shards pass ``"s{k}:"`` so ids stay globally unique across shard
        ledgers.  The default ``""`` keeps the historical ``r{N}`` ids
        (and thereby ledger-head parity) for single-heap runs.
    external_arrivals : when True the loop never pulls from ``dialogues``
        or ``arrivals`` itself — a parent driver feeds arrivals through
        `inject_arrival` and signals end-of-stream via `close_arrivals`
        (the `FederatedSimulator` S>1 partitioning mode).
    """

    def __init__(self, cluster, router, dialogues, *,
                 arrivals: ArrivalProcess | None = None,
                 batch_cap: int = 16, batch_window: float = 0.02,
                 quantize: float | None = None,
                 incremental: bool = False,
                 max_inflight: int | None = None,
                 max_new_tokens: int = 6,
                 profiler: RoutingProfiler | None = None,
                 max_rounds: int = 100_000,
                 max_events: int = 5_000_000,
                 horizon: float | None = None,
                 lean: bool = False,
                 on_round=None,
                 rid_prefix: str = "",
                 external_arrivals: bool = False):
        self.cluster = cluster
        self.router = router
        self.arrivals = arrivals if arrivals is not None else SyncArrivals()
        self.batch_cap = int(batch_cap)
        self.batch_window = float(batch_window)
        self.quantize = quantize
        self.incremental = bool(incremental) and \
            hasattr(router, "route_incremental")
        self.n_incremental = 0
        self.max_inflight = max_inflight
        self.max_new_tokens = max_new_tokens
        self.profiler = profiler
        if profiler is not None:
            profiler.attach(cluster, router)
        self.max_rounds = max_rounds
        self.max_events = max_events
        self.horizon = horizon
        self.lean = lean
        self.on_round = on_round
        self.rid_prefix = str(rid_prefix)
        self._external = bool(external_arrivals)

        if max_inflight is not None and max_inflight < 1:
            raise ValueError(f"max_inflight must be >= 1, got {max_inflight}")
        self.states: dict[str, _Dialogue] = {}
        # FIFO of ready work units: (dialogue_id, step_id) — step_id is None
        # for linear-dialogue turns, a DAG step id otherwise
        self.ready: deque[tuple] = deque()
        self.backlog: deque[DialogueScript] = deque()
        # per-dialogue dispatch attribution (includes fault-path retries)
        self.dispatch_count: Counter[str] = Counter()
        self.n_dispatched = 0
        self._events: list = []               # (time, kind, seq, payload)
        self._seq = 0
        self._rid = 0
        self._rounds = 0
        self._n_processed = 0
        self._route_at: float | None = None
        self._dialogue_iter = iter(dialogues)
        self._arrival_times = self.arrivals.times()
        self._arrivals_open = True
        self._truncated_reason: str | None = None
        self._started = False
        self._stopped = False
        self._wall0 = 0.0
        # aggregates (bounded memory — no per-dialogue lists)
        self.n_arrived = 0
        self.peak_inflight = 0
        self.n_completed_dialogues = 0
        self.migrated_in = 0
        self.migrated_out = 0
        self._dlg_latency_sum = 0.0
        self._wait_sum = 0.0
        self._wait_n = 0

    # ---------------- event scheduling ----------------
    def _push(self, t: float, kind: int, payload=None) -> None:
        heapq.heappush(self._events, (t, kind, self._seq, payload))
        self._seq += 1

    def _schedule_next_arrival(self) -> None:
        if self._external or not self._arrivals_open:
            return      # federation mode: the parent feeds inject_arrival
        script = next(self._dialogue_iter, None)
        if script is None:
            self._arrivals_open = False
            return
        t = next(self._arrival_times, None)
        if t is None:
            # zip semantics (see ArrivalProcess): a finite trace shorter
            # than the dialogue stream ends the arrivals — but loudly
            self._arrivals_open = False
            self._truncated_reason = "arrival process exhausted before " \
                "the dialogue stream"
            return
        t = max(float(t), 0.0)
        if self.quantize is not None:
            # lockstep contract: everything happens on round boundaries
            q = self.quantize
            t = math.ceil(t / q - 1e-9) * q
        self._push(t, _ARRIVAL, script)

    def _schedule_route(self, t: float) -> None:
        if self._route_at is None or t < self._route_at:
            self._push(t, _ROUTE)
            self._route_at = t

    def _next_time(self) -> float | None:
        cand = []
        if self._events:
            cand.append(self._events[0][0])
        if self.quantize is None:
            tc = self.cluster.next_completion_time()
            if tc is not None:
                cand.append(max(tc, self.cluster.now))
        return min(cand) if cand else None

    def _work_remains(self) -> bool:
        return bool(self._arrivals_open or self.backlog or self.ready
                    or self.states)

    # ---------------- federation hooks (external arrivals + migration) ----
    def inject_arrival(self, t: float, script) -> None:
        """Driver-fed arrival (``external_arrivals`` mode): push one ARRIVAL.

        Mirrors `_schedule_next_arrival`'s normalization (clamp to >= 0,
        quantize rounds up to the next boundary) so a parent driver
        partitioning one global arrival stream across shards preserves
        single-heap arrival semantics: same-time arrivals keep stream
        order (heap seq), and ARRIVAL still sorts before same-instant
        ROUTE ticks.
        """
        t = max(float(t), 0.0)
        if self.quantize is not None:
            q = self.quantize
            t = math.ceil(t / q - 1e-9) * q
        self._push(t, _ARRIVAL, script)

    def close_arrivals(self) -> None:
        """Signal end of the parent's global dialogue stream (federation).

        Already-injected ARRIVAL events still process; this only lets the
        loop's termination/truncation logic know no further work will be
        fed, exactly like the internal iterator drying up.
        """
        self._arrivals_open = False

    def residual_units(self, now: float, min_wait: float,
                       max_migrations: int = 2) -> list[dict]:
        """Dialogues stuck in this shard's ready queue >= ``min_wait``.

        A dialogue qualifies when it has NO in-flight engine work (the
        migration precondition — a completion racing the hand-off would
        settle twice) and its longest-waiting ready unit has queued at
        least ``min_wait`` virtual seconds.  Returns one summary row per
        dialogue (domain, difficulty, queued-unit count, max wait, and
        the stuck unit's prompt length — the cost driver for a remote
        bid); the federation prices these rows against gossiped remote
        capacity.  ``max_migrations`` stops spill ping-pong: a dialogue
        that already migrated that many times stays put.
        """
        agg: dict[str, dict] = {}
        for did, step in self.ready:
            st = self.states.get(did)
            if st is None or st.busy or st.inflight or \
                    st.migrations >= max_migrations:
                continue
            if step is None:
                since = st.ready_since
                plen = len(st.history) + len(st.pending)
            else:
                since = st.step_ready_since[step]
                plen = len(st.step_prompt[step])
            waited = now - since
            row = agg.setdefault(did, {
                "dialogue_id": did, "domain": st.script.domain,
                "difficulty": st.script.difficulty, "units": 0,
                "waited": waited, "prompt_len": plen})
            row["units"] += 1
            if waited > row["waited"]:
                row["waited"], row["prompt_len"] = waited, plen
        return [r for r in agg.values() if r["waited"] >= min_wait]

    def extract_dialogue(self, did: str) -> _Dialogue:
        """Surrender one dialogue's session state for migration.

        Only dialogues with no in-flight work may leave (enforced);
        every queued ready unit is withdrawn with it.  The arrived count
        and dispatch attribution stay on this shard — exactly-once
        accounting counts an arrival where it was admitted and a
        completion wherever the dialogue finishes.  Vacating the window
        slot admits from the backlog, same as a local finish.
        """
        st = self.states.pop(did)
        if st.busy or st.inflight:
            self.states[did] = st       # restore before failing loudly
            raise RuntimeError(f"cannot migrate {did!r}: in-flight work")
        self.ready = deque(k for k in self.ready if k[0] != did)
        self.migrated_out += 1
        st.migrations += 1
        if self.backlog:
            self._admit(self.backlog.popleft())
        return st

    def admit_migrant(self, st: _Dialogue, t: float) -> None:
        """Schedule adoption of a migrated dialogue at virtual time ``t``.

        Queued as a MIGRATE event (admitted before any same-instant ROUTE
        tick) so shard clocks are never touched at the hand-off — epoch
        boundaries stay pure pauses and S=1 federation parity holds.
        """
        self._push(max(float(t), 0.0), _MIGRATE, st)

    def _admit_migrant(self, st: _Dialogue) -> None:
        """Adopt a migrated dialogue's state (cross-super-hub hand-off).

        The dialogue was counted as arrived on its home shard, so
        ``n_arrived`` is untouched; its ready units re-enter this queue
        with fresh wait clocks (remote placement starts a new queueing
        episode) and bid incrementally like any local admission.
        Migrants bypass the ``max_inflight`` window — they were admitted
        globally on their home shard, and parking them in the local
        backlog could strand a dialogue behind a shard that never
        drains.
        """
        now = self.cluster.now
        self.migrated_in += 1
        did = st.script.dialogue_id
        self.states[did] = st
        self.peak_inflight = max(self.peak_inflight, len(self.states))
        if isinstance(st.script, DagScript):
            # ready = prompt built, not completed (migration precondition
            # already guarantees nothing is in flight)
            for sid in sorted(st.step_prompt):
                if sid in st.step_ctx:
                    continue
                st.step_ready_since[sid] = now
                self.ready.append((did, sid))
                self._try_incremental()
            return
        st.ready_since = now
        self.ready.append((did, None))
        self._try_incremental()

    # ---------------- dialogue lifecycle ----------------
    def _admit(self, script) -> None:
        now = self.cluster.now
        if isinstance(script, DagScript):
            st = _Dialogue(script, arrived_at=now,
                           remaining=len(script.steps))
            for s in script.steps:
                st.waiting[s.step_id] = len(s.parents)
                for p in s.parents:
                    st.children.setdefault(p, []).append(s.step_id)
            self.states[script.dialogue_id] = st
            self.peak_inflight = max(self.peak_inflight, len(self.states))
            # roots have no parents: ready (and bidding) immediately
            for s in script.steps:
                if not s.parents:
                    st.step_prompt[s.step_id] = s.tokens.astype(np.int32)
                    st.step_ready_since[s.step_id] = now
                    self.ready.append((script.dialogue_id, s.step_id))
                    self._try_incremental()
            return
        self.states[script.dialogue_id] = _Dialogue(
            script, arrived_at=now, pending=script.turns[0], ready_since=now)
        self.peak_inflight = max(self.peak_inflight, len(self.states))
        self.ready.append((script.dialogue_id, None))
        self._try_incremental()

    def _on_arrival(self, script: DialogueScript) -> None:
        self.n_arrived += 1
        if self.max_inflight is not None and \
                len(self.states) >= self.max_inflight:
            self.backlog.append(script)     # admission window full: wait
        else:
            self._admit(script)

    def _finish_dialogue(self, did: str, now: float) -> None:
        """Release a finished dialogue's state and admit from the backlog."""
        st = self.states[did]
        self.n_completed_dialogues += 1
        self._dlg_latency_sum += now - st.arrived_at
        del self.states[did]
        if self.backlog:
            self._admit(self.backlog.popleft())

    def _handle_completions(self, t: float) -> None:
        done = self.cluster.advance_to(t, self.router)
        now = self.cluster.now
        for rec in done:
            did = rec.request.dialogue_id
            st = self.states[did]
            step = rec.request.meta.get("step_id")
            if step is not None:
                self._complete_step(st, did, step, rec, now)
                continue
            st.busy = False
            if rec.failed:
                # retry keeps the ORIGINAL ready time: the turn has been
                # waiting since it first became ready, and resetting the
                # clock here under-reported queueing wait across retries
                self.ready.append((did, None))  # re-issue the same turn
                self._try_incremental()
                continue
            st.history = np.concatenate(
                [st.history, st.pending, rec.output_tokens]).astype(np.int32)
            st.turn += 1
            if self.lean:
                rec.request.tokens = _EMPTY
                rec.output_tokens = _EMPTY
            if st.turn < len(st.script.turns):
                st.pending = st.script.turns[st.turn]
                st.ready_since = now
                self.ready.append((did, None))
                self._try_incremental()
            else:
                self._finish_dialogue(did, now)

    def _complete_step(self, st: _Dialogue, did: str, step: int, rec,
                       now: float) -> None:
        """One DAG step finished (or failed): update precedence state.

        On success the step's context (prompt + generated output) is
        recorded; every child whose last open parent this was gets its
        prompt built — concatenated parent contexts in ascending step order,
        then the child's own tokens — and becomes ready.  On failure the
        step re-queues with its original ready time (same wait-clock
        contract as linear retries).
        """
        st.inflight.discard(step)
        if rec.failed:
            self.ready.append((did, step))
            self._try_incremental()
            return
        st.step_ctx[step] = np.concatenate(
            [st.step_prompt[step], rec.output_tokens]).astype(np.int32)
        st.remaining -= 1
        if self.lean:
            rec.request.tokens = _EMPTY
            rec.output_tokens = _EMPTY
        for c in st.children.get(step, ()):
            st.waiting[c] -= 1
            if st.waiting[c] == 0:
                s = st.script.steps[c]
                st.step_prompt[c] = np.concatenate(
                    [st.step_ctx[p] for p in sorted(s.parents)]
                    + [s.tokens]).astype(np.int32)
                st.step_ready_since[c] = now
                self.ready.append((did, c))
                self._try_incremental()
        if st.remaining == 0:
            self._finish_dialogue(did, now)

    # ---------------- routing ----------------
    def _build_request(self, key: tuple) -> Request:
        """Materialize the Request for one ready unit ``(did, step)``,
        consuming a fresh request id.

        Id contract: every built request burns its ``r{N}`` id — including
        incremental offers that end up deferred or dead-dispatched — so a
        dispatched id is NEVER re-issued to a different request and
        router/profiler state keyed by request_id cannot collide.  DAG
        steps carry their handoff metadata here: ``session`` (the step's
        own ledger/engine key), ``parent_sessions`` (precedence-aware
        affinity + engine cache fork), ``step_id`` and ``role``.
        """
        did, step = key
        st = self.states[did]
        if step is None:
            prompt = np.concatenate([st.history, st.pending])
            turn, domain = st.turn, st.script.domain
            meta = {"difficulty": st.script.difficulty}
        else:
            s = st.script.steps[step]
            prompt = st.step_prompt[step]
            turn, domain = step, s.domain
            meta = {"difficulty": st.script.difficulty,
                    "session": f"{did}#s{step}",
                    "parent_sessions": tuple(f"{did}#s{p}"
                                             for p in sorted(s.parents)),
                    "step_id": step, "role": s.role}
        req = Request(
            request_id=f"{self.rid_prefix}r{self._rid}", dialogue_id=did,
            tokens=prompt.astype(np.int32), turn=turn, domain=domain,
            max_new_tokens=self.max_new_tokens, meta=meta)
        self._rid += 1
        return req

    def _note_dispatch(self, st: _Dialogue, did: str, step) -> None:
        """Shared dispatch bookkeeping: busy/inflight + wait accounting."""
        if step is None:
            st.busy = True
            since = st.ready_since
        else:
            st.inflight.add(step)
            since = st.step_ready_since[step]
        self.dispatch_count[did] += 1
        self.n_dispatched += 1
        self._wait_sum += self.cluster.now - since
        self._wait_n += 1

    def _try_incremental(self) -> None:
        """Offer the just-readied work unit a provisional posted-price route.

        Called right after a unit is appended to ``ready``; on success the
        request dispatches immediately (its batch-window wait collapses
        to zero) and the unit is removed from the queue — the next
        batch auction re-equilibrates it as a shadow participant.  On any
        miss (stale/absent duals, no profitable unit, dead dispatch target)
        the unit simply stays queued for the batch path; its request id is
        burned, not recycled (see `_build_request`).
        """
        if not self.incremental or not self.ready:
            return
        cluster, router = self.cluster, self.router
        did, step = key = self.ready[-1]
        st = self.states[did]
        req = self._build_request(key)
        telem = cluster.telemetry.snapshot(cluster.now)
        free = cluster.free_slots()
        with phase_scope(self.profiler, "route_incremental"):
            dec = router.route_incremental([req], telem, free_slots=free)[0]
        if dec.agent_id is None:
            return                      # deferred to the next batch auction
        if cluster.execute(dec, router) is None:
            # dead dispatch target: fault-path feedback (quarantine +
            # pending/provisional cleanup); the unit stays queued
            router.on_complete(dec.request.request_id, CompletionObs(
                0.0, len(dec.request.tokens), 0, 0, 0.0, failed=True))
            return
        self.ready.pop()
        self._note_dispatch(st, did, step)
        self.n_incremental += 1

    def _route_step(self) -> None:
        cluster, router = self.cluster, self.router
        batch = []
        while self.ready and len(batch) < self.batch_cap:
            batch.append(self._build_request(self.ready.popleft()))
        if not batch:
            return
        telem = cluster.telemetry.snapshot(cluster.now)
        free = cluster.free_slots()
        with phase_scope(self.profiler, "route_batch"):
            decisions = router.route_batch(batch, telem, free_slots=free)
        unmatched = []
        for dec in decisions:
            did = dec.request.dialogue_id
            step = dec.request.meta.get("step_id")
            if dec.agent_id is None:
                unmatched.append((did, step))
                continue
            if cluster.execute(dec, router) is None:
                # dead dispatch target: fault-path feedback (quarantine +
                # pending cleanup) so the router stops matching it — same
                # handling as run_workload (parity contract)
                router.on_complete(dec.request.request_id, CompletionObs(
                    0.0, len(dec.request.tokens), 0, 0, 0.0, failed=True))
                unmatched.append((did, step))
                continue
            self._note_dispatch(self.states[did], did, step)
        # unmatched requests keep their queue priority, in order
        self.ready.extendleft(reversed(unmatched))

    # ---------------- main loop ----------------
    def start(self) -> None:
        """Idempotent initial scheduling (first arrival + quantize tick 0)."""
        if self._started:
            return
        self._started = True
        self._wall0 = time.perf_counter()
        self._schedule_next_arrival()
        if self.quantize is not None:
            self._schedule_route(0.0)

    def _truncate(self, reason: str) -> None:
        """Record a truncation and stop the loop for good (sticky)."""
        self._truncated_reason = reason
        self._stopped = True

    def advance_until(self, t_end: float | None) -> None:
        """Process every event at virtual time ``<= t_end``, then pause.

        The workhorse behind both `run` (``t_end=None``: run to
        completion/truncation) and `FederatedSimulator` epochs.  Pausing
        is pure — no clock is touched, no event reordered — so advancing
        in epoch segments replays the exact event sequence of one
        continuous run (the S=1 federation bit-parity contract).  Once a
        truncation fires the loop is stopped for good; further calls
        return immediately.
        """
        self.start()
        while not self._stopped:
            if self._n_processed >= self.max_events:
                self._truncate(f"max_events ({self.max_events})")
                break
            t = self._next_time()
            if t is None:
                if self._external and self._arrivals_open:
                    break       # idle shard: awaiting injected arrivals
                if self._work_remains():
                    # e.g. an admission window far smaller than the stream:
                    # arrivals drained with the backlog still populated —
                    # never exit silently with work on the floor
                    self._truncate("event queue drained with work remaining")
                break
            if t_end is not None and t > t_end:
                break           # next event lies beyond this epoch
            if self.horizon is not None and t > self.horizon:
                self._truncate(f"horizon ({self.horizon}s)")
                break
            self._handle_completions(t)
            run_route = False
            while self._events and self._events[0][0] <= t:
                _, kind, _, payload = heapq.heappop(self._events)
                self._n_processed += 1
                if kind == _ARRIVAL:
                    self._on_arrival(payload)
                    self._schedule_next_arrival()
                elif kind == _MIGRATE:
                    self._admit_migrant(payload)
                else:
                    self._route_at = None
                    run_route = True
            if run_route and self.ready:
                # ready-gated: a ROUTE tick with every dialogue busy (the
                # quantize regime fires one per round boundary regardless)
                # must not invoke the router on an empty batch, burn a
                # max_rounds unit, or fire on_round — empty rounds would
                # skew the rounds/overhead accounting and the profiler's
                # empty_route_calls invariant
                self._rounds += 1
                self._route_step()
                # strategic-agent round hook (core/adversary.py): churn
                # policies flap membership here; a no-op without a mix, so
                # honest runs keep bit-exact lockstep parity vs run_workload
                tick = getattr(self.cluster, "adversary_tick", None)
                if tick is not None:
                    tick(self.router)
                if self.on_round is not None:
                    self.on_round(self._rounds, self.cluster)
                if self._rounds >= self.max_rounds:
                    self._truncate(f"max_rounds ({self.max_rounds})")
                    break
            # keep exactly one ROUTE event pending whenever work remains
            if self.quantize is not None:
                if self._route_at is None and self._work_remains():
                    self._schedule_route(self.cluster.now + self.quantize)
            elif self.ready and self._route_at is None:
                self._schedule_route(self.cluster.now + self.batch_window)

    def run(self) -> dict:
        """Run to completion (or truncation) and return the metrics dict."""
        self.start()
        self.advance_until(None)
        return self._finalize(time.perf_counter() - self._wall0)

    def _finalize(self, wall_s: float) -> dict:
        out = self.cluster.metrics()
        now = self.cluster.now
        out.update({
            "rounds": self._rounds,
            "events": self._n_processed,
            "sim_time_s": now,
            "wall_time_s": wall_s,
            "dialogues_arrived": self.n_arrived,
            "dialogues_completed": self.n_completed_dialogues,
            "peak_inflight": self.peak_inflight,
            "unfinished_dialogues": len(self.states) + len(self.backlog),
            "truncated": self._truncated_reason is not None,
            "dispatched_requests": self.n_dispatched,
            "incremental_dispatched": self.n_incremental,
            "migrated_in": self.migrated_in,
            "migrated_out": self.migrated_out,
        })
        # turns completed = completed request records (retries excluded)
        out["completed_turns"] = out.get("n", 0)
        if self.dispatch_count:
            out["requests_per_dialogue_mean"] = (
                self.n_dispatched / len(self.dispatch_count))
            out["requests_per_dialogue_max"] = max(self.dispatch_count.values())
        if self.n_completed_dialogues:
            out["dialogue_latency_mean_s"] = (
                self._dlg_latency_sum / self.n_completed_dialogues)
        if self._wait_n:
            out["queue_wait_mean_s"] = self._wait_sum / self._wait_n
        if now > 0:
            out["throughput_rps"] = out.get("n", 0) / now
            busy = self.cluster.telemetry.busy_seconds()
            out["utilization"] = busy / (now * max(1, len(self.cluster.agents)))
        if self._truncated_reason is not None:
            warnings.warn(
                f"{type(self).__name__}: truncated by "
                f"{self._truncated_reason} with "
                f"{out['unfinished_dialogues']} admitted/backlogged dialogues "
                f"unfinished (arrivals "
                f"{'still open' if self._arrivals_open else 'drained'}); "
                f"metrics cover completed requests only",
                RuntimeWarning, stacklevel=2)
        book = getattr(self.router, "price_book", None)
        if book is not None and getattr(self.router, "warm_start", False):
            out["warm_start"] = book.stats()
        if self.profiler is not None:
            out["routing"] = self.profiler.report()
        return out


class EventSimulator(ShardEventLoop):
    """The public single-heap simulator: the whole fleet as ONE shard.

    Pure façade — every knob and behavior lives in `ShardEventLoop`; this
    name is what the launcher and the parity suite construct for
    non-federated runs, and what a one-shard federation must reproduce
    bit-for-bit.
    """


def simulate_workload(cluster, router, dialogues, *, profile: bool = True,
                      **kwargs) -> dict:
    """One-call convenience wrapper: build, (optionally) profile, run.

    ``kwargs`` pass through to `EventSimulator`; a fresh `RoutingProfiler`
    is attached unless ``profile=False`` or one was passed explicitly.
    """
    if profile and "profiler" not in kwargs:
        kwargs["profiler"] = RoutingProfiler()
    return EventSimulator(cluster, router, dialogues, **kwargs).run()
