"""Synthetic multi-turn workloads mirroring the paper's three benchmarks.

The datasets themselves (CoQA/QuAC/HotpotQA) are not available offline, so
we generate deterministic token-id dialogues with the same *structural*
properties the paper exploits:

  * coqa_like   — many turns (6-14), short follow-up questions on a growing
                  shared context: high prefix-reuse opportunity.
  * quac_like   — long initial context (200-360 tokens) + medium turns:
                  long-context reuse.
  * hotpot_like — mostly 1-2 turns, long unique prompts: scarce reuse
                  (the paper's low-KV regime, Table 1 rightmost block).

Turn t's prompt = full conversation so far (client appends the engine's
actual generated answer, preserving conversational causality like the
paper's client, Appendix C.1).

Beyond the paper's linear benchmarks, two **workflow/DAG families** model
real agentic traffic as task graphs with handoffs between *different*
agents (the MasRouter routing problem; topology shapes follow the
orchestrator-worker and handoff-swarm patterns in SNIPPETS.md):

  * dag_orchestrator — a root planning step fans out to 2-4 specialist
                       worker steps (distinct domains), joined by a fan-in
                       aggregation step: the OpenMAS
                       ``patterns.orchestrator`` delegate/aggregate shape.
  * dag_handoff      — a 3-6 step chain whose domain changes step to step
                       (each specialist hands the task off to the next),
                       with an optional side branch merged by a final
                       fan-in join: the AWorld ``Swarm(HANDOFF)`` shape.

A DAG step becomes runnable only once every parent step completed, and its
prompt is the concatenation of its parents' full contexts (parent prompt +
generated answer) followed by its own instruction tokens — the producer's
output IS the consumer's prompt prefix, so a router that co-places chained
steps keeps KV-prefix affinity alive across the handoff.

Scale runs consume the same scripts lazily via ``iter_dialogues`` and pace
them with an :class:`ArrivalProcess` (open-loop Poisson, synchronous
closed-loop, or an explicit trace), the standard methodology in
serving-system evaluations.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import numpy as np
import zlib

DOMAINS = ("dialogue", "longctx", "reasoning", "code", "math")


@dataclass
class DialogueScript:
    """One scripted multi-turn dialogue (user turns only; answers are live)."""

    dialogue_id: str
    domain: str
    turns: list          # list of user-turn token arrays
    difficulty: float    # [0,1], drives simulated quality


@dataclass
class DagStep:
    """One node of a workflow DAG: instruction tokens + precedence edges.

    ``parents`` index earlier steps of the same script (a step is runnable
    only when all of them completed); ``role`` tags the step's function in
    the topology (orchestrator / worker / aggregator / handoff) and
    ``domain`` is the specialist skill it needs — steps of one dialogue may
    target different domains, which is exactly the cross-agent handoff the
    precedence-aware router has to keep cache-affine.
    """

    step_id: int
    parents: tuple          # step_ids that must complete first (all < step_id)
    role: str               # orchestrator | worker | aggregator | handoff
    domain: str
    tokens: np.ndarray      # the step's own instruction tokens


@dataclass
class DagScript:
    """One scripted workflow DAG (steps + edges; answers are live).

    The simulator derives each step's prompt at readiness time: the
    concatenated parent contexts (their prompt + the engine's actual
    answer, in ascending ``step_id`` order) followed by the step's own
    ``tokens``.  ``domain`` is the root/coordination domain used where a
    single per-dialogue tag is needed.
    """

    dialogue_id: str
    domain: str
    steps: list             # list[DagStep], topologically ordered by step_id
    difficulty: float       # [0,1], drives simulated quality


def validate_dag(script: DagScript) -> None:
    """Raise ValueError unless ``script`` is a well-formed workflow DAG:
    contiguous step_ids, all edges pointing to earlier steps (acyclic by
    construction), and at least one root step."""
    ids = [s.step_id for s in script.steps]
    if ids != list(range(len(ids))):
        raise ValueError(f"{script.dialogue_id}: step_ids must be 0..n-1, "
                         f"got {ids}")
    roots = 0
    for s in script.steps:
        if any(p >= s.step_id or p < 0 for p in s.parents):
            raise ValueError(f"{script.dialogue_id}: step {s.step_id} has "
                             f"non-topological parents {s.parents}")
        roots += not s.parents
    if roots == 0:
        raise ValueError(f"{script.dialogue_id}: no root step")


@dataclass
class WorkloadSpec:
    """Parameters of one synthetic workload family draw."""

    name: str
    n_dialogues: int = 24
    vocab: int = 255     # token ids 1..vocab (0 reserved)
    seed: int = 0


def _tok(rng, n, vocab):
    return rng.integers(1, vocab, size=n, dtype=np.int32)


def iter_dialogues(spec: WorkloadSpec) -> Iterator[DialogueScript]:
    """Yield ``spec.n_dialogues`` scripts lazily, in ``generate`` order.

    Bit-identical to ``generate(spec)`` element by element (one shared rng
    consumed in dialogue order), but streams: the 10k-dialogue scale runs
    hold only the simulator's bounded in-flight window in memory.
    """
    rng = np.random.default_rng(spec.seed + zlib.crc32(spec.name.encode()) % 100000)
    for d in range(spec.n_dialogues):
        if spec.name == "coqa_like":
            domain = "dialogue"
            n_turns = int(rng.integers(6, 15))
            turns = [_tok(rng, int(rng.integers(24, 48)), spec.vocab)]
            turns += [_tok(rng, int(rng.integers(6, 14)), spec.vocab)
                      for _ in range(n_turns - 1)]
            difficulty = float(rng.uniform(0.1, 0.5))
        elif spec.name == "quac_like":
            domain = "longctx"
            n_turns = int(rng.integers(3, 7))
            turns = [_tok(rng, int(rng.integers(200, 360)), spec.vocab)]
            turns += [_tok(rng, int(rng.integers(8, 20)), spec.vocab)
                      for _ in range(n_turns - 1)]
            difficulty = float(rng.uniform(0.3, 0.7))
        elif spec.name == "hotpot_like":
            domain = "reasoning"
            n_turns = int(rng.integers(1, 3))
            turns = [_tok(rng, int(rng.integers(90, 200)), spec.vocab)
                     for _ in range(n_turns)]
            difficulty = float(rng.uniform(0.5, 0.9))
        elif spec.name in DAG_WORKLOADS:
            yield _dag_script(spec, d, rng)
            continue
        else:
            raise KeyError(spec.name)
        yield DialogueScript(f"{spec.name}-{d}", domain, turns, difficulty)


def _dag_script(spec: WorkloadSpec, d: int, rng) -> DagScript:
    """Draw one workflow DAG of the ``spec.name`` topology family."""
    if spec.name == "dag_orchestrator":
        # orchestrator-worker delegation: plan -> W parallel specialists ->
        # fan-in aggregation (OpenMAS patterns.orchestrator shape)
        root_dom = "reasoning"
        n_workers = int(rng.integers(2, 5))
        steps = [DagStep(0, (), "orchestrator", root_dom,
                         _tok(rng, int(rng.integers(40, 90)), spec.vocab))]
        for w in range(n_workers):
            dom = DOMAINS[int(rng.integers(len(DOMAINS)))]
            steps.append(DagStep(1 + w, (0,), "worker", dom,
                                 _tok(rng, int(rng.integers(10, 28)),
                                      spec.vocab)))
        steps.append(DagStep(1 + n_workers, tuple(range(1, 1 + n_workers)),
                             "aggregator", root_dom,
                             _tok(rng, int(rng.integers(8, 18)), spec.vocab)))
        difficulty = float(rng.uniform(0.3, 0.8))
    elif spec.name == "dag_handoff":
        # handoff swarm: a chain through changing specialist domains, with
        # an optional side branch merged by a fan-in join (AWorld
        # Swarm(build_type=HANDOFF) shape)
        root_dom = DOMAINS[int(rng.integers(len(DOMAINS)))]
        n_chain = int(rng.integers(3, 7))
        steps = [DagStep(0, (), "handoff", root_dom,
                         _tok(rng, int(rng.integers(30, 70)), spec.vocab))]
        for k in range(1, n_chain):
            dom = DOMAINS[int(rng.integers(len(DOMAINS)))]
            steps.append(DagStep(k, (k - 1,), "handoff", dom,
                                 _tok(rng, int(rng.integers(8, 26)),
                                      spec.vocab)))
        if n_chain >= 3 and rng.random() < 0.5:
            src = int(rng.integers(1, n_chain - 1))
            dom = DOMAINS[int(rng.integers(len(DOMAINS)))]
            steps.append(DagStep(n_chain, (src,), "worker", dom,
                                 _tok(rng, int(rng.integers(8, 22)),
                                      spec.vocab)))
            steps.append(DagStep(n_chain + 1, (n_chain - 1, n_chain),
                                 "aggregator", root_dom,
                                 _tok(rng, int(rng.integers(6, 14)),
                                      spec.vocab)))
        difficulty = float(rng.uniform(0.2, 0.7))
    else:  # pragma: no cover - guarded by the caller's membership test
        raise KeyError(spec.name)
    script = DagScript(f"{spec.name}-{d}", root_dom, steps, difficulty)
    validate_dag(script)
    return script


def generate(spec: WorkloadSpec) -> list[DialogueScript]:
    """Materialize the whole workload (small closed-loop runs and tests)."""
    return list(iter_dialogues(spec))


WORKLOADS = ("coqa_like", "quac_like", "hotpot_like")
DAG_WORKLOADS = ("dag_orchestrator", "dag_handoff")


# --------------------------------------------------------------------------
# Arrival processes (open-loop load generation for the event simulator)
# --------------------------------------------------------------------------
class ArrivalProcess:
    """Dialogue arrival-time source for an open-loop serving run.

    ``times()`` yields absolute arrival timestamps (virtual seconds,
    non-decreasing), one per dialogue, until the dialogue stream runs dry —
    implementations may be infinite generators; the simulator zips them
    against the dialogue iterator.
    """

    def times(self) -> Iterator[float]:
        """Yield non-decreasing absolute arrival timestamps."""
        raise NotImplementedError


@dataclass
class SyncArrivals(ArrivalProcess):
    """Closed-loop arrivals: every dialogue present at ``at`` (default t=0).

    The closed-loop regime: the whole population arrives up front.
    """

    at: float = 0.0

    def times(self) -> Iterator[float]:
        """Constant stream of ``at``."""
        while True:
            yield self.at


@dataclass
class PoissonArrivals(ArrivalProcess):
    """Open-loop memoryless arrivals at ``rate`` dialogues per virtual second.

    The standard serving-evaluation load model: inter-arrival gaps are
    iid Exp(rate), independent of system state, so queueing pressure is
    sustained rather than self-throttling.
    """

    rate: float
    seed: int = 0
    start: float = 0.0

    def times(self) -> Iterator[float]:
        """Exponential-gap timestamps from a dedicated seeded rng."""
        if self.rate <= 0:
            raise ValueError(f"arrival rate must be > 0, got {self.rate}")
        rng = np.random.default_rng(self.seed)
        t = self.start
        while True:
            t += float(rng.exponential(1.0 / self.rate))
            yield t


@dataclass
class TraceArrivals(ArrivalProcess):
    """Replay an explicit (sorted) timestamp trace, e.g. from a log."""

    timestamps: tuple

    def times(self) -> Iterator[float]:
        """Yield the recorded timestamps in order."""
        prev = -np.inf
        for t in self.timestamps:
            t = float(t)
            if t < prev:
                raise ValueError("trace timestamps must be non-decreasing")
            prev = t
            yield t


def load_trace(path) -> tuple:
    """Load an arrival trace file: one float timestamp per line (blank
    lines and ``#`` comments ignored).  Ordering is validated lazily by
    `TraceArrivals.times` when the simulator consumes the trace."""
    out = []
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            try:
                out.append(float(line))
            except ValueError:
                raise ValueError(
                    f"{path}:{lineno}: not a timestamp: {line!r}") from None
    if not out:
        raise ValueError(f"{path}: empty arrival trace")
    return tuple(out)


def make_arrivals(name: str, *, rate: float = 8.0, seed: int = 0,
                  trace=None) -> ArrivalProcess:
    """CLI helper: ``"sync"``, ``"poisson"`` (with ``rate``) or ``"trace"``
    (with ``trace`` timestamps, e.g. from `load_trace`) by name."""
    if name == "sync":
        return SyncArrivals()
    if name == "poisson":
        return PoissonArrivals(rate=rate, seed=seed)
    if name == "trace":
        if trace is None:
            raise ValueError("trace arrivals need timestamps: pass trace=... "
                             "(CLI: --trace-file)")
        return TraceArrivals(tuple(float(t) for t in trace))
    raise KeyError(f"unknown arrival process {name!r} (sync|poisson|trace)")
