"""Shared helpers of the serving-stack parity tests: the same seeded run
through the reference's serving stack and the port's, compared field by
field with the wall-clock fields left out by name."""
import re

import numpy as np

#: metrics that read the host clock (compared by name, never by tolerance);
#: a federation's merged report adds its two routing walls, and each entry
#: of its ``shards`` list carries a shard's own copy of the first three
WALL_KEYS = ("wall_time_s", "routing.routing_wall_s", "routing.overhead_frac",
             "routing.federation_wall_s", "routing.shard_routing_wall_s")
WALL_PHASE_FIELDS = ("wall_s", "frac_of_engine")
#: the port's name of each reference solver whose name differs
PORT_SOLVER = {"dense-jax": "dense-torch"}
_SHARD = re.compile(r"^shards\.\d+\.")


def flat(d: dict, pre: str = "") -> dict:
    """Nested metric dicts as one dict of dotted keys (a list of dicts, such
    as a federation's ``shards``, by position: ``shards.0.n``)."""
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{pre}{k}."))
        elif isinstance(v, list) and v and all(isinstance(e, dict)
                                               for e in v):
            for i, e in enumerate(v):
                out.update(flat(e, f"{pre}{k}.{i}."))
        else:
            out[f"{pre}{k}"] = v
    return out


def is_wall_key(key: str) -> bool:
    """Whether a dotted metric key reads the host clock: a name of
    ``WALL_KEYS`` or a profiler phase's ``wall_s`` / ``frac_of_engine``,
    at the top or inside one shard's report."""
    key = _SHARD.sub("", key)
    return key in WALL_KEYS or (key.startswith("routing.phases.")
                                and key.rsplit(".", 1)[1] in WALL_PHASE_FIELDS)


def comparable(metrics: dict, solver: str | None = None,
               port_solver: str | None = None) -> dict:
    """``metrics`` flattened without the wall-clock keys, with the port's
    solver name in the profiler's phase keys (``port_solver``, by default
    ``PORT_SOLVER``'s name for ``solver``) mapped to the reference's."""
    port_solver = port_solver or PORT_SOLVER.get(solver)
    out = {}
    for k, v in flat(metrics).items():
        if is_wall_key(k):
            continue
        if port_solver is not None:
            k = k.replace(f"[{port_solver}]", f"[{solver}]")
        out[k] = v
    return out


def records(cluster) -> list:
    """Per-record signature, in completion order: request, agent, the
    mechanism's payment and the measured cost, hits, latency, quality."""
    return [(r.request.request_id, r.request.dialogue_id, r.request.turn,
             r.agent_id, r.payment, r.cost, r.n_prompt, r.n_hit, r.n_gen,
             r.latency, r.quality, r.dispatched_at, r.failed,
             np.asarray(r.output_tokens).tolist()) for r in cluster.records]


def assert_same_run(ref, port, *, solver=None):
    """``ref`` and ``port`` are (metrics, cluster, router) of one seeded
    run in each package: equal metrics (wall clock aside), records,
    accounts and settlement-ledger head."""
    (m_ref, c_ref, r_ref), (m_port, c_port, r_port) = ref, port
    a, b = comparable(m_ref, solver), comparable(m_port, solver)
    assert a == b, {k: (a.get(k), b.get(k)) for k in set(a) | set(b)
                    if a.get(k) != b.get(k)}
    assert records(c_ref) == records(c_port)
    assert dict(r_ref.accounts) == dict(r_port.accounts)
    if getattr(r_ref, "settlement", None) is not None:
        assert r_ref.settlement.head == r_port.settlement.head
        assert len(r_ref.settlement) == len(r_port.settlement)
