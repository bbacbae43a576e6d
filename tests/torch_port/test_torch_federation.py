"""The port's hubs-of-hubs federation against the reference's, bit for bit,
on analytic clusters, with every router on the CPU.

Cases (the contracts of the reference's ``tests/test_federation.py``, and
the reference itself as the oracle):

* S=1: the port's federation equals the port's `EventSimulator` record for
  record, in the quantised lockstep (faults off and on) and the open loop,
  and the reference's S=1 federation;
* S=3, overloaded (every dialogue in one domain), with faults and
  cross-super-hub migration, ``solver="dense"``: the port's run equals the
  reference's — merged metrics, accounts, every shard's ledger head,
  ``spill_migrated``, the gossip stats and every digest published at every
  boundary, field by field — and settles every dialogue exactly once;
* S=2 with the reference on ``dense-jax`` and the port on ``cuda`` (its
  plain staged market on the CPU, the path the card runs);
* the seed split, the super-hub partition and home-shard routing against
  the reference's; determinism under shuffled shard schedules; consumed
  gossip staleness <= 1 epoch; process shards (spawned, ``device="cpu"``)
  equal to inline shards, with no tensor in anything that crosses the pipe.

Merged metrics are compared with the wall-clock keys left out by name
(`_serving_parity.is_wall_key`).  The overloaded run is the reference
test's at 40 dialogues instead of 150, to keep the module within its
tier-1 time (it still spills, migrates and faults).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _serving_parity import comparable, records  # noqa: E402
from repro import serving as ref_serving  # noqa: E402
from repro.core import hub as ref_hub  # noqa: E402
from repro.distributed import federation as ref_dist  # noqa: E402
from repro.serving import federation as ref_fed_mod  # noqa: E402
from repro_torch import serving as port_serving  # noqa: E402
from repro_torch.core import hub as port_hub  # noqa: E402
from repro_torch.core import mechanism as port_mech  # noqa: E402
from repro_torch.distributed import federation as port_dist  # noqa: E402
from repro_torch.serving import federation as port_fed_mod  # noqa: E402

ROUTER_KW = dict(solver="dense", warm_start=True, audit_ledger=True)
OVERLOADED_DIALOGUES = 40


def build(pkg, dialogues, **kw):
    """`build_federation` of the reference (``pkg="ref"``) or of the port
    on the CPU (``pkg="port"``)."""
    if pkg == "ref":
        return ref_serving.build_federation(dialogues, **kw)
    return port_serving.build_federation(dialogues, device="cpu", **kw)


def heads(out) -> list:
    return [s["ledger"]["head"] for s in out["shards"]]


def assert_same_federation(ref, port, solver=None, port_solver=None):
    """Two merged federation reports of one seeded run: equal metrics (wall
    clock aside), accounts, shard ledger heads, migrations, gossip."""
    a = comparable(ref, solver, port_solver)
    b = comparable(port, solver, port_solver)
    assert a == b, {k: (a.get(k), b.get(k)) for k in set(a) | set(b)
                    if a.get(k) != b.get(k)}
    assert ref["accounts"] == port["accounts"]
    assert heads(ref) == heads(port)
    assert ref["federation"]["spill_migrated"] == \
        port["federation"]["spill_migrated"]
    assert ref["federation"]["gossip"] == port["federation"]["gossip"]


# ---------------------------------------------------- S=1 oracle parity --
def _single_heap(dlg, *, fail=0.0, **loop_kw):
    cluster = port_serving.SimCluster(n_agents=4, seed=0, max_new_tokens=3,
                                      engine_mode="analytic", fail_prob=fail,
                                      device="cpu")
    router = port_mech.IEMASRouter(cluster.agent_infos(), n_hubs=2,
                                   device="cpu", **ROUTER_KW)
    out = port_serving.EventSimulator(cluster, router, dlg, max_new_tokens=3,
                                      **loop_kw).run()
    return cluster, router, out


def _federated_s1(pkg, dlg, *, fail=0.0, **loop_kw):
    fed = build(pkg, dlg, n_agents=4, super_hubs=1,
                arrivals=loop_kw.pop("arrivals", None), seed=0,
                router_kwargs=dict(ROUTER_KW, n_hubs=2),
                loop_kwargs=dict(loop_kw, max_new_tokens=3),
                cluster_kwargs=dict(max_new_tokens=3, fail_prob=fail))
    out = fed.run()
    return fed.shards[0].cluster, fed.shards[0].router, out


def _s1_case(case):
    """(dialogues, loop kwargs factory) of one S=1 case."""
    if case == "open":
        dlg = port_serving.generate(port_serving.WorkloadSpec(
            "coqa_like", n_dialogues=20, seed=5))
        return dlg, 0.0, lambda pkg: dict(
            arrivals=(ref_serving if pkg == "ref" else port_serving)
            .PoissonArrivals(rate=12.0, seed=2),
            batch_cap=8, batch_window=0.05, max_inflight=16)
    dlg = port_serving.generate(port_serving.WorkloadSpec(
        "coqa_like", n_dialogues=7, seed=3))
    return dlg, float(case), lambda pkg: dict(
        arrivals=(ref_serving if pkg == "ref" else port_serving)
        .SyncArrivals(), batch_cap=4, quantize=0.05)


@pytest.mark.parametrize("case", ["0.0", "0.2", "open"],
                         ids=["lockstep", "lockstep-faults", "open-loop"])
def test_s1_bit_parity(case):
    """S=1 federation reproduces the port's EventSimulator bit for bit —
    decisions, accounts, ledger head — in the quantised lockstep (with the
    fault path's draws) and the open loop, and equals the reference's S=1
    federation."""
    dlg, fail, loop_kw = _s1_case(case)
    c1, r1, m1 = _single_heap(dlg, fail=fail, **loop_kw("port"))
    c2, r2, m2 = _federated_s1("port", dlg, fail=fail, **loop_kw("port"))
    assert records(c1) == records(c2)
    assert r1.accounts == r2.accounts
    assert r1.settlement.head == r2.settlement.head
    assert m1["n"] == m2["n"]
    assert m2["federation"]["exactly_once"]["ok"]
    ref_dlg = ref_serving.generate(ref_serving.WorkloadSpec(
        "coqa_like", n_dialogues=len(dlg), seed=5 if case == "open" else 3))
    c3, _, m3 = _federated_s1("ref", ref_dlg, fail=fail, **loop_kw("ref"))
    assert records(c3) == records(c2)
    assert_same_federation(m3, m2)


# -------------------------------------------- exactly-once + migration --
def _overloaded(pkg, *, fail=0.1, shard_schedule=None, digests=None):
    """3 super-hubs with every dialogue forced into ONE domain: the home
    shard saturates, the other two idle — spill must migrate.  Every digest
    the run publishes is appended to ``digests``."""
    sv = ref_serving if pkg == "ref" else port_serving
    dlg = sv.generate(sv.WorkloadSpec("coqa_like",
                                      n_dialogues=OVERLOADED_DIALOGUES,
                                      seed=1))
    dom = sorted({d.domain for d in dlg})[0]
    dlg = [type(d)(d.dialogue_id, dom, d.turns, d.difficulty) for d in dlg]
    fed = build(pkg, dlg, n_agents=12, super_hubs=3,
                arrivals=sv.PoissonArrivals(rate=300.0, seed=2), seed=0,
                router_kwargs=dict(ROUTER_KW),
                loop_kwargs=dict(batch_cap=32, batch_window=0.05,
                                 max_new_tokens=4),
                cluster_kwargs=dict(max_new_tokens=4, fail_prob=fail),
                max_inflight=900, epoch=0.25, spill_min_wait=0.2,
                shard_schedule=shard_schedule)
    if digests is not None:
        publish = fed.gossip.publish

        def keep(d):
            digests.append(d)
            publish(d)
        fed.gossip.publish = keep
    return fed.run()


@pytest.fixture(scope="module")
def overloaded_pair():
    """(reference report, its digests, port report, its digests) of the
    overloaded S=3 run with faults."""
    ref_d, port_d = [], []
    ref = _overloaded("ref", digests=ref_d)
    port = _overloaded("port", digests=port_d)
    return ref, ref_d, port, port_d


def test_s3_matches_reference_under_faults_and_migration(overloaded_pair):
    """The overloaded S=3 run with faults and spill: the port equals the
    reference, and every dialogue settles exactly once (ledger replays,
    disjoint request-id prefixes, conserved migrations)."""
    ref, _, port, _ = overloaded_pair
    assert_same_federation(ref, port)
    eo = port["federation"]["exactly_once"]
    assert port["federation"]["spill_migrated"] > 0
    assert port["migrated_in"] == port["migrated_out"] > 0
    assert eo["ok"] and eo["ledger_replay_ok"] and eo["lost_dialogues"] == 0
    assert eo["ledgers_attached"] == 3
    assert port["dialogues_arrived"] == OVERLOADED_DIALOGUES
    assert port["dialogues_completed"] + port["unfinished_dialogues"] == \
        OVERLOADED_DIALOGUES
    assert not port["truncated"]


def test_digests_match_reference_field_by_field(overloaded_pair):
    """Every digest cut at every boundary (agent asks, free slack,
    utilization, EWMA, standing warm-start asks) equals the reference's."""
    _, ref_d, _, port_d = overloaded_pair
    assert len(ref_d) == len(port_d) > 0
    warm = 0
    for a, b in zip(ref_d, port_d):
        assert (a.super_id, a.epoch, a.total_slack()) == \
            (b.super_id, b.epoch, b.total_slack())
        assert len(a.asks) == len(b.asks)
        for x, y in zip(a.asks, b.asks):
            assert isinstance(y.asks, np.ndarray)
            assert y.asks.dtype == np.float64
            np.testing.assert_array_equal(x.asks, y.asks)
            for f in ("agent_id", "free", "capacity", "price_miss",
                      "price_hit", "price_out", "scale", "domains",
                      "utilization", "ewma_gen"):
                assert getattr(x, f) == getattr(y, f), f
            warm += len(y.asks) > 0
    assert warm > 0                      # some digest carried warm asks


def test_gossip_staleness_bounded_by_one_epoch(overloaded_pair):
    """With digests refreshed at every boundary, no spill valuation
    consumes a digest older than one epoch."""
    g = overloaded_pair[2]["federation"]["gossip"]
    assert g["digests"] == 3
    assert g["max_staleness_epochs"] <= 1


def test_bit_determinism_under_shuffled_shard_schedule(overloaded_pair):
    """Reversed and rotating shard advance orders replay the same ledger
    heads, accounts and migrations (the fold_in-style seed split)."""
    base = overloaded_pair[2]

    def rotating(epoch_idx):
        k = epoch_idx % 3
        return [0, 1, 2][k:] + [0, 1, 2][:k]

    for sched in ([2, 1, 0], rotating):
        out = _overloaded("port", shard_schedule=sched)
        assert heads(out) == heads(base)
        assert out["accounts"] == base["accounts"]
        assert out["federation"]["spill_migrated"] == \
            base["federation"]["spill_migrated"]


# ----------------------------------------- the card's solver, S=2 ------
def _two_domain_run(pkg, solver):
    """S=2 over 16 agents with the dialogues split between two home shards
    (every other coqa_like dialogue moved to the ``code`` domain); no
    faults, which the S=3 case covers (each fault adds the reference's
    ``dense-jax`` a compile of a new shape)."""
    sv = ref_serving if pkg == "ref" else port_serving
    dlg = sv.generate(sv.WorkloadSpec("coqa_like", n_dialogues=10, seed=4))
    dlg = [type(d)(d.dialogue_id, "code" if i % 2 else d.domain, d.turns,
                   d.difficulty) for i, d in enumerate(dlg)]
    return build(pkg, dlg, n_agents=16, super_hubs=2,
                 arrivals=sv.PoissonArrivals(rate=30.0, seed=2), seed=0,
                 router_kwargs=dict(solver=solver, warm_start=True,
                                    audit_ledger=True),
                 loop_kwargs=dict(batch_cap=8, batch_window=0.05,
                                  max_new_tokens=4),
                 cluster_kwargs=dict(max_new_tokens=4),
                 max_inflight=128, epoch=0.25).run()


def test_s2_cuda_solver_matches_reference_dense_jax():
    """The path the card runs — the port's ``cuda`` solver, here its plain
    staged market — against the reference's float32 staged ``dense-jax``
    solver in an S=2 federation whose shards both serve."""
    ref = _two_domain_run("ref", "dense-jax")
    port = _two_domain_run("port", "cuda")
    assert_same_federation(ref, port, "dense-jax", "cuda")
    assert all(s["n"] > 0 for s in port["shards"])
    assert port["federation"]["exactly_once"]["ok"]


# --------------------------------------------------- seeds, partition --
def test_shard_seed_equals_reference():
    seeds = [port_dist.shard_seed(7, k) for k in range(16)]
    assert seeds == [ref_dist.shard_seed(7, k) for k in range(16)]
    assert len(set(seeds)) == 16
    assert port_dist.shard_seed(8, 0) != seeds[0]
    assert port_dist.worker_slots(10 ** 6) == ref_dist.worker_slots(10 ** 6)


def test_super_hub_partition_equals_reference():
    """`cluster_super_hubs` (positional ids, coverage, inner-hub counts)
    and `route_to_super_hub` on the reference test's fleet."""
    rng = np.random.default_rng(0)
    doms = [("qa",), ("code",), ("math",), ("qa", "code")] * 8
    scales = list(rng.uniform(0.5, 2.0, len(doms)))
    for s, per_hub in ((3, 16), (3, 4), (5, 2)):
        ours = port_hub.cluster_super_hubs(doms, scales, s,
                                           agents_per_hub=per_hub)
        theirs = ref_hub.cluster_super_hubs(doms, scales, s,
                                            agents_per_hub=per_hub)
        assert [(h.hub_id, h.agent_indices, h.domains, h.n_inner_hubs)
                for h in ours] == \
            [(h.hub_id, h.agent_indices, h.domains, h.n_inner_hubs)
             for h in theirs]
        assert [h.hub_id for h in ours] == list(range(len(ours)))
        assert sorted(i for h in ours for i in h.agent_indices) == \
            list(range(len(doms)))
        for d in ("qa", "code", "math", "none"):
            assert port_hub.route_to_super_hub(d, ours, doms) == \
                ref_hub.route_to_super_hub(d, theirs, doms)


def test_gossip_book_equals_reference():
    """`GossipBook` publish / fresh / stats and `GossipDigest.total_slack`
    against the reference's on the same digests."""
    books = (port_hub.GossipBook(), ref_hub.GossipBook())
    for epoch in range(4):
        for mod, book in zip((port_hub, ref_hub), books):
            for sid in range(3):
                if (sid + epoch) % 2:
                    continue                 # a shard that skips a boundary
                ask = mod.AgentAsk(f"a{sid}", free=sid + epoch, capacity=4,
                                   price_miss=1.0, price_hit=0.5,
                                   price_out=2.0, scale=1.0,
                                   domains=("qa",), utilization=0.5,
                                   ewma_gen=32.0, asks=np.zeros(0))
                book.publish(mod.GossipDigest(sid, epoch, [ask, ask]))
        got = [[(d.super_id, d.epoch, d.total_slack())
                for d in book.fresh(epoch % 3, epoch + 1)] for book in books]
        assert got[0] == got[1]
    assert books[0].stats() == books[1].stats()
    assert books[0].max_staleness >= 1


# ----------------------------------------------------- process workers --
def _process_case(parallel):
    dlg = port_serving.generate(port_serving.WorkloadSpec(
        "coqa_like", n_dialogues=40, seed=1))
    dlg = [type(d)(d.dialogue_id, "code" if i % 3 == 0 else d.domain,
                   d.turns, d.difficulty) for i, d in enumerate(dlg)]
    return port_serving.build_federation(
        dlg, n_agents=16, super_hubs=2,
        arrivals=port_serving.PoissonArrivals(rate=30.0, seed=2), seed=0,
        router_kwargs=dict(ROUTER_KW),
        loop_kwargs=dict(batch_cap=16, batch_window=0.05, max_new_tokens=4),
        cluster_kwargs=dict(max_new_tokens=4), max_inflight=128,
        epoch=0.25, parallel=parallel, device="cpu")


def _tensors_in(x) -> int:
    """Torch tensors anywhere inside ``x`` (containers, dataclasses)."""
    if isinstance(x, torch.Tensor):
        return 1
    if isinstance(x, dict):
        return sum(_tensors_in(v) for v in x.values())
    if isinstance(x, (list, tuple, set)):
        return sum(_tensors_in(v) for v in x)
    if hasattr(x, "__dict__"):
        return sum(_tensors_in(v) for v in vars(x).values())
    return 0


def test_process_shards_equal_inline_shards(monkeypatch):
    """An S=2 run with each shard in its own spawned process replays the
    inline run bit for bit; nothing an inline shard returns through the
    control surface (what a process shard pickles) holds a tensor."""
    crossed = []
    for name in ("advance", "digest", "residuals", "extract", "finalize"):
        def spy(self, *args, _f=getattr(port_fed_mod.InlineShard, name)):
            out = _f(self, *args)
            crossed.append(_tensors_in(out))
            return out
        monkeypatch.setattr(port_fed_mod.InlineShard, name, spy)
    inline = _process_case("inline").run()
    monkeypatch.undo()
    assert len(crossed) > 0 and sum(crossed) == 0
    fed = _process_case("process")
    assert all(isinstance(h, port_dist.ProcessShardHandle)
               for h in fed.shards)
    out = fed.run()
    assert comparable(out) == comparable(inline)
    assert heads(out) == heads(inline)
    assert out["accounts"] == inline["accounts"]
    assert out["federation"]["exactly_once"]["ok"]
    assert all(s["n"] > 0 for s in out["shards"])
    assert not any(h._proc.is_alive() for h in fed.shards)


def test_federation_modules_match_reference_surface():
    """The port exports what the reference's federation modules export."""
    assert port_fed_mod.__all__ == ref_fed_mod.__all__
    for name in ("PRIOR_LPT", "PRIOR_LB", "PRIOR_Q"):
        assert getattr(port_fed_mod, name) == getattr(ref_fed_mod, name)
    for name in ("FederatedSimulator", "InlineShard", "build_federation"):
        assert getattr(port_serving, name) is getattr(port_fed_mod, name)
    spec = port_dist.ShardSpec(0, [], 0)
    assert spec.device == "cuda"


def test_federation_on_cuda_raises_without_a_card():
    """Every shard is built on the card by default: without one,
    `build_federation` raises instead of moving to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    dlg = port_serving.generate(port_serving.WorkloadSpec(
        "coqa_like", n_dialogues=2, seed=1))
    for parallel in ("inline", "process"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port_serving.build_federation(dlg, n_agents=8, super_hubs=2,
                                          parallel=parallel)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_serving.FederatedSimulator([], [], [])


def test_process_worker_that_fails_to_start_raises(monkeypatch):
    """A worker whose shard cannot be built raises in `build_federation`
    (no inline fallback), and the other workers are shut down."""
    dlg = port_serving.generate(port_serving.WorkloadSpec(
        "coqa_like", n_dialogues=2, seed=1))
    started = []
    init = port_dist.ProcessShardHandle.__init__

    def keep(self, *args, **kw):
        init(self, *args, **kw)
        started.append(self)
    monkeypatch.setattr(port_dist.ProcessShardHandle, "__init__", keep)
    with pytest.raises(RuntimeError, match="failed to start"):
        port_serving.build_federation(
            dlg, n_agents=8, super_hubs=2, parallel="process",
            router_kwargs={"no_such_option": 1}, device="cpu")
    assert len(started) == 2
    assert not any(h._proc.is_alive() for h in started)
