"""The port's router against the reference router in lockstep on the CPU.

The reference is ``IEMASRouter(solver="dense-jax", n_hubs=1,
warm_start=True, use_kernel_affinity=True, audit_ledger=True)``; the port is
the same router with ``solver="cuda", device="cpu"`` (the plain kernel
versions).  Both route the same seeded coqa_like + quac_like closed loop and
receive the same completion feedback from the reference's analytic engines.
Gate: identical decisions (agent, payment bit for bit, hub, estimate),
identical accounts and the same settlement-ledger head hash.  The same
lockstep runs at 2 and 4 hubs, with the spill round on and off and agents
quarantined, added and removed mid-loop (the port's ``cuda`` backend solving
every hub block in one call, the reference's ``dense-jax`` one vmapped
program per bucket).  The carry test moves a warmed reference router's
state into a port router and continues in lockstep."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import mechanism as ref_mech  # noqa: E402
from repro.core.pricing import TokenPrices as RefPrices  # noqa: E402
from repro.serving.analytic import AnalyticEngine  # noqa: E402
from repro.serving.workload import WorkloadSpec, generate  # noqa: E402
from repro_torch.configs.iemas_cluster import (RouterConfig,  # noqa: E402
                                               agent_infos, agent_profiles,
                                               make_router)
from repro_torch.core import mechanism as port_mech  # noqa: E402
from repro_torch.core.carry import router_from_reference_state  # noqa: E402

N_AGENTS = 10
BATCH = 8            # a fixed batch size keeps the reference's jit cache small
CFG = RouterConfig(solver="cuda", n_hubs=1, warm_start=True,
                   use_kernel_affinity=True, audit_ledger=True)
STATS = ("n", "s", "ss", "cls", "bins_lo", "bins_hi", "bin_n", "bin_s",
         "bin_ss", "bin_cls", "n_bins")


def _profiles():
    """Heterogeneous capacities and cache sizes over the preset fleet."""
    import dataclasses

    return [dataclasses.replace(p, capacity=2 + i % 3, cache_slots=3)
            for i, p in enumerate(agent_profiles(N_AGENTS, seed=1))]


def _ref_info(p):
    return ref_mech.AgentInfo(p.agent_id,
                              RefPrices(p.price_miss, p.price_hit,
                                        p.price_out),
                              p.capacity, p.domains, p.scale,
                              cache_slots=p.cache_slots)


def _ref_router(profiles, n_hubs: int = 1, spill: bool = True,
                hub_scheme: str = "domain"):
    return ref_mech.IEMASRouter([_ref_info(p) for p in profiles],
                                solver="dense-jax", n_hubs=n_hubs,
                                hub_scheme=hub_scheme, warm_start=True,
                                use_kernel_affinity=True, audit_ledger=True,
                                spill=spill)


class ClosedLoop:
    """Seeded multi-turn dialogues routed in FIFO batches of ``BATCH``;
    every matched request is served on the reference's analytic engine of
    its agent and both routers get the same completion."""

    def __init__(self, profiles, seed: int, mixed: bool = False):
        scripts = generate(WorkloadSpec("coqa_like", 10, seed=seed)) + \
            generate(WorkloadSpec("quac_like", 8, seed=seed))
        if mixed:
            # three domains, interleaved, so a batch spans several hubs
            from itertools import chain, zip_longest

            scripts += generate(WorkloadSpec("hotpot_like", 8, seed=seed))
            by_dom = {}
            for s in scripts:
                by_dom.setdefault(s.domain, []).append(s)
            scripts = [s for s in chain(*zip_longest(*by_dom.values()))
                       if s is not None]
        self.scripts = {s.dialogue_id: s for s in scripts}
        self.turn = {d: 0 for d in self.scripts}
        self.history = {d: np.zeros(0, np.int32) for d in self.scripts}
        self.ready = list(self.scripts)
        self.engines, self.scale = {}, {}
        for i, p in enumerate(profiles):
            self.add_engine(p, seed=i)
        self.rid = 0
        self.now = 0.0

    def add_engine(self, p, seed: int) -> None:
        self.engines[p.agent_id] = AnalyticEngine(
            p.model_class, seed=seed, speed=p.speed,
            cache_slots=p.cache_slots, max_new_tokens=6)
        self.scale[p.agent_id] = p.scale

    def batch(self):
        out = []
        for did in self.ready[:BATCH]:
            s = self.scripts[did]
            toks = np.concatenate([self.history[did],
                                   s.turns[self.turn[did]]]).astype(np.int32)
            out.append((f"r{self.rid}", did, toks, self.turn[did], s.domain,
                        {"difficulty": s.difficulty}))
            self.rid += 1
        self.ready = self.ready[BATCH:]
        return out

    def step(self, routers):
        """One batch through every router; returns their decisions."""
        reqs = self.batch()
        telemetry = {"router_inflight": len(reqs), "router_rps": 2.0}
        decided = []
        for r in routers:
            mech = port_mech if isinstance(r, port_mech.IEMASRouter) \
                else ref_mech
            decided.append(r.route_batch(
                [mech.Request(rid, did, toks.copy(), turn, dom, 6, dict(meta))
                 for rid, did, toks, turn, dom, meta in reqs], telemetry))
        back = []
        self.now += 1.0
        for d in decided[0]:
            req = d.request
            if d.agent_id is None:
                back.append(req.dialogue_id)
                continue
            res = self.engines[d.agent_id].serve(req.dialogue_id, req.tokens,
                                                 now=self.now)
            diff = float(req.meta["difficulty"])
            quality = min(1.0, 0.3 + 0.05 * self.scale[d.agent_id]
                          - 0.2 * diff)
            for r in routers:
                mech = port_mech if isinstance(r, port_mech.IEMASRouter) \
                    else ref_mech
                r.on_complete(req.request_id, mech.CompletionObs(
                    res.ttft, res.n_prompt, res.n_hit, res.n_gen, quality))
            did = req.dialogue_id
            self.history[did] = np.concatenate([req.tokens,
                                                res.output_tokens])
            self.turn[did] += 1
            if self.turn[did] < len(self.scripts[did].turns):
                self.ready.append(did)
        self.ready = back + self.ready
        return decided


def assert_same(ref_dec, port_dec, ref, port):
    assert len(ref_dec) == len(port_dec)
    for a, b in zip(ref_dec, port_dec):
        assert a.request.request_id == b.request.request_id
        assert (a.agent_id, a.hub_id) == (b.agent_id, b.hub_id)
        assert a.payment == b.payment
        assert a.welfare_weight == b.welfare_weight
        if a.agent_id is None:
            assert b.estimate is None
        else:
            assert (a.estimate.latency, a.estimate.cost,
                    a.estimate.quality) == (b.estimate.latency,
                                            b.estimate.cost,
                                            b.estimate.quality)
    assert ref.accounts == port.accounts
    assert ref.settlement.head == port.settlement.head
    assert ref.price_book.stats() == port.price_book.stats()


@pytest.mark.parametrize("seed", [0, 1])
def test_router_lockstep_matches_reference(seed):
    profiles = _profiles()
    ref = _ref_router(profiles)
    port = make_router(agent_infos(profiles), CFG, device="cpu")
    loop = ClosedLoop(profiles, seed)
    matched = 0
    for _ in range(5):
        ref_dec, port_dec = loop.step([ref, port])
        assert_same(ref_dec, port_dec, ref, port)
        matched += sum(d.agent_id is not None for d in port_dec)
    assert matched >= 20 and port.price_book.warm_hits >= 3
    assert port.settlement.verify_chain()
    port.settlement.audit(port.accounts)


# hub cuts under which this fleet's three request domains reach 2-3 hubs
@pytest.mark.parametrize("n_hubs,spill,scheme", [
    (2, True, "scale"), (2, False, "scale"), (4, True, "random"),
    (4, False, "domain")])
def test_hub_sharded_lockstep_matches_reference(n_hubs, spill, scheme):
    """Per-hub auctions in one batched solve, the spill round, and the
    fleet changing under the router: agent-3 quarantined before batch 2 and
    reinstated before batch 4, a new agent added before batch 3 (the hubs
    are recut), agent-5 removed before batch 4."""
    import dataclasses

    profiles = _profiles()
    ref = _ref_router(profiles, n_hubs, spill, scheme)
    port = make_router(agent_infos(profiles),
                       dataclasses.replace(CFG, n_hubs=n_hubs, spill=spill,
                                           hub_scheme=scheme),
                       device="cpu")
    loop = ClosedLoop(profiles, seed=n_hubs + 5 * spill, mixed=True)
    extra = dataclasses.replace(agent_profiles(N_AGENTS + 1, seed=1)[-1],
                                capacity=3, cache_slots=3)
    for step in range(5):
        if step == 1:
            for r in (ref, port):
                r.quarantine("agent-3")
        if step == 2:
            loop.add_engine(extra, seed=N_AGENTS)
            ref.add_agent(_ref_info(extra))
            port.add_agent(agent_infos([extra])[0])
        if step == 3:
            for r in (ref, port):
                r.reinstate("agent-3")
                r.remove_agent("agent-5")
        assert_same(*loop.step([ref, port]), ref, port)
    assert len(port.hubs) == len(ref.hubs) > 1
    assert port.settlement.verify_chain()


def test_incremental_routes_match_reference():
    """Mid-window arrivals routed at the standing duals, then re-equilibrated
    by the next batch auction as shadow participants, in lockstep."""
    profiles = _profiles()
    ref = _ref_router(profiles)
    port = make_router(agent_infos(profiles), CFG, device="cpu")
    loop = ClosedLoop(profiles, seed=3)
    for _ in range(2):
        assert_same(*loop.step([ref, port]), ref, port)
    reqs = loop.batch()[:3]
    telemetry = {"router_inflight": 3, "router_rps": 2.0}
    got = port.route_incremental(
        [port_mech.Request(*r[:5], 6, dict(r[5])) for r in reqs], telemetry)
    want = ref.route_incremental(
        [ref_mech.Request(*r[:5], 6, dict(r[5])) for r in reqs], telemetry)
    assert_same(want, got, ref, port)
    assert port.accounts["incremental_routed"] > 0
    loop.ready = [r[1] for r in reqs if r[1] not in
                  {d.request.dialogue_id for d in got if d.agent_id}] + \
        loop.ready
    assert_same(*loop.step([ref, port]), ref, port)
    assert port.accounts["incremental_confirmed"] + \
        port.accounts["incremental_rerouted"] > 0


def _tree_state(tree) -> dict:
    nodes = []

    def walk(node):
        spec = {"feature": node.feature, "threshold": node.threshold,
                "depth": node.depth}
        nodes.append(spec)
        if node.feature >= 0:
            walk(node.left)
            walk(node.right)
        else:
            spec["stats"] = {k: np.copy(getattr(node.stats, k))
                             if isinstance(getattr(node.stats, k), np.ndarray)
                             else getattr(node.stats, k) for k in STATS}

    walk(tree.root)
    out = {"nodes": tuple(nodes), "n_seen": tree.n_seen,
           "y_min": tree._y_min, "y_max": tree._y_max}
    if tree.classification:
        out["global_cls"] = tree._global_cls.copy()
    else:
        out["global_s"] = tree._global_s
    return out


def reference_state(router) -> dict:
    """Walk a quiescent reference router into the plain-data carry dict."""
    import dataclasses

    assert not router._pending and not router._provisional
    led, store = router.ledger, router.ledger.store
    book = router.price_book
    return {
        "ledger": {
            "tokens": store.tokens.copy(), "lens": store.lens.copy(),
            "row_of": tuple(store.row_of.items()),
            "free": tuple(store._free), "next": store._next,
            "by_agent": tuple((a, tuple(s.items()))
                              for a, s in led._by_agent.items()),
            "clock": led._clock},
        "predictors": {
            aid: {"n_obs": p.n_obs, "ewma_gen": p.ewma_gen,
                  "reputation": p.reputation,
                  **{k: _tree_state(getattr(p, k))
                     for k in ("lat", "cost", "quality")}}
            for aid, p in router.pool._preds.items()},
        "rep_ledger": dict(router.pool._rep_ledger),
        "price_book": {
            "entries": tuple((h, v, ids, caps, tuple(prices.items()))
                             for h, (v, ids, caps, prices)
                             in book._book.items()),
            "warm_hits": book.warm_hits, "cold_starts": book.cold_starts,
            "stores": book.stores},
        "accounts": dict(router.accounts),
        "quarantined": tuple(router.quarantined),
        "agent_set_version": router.agent_set_version.version,
        "settlement": tuple(dataclasses.asdict(e)
                            for e in router.settlement.entries),
    }


def test_carried_state_continues_in_lockstep():
    profiles = _profiles()
    ref = _ref_router(profiles)
    loop = ClosedLoop(profiles, seed=2)
    for _ in range(3):
        loop.step([ref])
    assert any(p.quality.root.feature >= 0 or p.n_obs > 0
               for p in ref.pool._preds.values())
    port = router_from_reference_state(reference_state(ref),
                                       agent_infos(profiles), CFG,
                                       device="cpu")
    assert port.settlement.head == ref.settlement.head
    # the carried arena replaced the store's arrays: a mirror synced before
    # the carry must re-upload all of it
    store = port.ledger.store
    assert store.shape_version == 1
    carried = store.tokens.nbytes
    for step in range(2):
        ref_dec, port_dec = loop.step([ref, port])
        assert_same(ref_dec, port_dec, ref, port)
        mirror = port.ledger.mirror("cpu")
        if step == 0:
            assert mirror.bytes_sent >= carried
        mirror.sync()     # level with the completions' ledger writes
        assert torch.equal(mirror.tokens, torch.from_numpy(store.tokens))
    assert port.price_book.warm_hits > 0
