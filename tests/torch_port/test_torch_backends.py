"""The port's host-side solver backends and predictor options against the
reference on the CPU.

Bit for bit against the JAX package, which is pure float64 NumPy/Python on
these paths: the exact MCMF oracle (``solve_allocation`` and
``McmfBackend`` in both payment modes), the slot-expanded parity oracle
``solve_dense_auction_slots`` and ``DenseNumpyBackend``, the router with
``solver="mcmf"`` and ``solver="dense"`` in lockstep, and the scalar
per-pair Phase 1 (``batched=False``).  The float32 device descend
``descend_torch`` and ``predict_matrix(backend="torch")`` equal the
reference's ``descend_jax`` and ``backend="jax"`` bit for bit (both walk
float32 features against float32 thresholds); against the float64 NumPy
walk they carry the reference's own caveat: a feature within float32
rounding of a threshold can flip a leaf."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import mechanism as ref_mech  # noqa: E402
from repro.core.hoeffding import descend_jax  # noqa: E402
from repro.core.predictor import PredictorInput as RefInput  # noqa: E402
from repro.core.predictor import PredictorPool as RefPool  # noqa: E402
from repro.core.pricing import TokenPrices as RefPrices  # noqa: E402
from repro.core.solvers.dense_np import DenseNumpyBackend as RefDense  # noqa: E402,E501
from repro.core.solvers.dense_np import \
    solve_dense_auction_slots as ref_slots  # noqa: E402
from repro.core.solvers.mcmf import McmfBackend as RefMcmf  # noqa: E402
from repro.core.solvers.mcmf import \
    solve_allocation as ref_allocation  # noqa: E402
from repro_torch.configs.iemas_cluster import RouterConfig  # noqa: E402
from repro_torch.core import mechanism as port_mech  # noqa: E402
from repro_torch.core.hoeffding import descend_torch  # noqa: E402
from repro_torch.core.predictor import PredictorInput, PredictorPool  # noqa: E402,E501
from repro_torch.core.pricing import TokenPrices  # noqa: E402
from repro_torch.core.solvers import available_solvers, get_solver  # noqa: E402,E501
from repro_torch.core.solvers.dense_np import \
    solve_dense_auction_slots  # noqa: E402
from repro_torch.core.solvers.mcmf import solve_allocation  # noqa: E402

AGENTS = [f"a{i}" for i in range(5)]
TELEMETRY = {"router_inflight": 2, "router_rps": 1.0,
             "agent_inflight": {"a0": 1}, "agent_rps": {"a1": 0.5}}


def _market(seed: int, n: int = 7, m: int = 4):
    rng = np.random.default_rng(seed)
    values = rng.uniform(0, 6, (n, m)) * (rng.random((n, m)) > 0.3)
    costs = rng.uniform(0, 3, (n, m))
    return np.maximum(values - costs, 0.0), costs, \
        [int(c) for c in rng.integers(0, 4, m)]


def _same_auction(a, b):
    assert a.assignment == b.assignment
    assert a.welfare == b.welfare
    assert a.payments == b.payments
    assert np.array_equal(a.weights, b.weights)
    for k in ("solver", "payment_mode", "resolves", "rounds", "warm_started",
              "warm_fallback", "gap_bound"):
        assert a.solver_stats.get(k) == b.solver_stats.get(k), k


def test_registry_names_and_config():
    """``mcmf`` and ``dense`` are registered beside ``dense-torch`` and
    ``cuda``; the RouterConfig carries ``batched`` and
    ``predictor_backend`` to the router."""
    assert available_solvers() == ["cuda", "dense", "dense-torch", "mcmf"]
    assert not get_solver("mcmf").supports_warm_start
    assert get_solver("dense").supports_warm_start
    kw = RouterConfig(batched=False, predictor_backend="torch",
                      fused=True).router_kwargs()
    assert (kw["batched"], kw["predictor_backend"], kw["fused"]) == \
        (False, "torch", True)
    from repro_torch.core import auction_dense
    assert set(auction_dense.__all__) == {
        "DenseAuctionResult", "solve_dense_auction",
        "solve_dense_auction_torch", "solve_dense_auction_torch_batch",
        "dense_clarke_payments"}


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_solve_allocation_matches_reference(seed):
    w, _, caps = _market(seed)
    a, wf, _ = solve_allocation(w, caps)
    b, wf_ref, _ = ref_allocation(w, caps)
    assert a == b and wf == wf_ref


@pytest.mark.parametrize("mode", ["naive", "warmstart"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mcmf_backend_matches_reference(seed, mode):
    """Both payment modes, payments equal to the last bit; the port takes
    ``device=`` and moves nothing."""
    w, costs, caps = _market(seed)
    got = get_solver("mcmf").solve(w, costs, caps, payment_mode=mode,
                                   device="cpu")
    want = RefMcmf().solve(w, costs, caps, payment_mode=mode)
    _same_auction(got, want)


@pytest.mark.parametrize("warm", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_slots_oracle_and_dense_backend_match_reference(seed, warm):
    w, costs, caps = _market(seed, n=9, m=5)
    seed_prices = None
    if warm:
        first = ref_slots(w, caps)
        seed_prices = first.flat_prices * 1.01
    a = solve_dense_auction_slots(w, caps, start_prices=seed_prices)
    b = ref_slots(w, caps, start_prices=seed_prices)
    assert a.assignment == b.assignment and a.welfare == b.welfare
    assert (a.rounds, a.phases, a.eps) == (b.rounds, b.phases, b.eps)
    assert (a.warm_started, a.fallback) == (b.warm_started, b.fallback)
    for pa, pb in zip(a.agent_prices, b.agent_prices):
        assert np.array_equal(pa, pb)
    got = get_solver("dense").solve(w, costs, caps, start_prices=seed_prices,
                                    device="cuda")   # host solver: no move
    want = RefDense().solve(w, costs, caps, start_prices=seed_prices)
    _same_auction(got, want)
    assert [np.array_equal(p, q) for p, q in zip(
        got.solver_stats["agent_prices"],
        want.solver_stats["agent_prices"])] == [True] * len(caps)


def _agents(mech, prices_cls, m: int = 5, cap: int = 2):
    out = []
    for i in range(m):
        pr = prices_cls(0.01 * (1 + i / m), 0.001 * (1 + i / m),
                        0.03 * (1 + i / m))
        out.append(mech.AgentInfo(f"a{i}", pr, cap,
                                  ("dialogue",) if i % 2 == 0
                                  else ("dialogue", "reasoning"),
                                  scale=4.0 + i, recurrent=(i == 3),
                                  cache_slots=2 if i == 1 else 0))
    return out


def _batch(mech, n: int, t: int, seed: int):
    rng = np.random.default_rng(seed * 1000 + t)
    return [mech.Request(f"r{t}_{j}", f"d{j % 4}",
                         rng.integers(0, 50, int(rng.integers(5, 30))),
                         turn=t, domain="dialogue" if j % 2 == 0
                         else "reasoning")
            for j in range(n)]


def _same_decisions(dp, dr):
    assert len(dp) == len(dr)
    for p, r in zip(dp, dr):
        assert (p.request.request_id, p.agent_id, p.hub_id) == \
            (r.request.request_id, r.agent_id, r.hub_id)
        assert p.payment == r.payment
        assert p.welfare_weight == r.welfare_weight
        if r.estimate is not None:
            assert (p.estimate.latency, p.estimate.cost,
                    p.estimate.quality) == (r.estimate.latency,
                                            r.estimate.cost,
                                            r.estimate.quality)


def _lockstep(port_kw: dict, ref_kw: dict, batches: int, seed: int):
    port = port_mech.IEMASRouter(_agents(port_mech, TokenPrices),
                                 device="cpu", **port_kw)
    ref = ref_mech.IEMASRouter(_agents(ref_mech, RefPrices), **ref_kw)
    rng = np.random.default_rng(seed + 99)
    for t in range(batches):
        n = int(rng.integers(2, 9))
        dp = port.route_batch(_batch(port_mech, n, t, seed), dict(TELEMETRY))
        dr = ref.route_batch(_batch(ref_mech, n, t, seed), dict(TELEMETRY))
        _same_decisions(dp, dr)
        for d in dr:
            if d.agent_id:
                kw = dict(latency=0.03 + 0.01 * rng.random(),
                          n_prompt=len(d.request.tokens), n_hit=0, n_gen=20,
                          quality=0.7)
                ref.on_complete(d.request.request_id,
                                ref_mech.CompletionObs(**kw))
                port.on_complete(d.request.request_id,
                                 port_mech.CompletionObs(**kw))
    assert port.accounts == ref.accounts
    return port, ref


@pytest.mark.parametrize("solver", ["mcmf", "dense"])
def test_router_on_host_solvers_matches_reference(solver):
    """The router with the exact oracle and with the float64 dense auction
    (warm starts on: a no-op for mcmf) in lockstep with the reference's:
    every decision, payment and estimate bit for bit."""
    kw = dict(solver=solver, n_hubs=1, warm_start=True)
    _lockstep(dict(kw, use_kernel_affinity=False), kw, 6, seed=3)


def test_scalar_phase1_matches_reference():
    """``batched=False`` (the per-pair scalar oracle loop) against the
    reference's ``batched=False``, and against the port's batched router:
    the same decisions to the last bit."""
    kw = dict(solver="dense", n_hubs=1, batched=False)
    _lockstep(dict(kw, use_kernel_affinity=False), kw, 6, seed=4)
    _lockstep(dict(solver="dense", n_hubs=1, use_kernel_affinity=False),
              kw, 6, seed=4)


def _trained_pools(seed: int, n_obs: int = 1200):
    """A port pool and a reference pool fed the same observations, enough
    for the trees to split."""
    rng = np.random.default_rng(seed)
    port = PredictorPool({a: TokenPrices(0.01, 0.001, 0.03) for a in AGENTS})
    ref = RefPool({a: RefPrices(0.01, 0.001, 0.03) for a in AGENTS})
    for k in range(n_obs):
        a = AGENTS[k % len(AGENTS)]
        x = rng.uniform(0, 1, 10) * np.array([400, 6, 1, 8, 4, 3, 2, 4, 1, 1])
        # steps in the features, so every target splits
        lat = 0.02 + 0.3 * (x[0] > 200)
        cost = 0.01 + 2.0 * (x[7] > 2)
        q = float(x[9] > 0.5)
        port[a].update(PredictorInput(*x), lat, cost, q)
        ref[a].update(RefInput(*x), lat, cost, q)
    return port, ref, rng


@pytest.mark.parametrize("seed", [0, 1])
def test_descend_torch_matches_descend_jax(seed):
    """The float32 walk on the port's device equals the reference's
    float32 jit walk bit for bit on a trained stacked forest, with rows,
    nodes and depth padded to their buckets; against the float64 NumPy walk
    the leaves agree except within float32 rounding of a threshold (the
    reference's own caveat), so that comparison is not asserted exact."""
    port, ref, rng = _trained_pools(seed)
    X = rng.uniform(0, 1, (37, 10)) * np.array([400, 6, 1, 8, 4, 3, 2, 4, 1, 1])
    for name in ("lat", "cost", "quality"):
        stacked, roots = port._stacked_forest(name, AGENTS)
        rstacked, rroots = ref._stacked_forest(name, AGENTS)
        assert stacked.depth >= 1       # the trees did split
        tree_of = rng.integers(0, len(AGENTS), 37)
        got = descend_torch(stacked, X, roots[tree_of], device="cpu")
        want = descend_jax(rstacked, X, rroots[tree_of])
        assert got.dtype == np.float64
        assert np.array_equal(got, want)
    tree = port["a0"].lat
    assert np.array_equal(tree.predict_batch(X, "torch", "cpu"),
                          ref["a0"].lat.predict_batch(X, "jax"))


def test_predict_matrix_and_rows_torch_backend_match_reference():
    """``predict_matrix(backend="torch")`` equals the reference's
    ``backend="jax"``; ``predict_rows`` equals the reference's on both
    backends."""
    port, ref, rng = _trained_pools(2)
    X = rng.uniform(0, 1, (6, len(AGENTS), 10)) * \
        np.array([400, 6, 1, 8, 4, 3, 2, 4, 1, 1])
    got = port.predict_matrix(AGENTS, X, backend="torch", device="cpu")
    want = ref.predict_matrix(AGENTS, X, backend="jax")
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    rows = X[:, 0, :]
    for bp, br in (("numpy", "numpy"), ("torch", "jax")):
        got = port["a0"].predict_rows(rows, bp, "cpu")
        want = ref["a0"].predict_rows(rows, br)
        for g, w in zip(got, want):
            assert np.array_equal(g, w)


def test_router_torch_predictor_backend_runs_on_device():
    """``predictor_backend="torch"`` in the router against the reference's
    ``"jax"``: the same decisions in lockstep (the dense float64 auction
    downstream)."""
    _lockstep(dict(solver="dense", n_hubs=1, use_kernel_affinity=False,
                   predictor_backend="torch"),
              dict(solver="dense", n_hubs=1, predictor_backend="jax"), 5,
              seed=6)
