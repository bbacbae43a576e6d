"""The port's staged column auction (``cuda`` and ``dense-torch`` backends on
the CPU) against the reference's jit-staged ``solve_dense_auction_jax``:
identical assignments, unit indices and round counts, a bit-identical
float32 price grid, identical Clarke payments, and welfare within the
``2·n·ε`` certificate of the float64 ``dense`` solver.  Cold, warm, and a
warm seed bad enough to trip the warm round budget.  The hub batch
(``cuda``'s ``solve_batch``) against the reference's vmapped
``DenseJaxBackend.solve_batch`` on uneven hubs, warm and cold mixed and a
warm hub that trips its bucket budget into the float64 fallback, and the
ported float64 ``dense_np`` solver against the reference's."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.solvers.dense_common import jax_eps_final  # noqa: E402
from repro.core.solvers.dense_jax import (DenseJaxBackend,  # noqa: E402
                                          _get_jax_solver,
                                          solve_dense_auction_jax,
                                          solve_dense_auction_jax_batch)
from repro.core.solvers.dense_np import DenseNumpyBackend  # noqa: E402
from repro.core.solvers.dense_np import \
    solve_dense_auction as ref_dense_np  # noqa: E402
from repro_torch.core.solvers import get_solver  # noqa: E402
from repro_torch.core.solvers.cuda_backend import \
    solve_dense_auction_cuda  # noqa: E402
from repro_torch.core.solvers.dense_np import \
    solve_dense_auction as port_dense_np  # noqa: E402
from repro_torch.core.solvers.dense_torch import (  # noqa: E402
    _StagedMarket, solve_dense_auction_torch,
    solve_dense_auction_torch_batch)
from repro_torch.kernels import ops  # noqa: E402

# one market shape (n, m, cmax) = (12, 6, 4) keeps the reference's jit cache
# to a few programs
CAPS = [3, 2, 4, 1, 3, 2]
# each backend's public solve function
SOLVES = {"cuda": solve_dense_auction_cuda,
          "dense-torch": solve_dense_auction_torch}


def _market(seed: int):
    rng = np.random.default_rng(seed)
    values = rng.uniform(0, 6, (12, 6)) * (rng.random((12, 6)) > 0.3)
    costs = rng.uniform(0, 3, (12, 6))
    return np.maximum(values - costs, 0.0), costs


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_staged_state_bit_identical(seed):
    """The raw staged outputs: float32 unit-price grid (every cell, bit for
    bit), agent_of, unit_of and the round count."""
    w, _ = _market(seed)
    W = np.maximum(w, 0.0).astype(np.float32)
    counts = np.minimum(CAPS, 12).astype(np.int32)
    wmax = float(W.max())
    eps_f = jax_eps_final(wmax, np.float32)
    eps0 = max(wmax / 5.0, eps_f)
    p0 = np.zeros((6, 4), np.float32)
    ref = _get_jax_solver(200_000, batched=False)(W, counts, p0, eps0, eps_f,
                                                  5.0)
    market = _StagedMarket(torch.from_numpy(W), torch.from_numpy(counts), 4,
                           200_000, eps_f)
    got = market.solve(torch.from_numpy(p0), eps0, eps_f, 5.0)
    grid, want_grid = got[0].numpy(), np.asarray(ref[0])
    assert np.array_equal(grid.view(np.int32), want_grid.view(np.int32))
    assert np.array_equal(got[1].numpy(), np.asarray(ref[1]))
    assert np.array_equal(got[2].numpy(), np.asarray(ref[2]))
    assert got[3] == int(ref[3])


def _same_result(a, b):
    assert a.assignment == b.assignment
    assert a.rounds == b.rounds
    assert a.welfare == b.welfare
    assert a.eps == b.eps and a.gap_bound == b.gap_bound
    assert (a.warm_started, a.fallback) == (b.warm_started, b.fallback)
    for pa, pb in zip(a.agent_prices, b.agent_prices):
        assert np.array_equal(pa, pb)


@pytest.mark.parametrize("solver", sorted(SOLVES))
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_backend_matches_dense_jax_cold_and_warm(solver, seed):
    w, costs = _market(seed)
    backend = get_solver(solver)
    got = backend.solve(w, costs, CAPS, device="cpu")
    want = DenseJaxBackend().solve(w, costs, CAPS)
    assert got.assignment == want.assignment
    assert got.payments == want.payments
    assert got.solver_stats["rounds"] == want.solver_stats["rounds"]
    for pa, pb in zip(got.solver_stats["agent_prices"],
                      want.solver_stats["agent_prices"]):
        assert np.array_equal(pa, pb)
    # certified against the float64 reference solver
    exact = DenseNumpyBackend().solve(w, costs, CAPS)
    assert abs(got.welfare - exact.welfare) <= \
        got.solver_stats["gap_bound"] + 1e-9
    # warm: reseed from perturbed duals of this market
    rng = np.random.default_rng(seed + 100)
    seed_prices = np.concatenate(want.solver_stats["agent_prices"])
    seed_prices = seed_prices * rng.uniform(0.8, 1.2, seed_prices.shape)
    warm = SOLVES[solver](w, CAPS, start_prices=seed_prices, device="cpu")
    warm_ref = solve_dense_auction_jax(w, CAPS, start_prices=seed_prices)
    assert warm.warm_started and not warm.fallback
    _same_result(warm, warm_ref)


@pytest.mark.parametrize("solver", sorted(SOLVES))
def test_warm_budget_trip_falls_back_like_reference(solver):
    """A seed far above every weight makes the warm attempt bid for longer
    than the cold solve; with ``max_rounds`` just above the cold round
    count the warm budget (= max_rounds) trips and both solvers re-solve
    cold with the same rounds."""
    w, _ = _market(0)
    cold = solve_dense_auction_jax(w, CAPS)
    cap = cold.rounds + 1
    high = np.full(sum(CAPS), 50.0)
    want = solve_dense_auction_jax(w, CAPS, start_prices=high,
                                   max_rounds=cap)
    got = SOLVES[solver](w, CAPS, start_prices=high, max_rounds=cap,
                         device="cpu")
    assert want.fallback and want.warm_started
    _same_result(got, want)


def test_cold_cap_raises_like_reference():
    w, _ = _market(0)
    with pytest.raises(RuntimeError, match="failed to converge"):
        solve_dense_auction_torch(w, CAPS, max_rounds=5, device="cpu")


def test_cuda_device_without_a_card_raises(monkeypatch):
    """Nothing moves to the CPU by itself: asking for CUDA where there is
    none raises, for both backends."""
    w, costs = _market(0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        get_solver("cuda").solve(w, costs, CAPS)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        get_solver("dense-torch").solve(w, costs, CAPS, device="cuda")


# uneven hub blocks (n_h requests, m_h agents); a few pow-2 buckets keep the
# reference's vmapped trace cache small
HUBS = [(7, 3), (16, 5), (33, 4), (64, 16)]


def _hub_markets(seed: int):
    rng = np.random.default_rng(seed)
    ws, costs, caps = [], [], []
    for n, m in HUBS:
        values = rng.uniform(0, 6, (n, m)) * (rng.random((n, m)) > 0.3)
        c = rng.uniform(0, 3, (n, m))
        ws.append(np.maximum(values - c, 0.0))
        costs.append(c)
        caps.append([int(x) for x in rng.integers(1, 6, m)])
    return ws, costs, caps


def _same_backend_result(got, want):
    assert got.assignment == want.assignment
    assert got.payments == want.payments
    assert got.welfare == want.welfare
    for k in ("rounds", "eps", "gap_bound", "warm_started", "warm_fallback"):
        assert got.solver_stats[k] == want.solver_stats[k], k
    for pa, pb in zip(got.solver_stats["agent_prices"],
                      want.solver_stats["agent_prices"]):
        assert np.array_equal(pa, pb)


@pytest.mark.parametrize("seed,warm", [(0, ()), (1, (0, 2)),
                                       (2, (0, 1, 2, 3))])
def test_hub_batch_matches_dense_jax_batch(seed, warm):
    """Cold hubs, warm and cold mixed, all warm: prices, assignment,
    payments, rounds and fallback flags bit for bit, in one
    ``auction_solve`` call."""
    ws, costs, caps = _hub_markets(seed)
    first = DenseJaxBackend().solve_batch(ws, costs, caps)
    rng = np.random.default_rng(seed + 50)
    seeds = [np.concatenate(first[h].solver_stats["agent_prices"])
             * rng.uniform(0.8, 1.2) if h in warm else None
             for h in range(len(HUBS))]
    want = DenseJaxBackend().solve_batch(ws, costs, caps,
                                         start_prices_list=seeds)
    ops.reset_launch_counts()
    got = get_solver("cuda").solve_batch(ws, costs, caps,
                                         start_prices_list=seeds,
                                         device="cpu")
    assert ops.launch_counts()["auction_solve"] == 0      # plain on the CPU
    for g, w in zip(got, want):
        _same_backend_result(g, w)
    assert [g.solver_stats["warm_started"] for g in got] == \
        [h in warm for h in range(len(HUBS))]


def test_hub_batch_budget_trip_falls_back_to_dense_np():
    """A warm hub seeded far above every weight bids for longer than its
    cold solve (383 rounds against 207) and trips its bucket budget (here
    ``max_rounds``, just above the cold hubs' rounds); both batches
    re-solve it with the float64 solver, the cold hubs are unaffected."""
    ws, _, caps = _hub_markets(3)
    ws, caps = ws[:3], caps[:3]
    cold = solve_dense_auction_jax_batch(ws, caps)
    cap = max(r.rounds for r in cold) + 1
    seeds = [None, np.full(sum(min(c, 16) for c in caps[1]), 50.0), None]
    want = solve_dense_auction_jax_batch(ws, caps, start_prices_list=seeds,
                                         max_rounds=cap)
    got = solve_dense_auction_torch_batch(ws, caps, start_prices_list=seeds,
                                          max_rounds=cap, device="cpu")
    assert want[1].fallback and want[1].warm_started
    assert not any(r.fallback for h, r in enumerate(want) if h != 1)
    for g, w in zip(got, want):
        _same_result(g, w)
        assert g.eps == w.eps and g.phases == w.phases


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dense_np_matches_reference(seed):
    """The ported float64 solver: cold, warm and a budget-tripping warm
    seed give the reference's assignment, prices, rounds and phases."""
    rng = np.random.default_rng(seed)
    n, m = 20 + 7 * seed, 6 + seed
    w = rng.uniform(0, 5, (n, m)) * (rng.random((n, m)) > 0.4)
    caps = [int(x) for x in rng.integers(0, 6, m)]
    cold = port_dense_np(w, caps)
    _same_result(cold, ref_dense_np(w, caps))
    assert cold.phases == ref_dense_np(w, caps).phases
    warm_seed = cold.flat_prices * rng.uniform(0.9, 1.1, cold.flat_prices.size)
    _same_result(port_dense_np(w, caps, start_prices=warm_seed),
                 ref_dense_np(w, caps, start_prices=warm_seed))
    high = np.full(cold.flat_prices.size, 40.0)
    got = port_dense_np(w, caps, start_prices=high,
                        max_rounds=cold.rounds + 1)
    want = ref_dense_np(w, caps, start_prices=high,
                        max_rounds=cold.rounds + 1)
    _same_result(got, want)
