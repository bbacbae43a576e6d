"""The port's staged column auction (``cuda`` and ``dense-torch`` backends on
the CPU) against the reference's jit-staged ``solve_dense_auction_jax``:
identical assignments, unit indices and round counts, a bit-identical
float32 price grid, identical Clarke payments, and welfare within the
``2·n·ε`` certificate of the float64 ``dense`` solver.  Cold, warm, and a
warm seed bad enough to trip the warm round budget."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.solvers.dense_common import jax_eps_final  # noqa: E402
from repro.core.solvers.dense_jax import (DenseJaxBackend,  # noqa: E402
                                          _get_jax_solver,
                                          solve_dense_auction_jax)
from repro.core.solvers.dense_np import DenseNumpyBackend  # noqa: E402
from repro_torch.core.solvers import get_solver  # noqa: E402
from repro_torch.core.solvers.cuda_backend import \
    solve_dense_auction_cuda  # noqa: E402
from repro_torch.core.solvers.dense_torch import (  # noqa: E402
    _StagedMarket, solve_dense_auction_torch)

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
