"""Phase 1 of the port against the reference on the CPU: the prefix-ledger
arena and the batched LCP affinity (exact), the stacked-Hoeffding
``predict_matrix`` (bit-equal), and the workload generator and analytic
engine that feed the closed loops (identical)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.affinity import PrefixLedger as JaxLedger  # noqa: E402
from repro.core.predictor import PredictorInput as JaxInput  # noqa: E402
from repro.core.predictor import PredictorPool as JaxPool  # noqa: E402
from repro.core.pricing import TokenPrices as JaxPrices  # noqa: E402
from repro.serving.analytic import AnalyticEngine as JaxEngine  # noqa: E402
from repro.serving import workload as jax_workload  # noqa: E402
from repro_torch.core.affinity import PrefixLedger  # noqa: E402
from repro_torch.core.predictor import (PredictorInput,  # noqa: E402
                                        PredictorPool)
from repro_torch.core.pricing import TokenPrices  # noqa: E402
from repro_torch.serving import workload  # noqa: E402
from repro_torch.serving.analytic import AnalyticEngine  # noqa: E402

AGENTS = [f"a{i}" for i in range(5)]


def _assert_same_store(a, b):
    assert np.array_equal(a.store.tokens, b.store.tokens)
    assert np.array_equal(a.store.lens, b.store.lens)
    assert a.store.row_of == b.store.row_of
    assert a.store._free == b.store._free
    assert a.store._next == b.store._next
    assert a._by_agent == b._by_agent


@pytest.mark.parametrize("seed", [0, 1])
def test_ledger_arena_and_kernel_affinity_match_reference(seed):
    """The same seeded update/evict stream through both ledgers (LRU cap
    on): identical arenas and session order, and ``affinity_matrix`` with
    the kernel path equal to the reference's interpret-mode Pallas path and
    to the per-pair loop, with and without extension-only agents."""
    rng = np.random.default_rng(seed)
    ref, port = JaxLedger(max_sessions_per_agent=3), \
        PrefixLedger(max_sessions_per_agent=3)
    base = {f"d{k}": rng.integers(1, 9, 30).astype(np.int32)
            for k in range(6)}
    for step in range(40):
        a = AGENTS[int(rng.integers(len(AGENTS)))]
        d = f"d{int(rng.integers(6))}"
        if rng.random() < 0.15:
            ref.evict(a, d)
            port.evict(a, d)
            continue
        toks = base[d][: int(rng.integers(1, 31))]
        ref.update(a, d, toks)
        port.update(a, d, toks)
    _assert_same_store(ref, port)
    for a in AGENTS:
        assert ref.recent_sessions(a, 2) == port.recent_sessions(a, 2)
    sess = [f"d{k}" for k in range(6)]
    prompts = [np.concatenate([base[d][: int(rng.integers(0, 30))],
                               rng.integers(1, 9, 3).astype(np.int32)])
               for d in sess]
    prompts[0] = prompts[0][:0]                 # an empty prompt
    for ext in (None, [True, False, False, True, False]):
        want = ref.affinity_matrix(prompts, sess, AGENTS,
                                   extension_only_mask=ext, use_kernel=True)
        got = port.affinity_matrix(prompts, sess, AGENTS,
                                   extension_only_mask=ext, use_kernel=True,
                                   device="cpu")
        loop = port.affinity_matrix(prompts, sess, AGENTS,
                                    extension_only_mask=ext)
        assert got.dtype == np.float64
        assert np.array_equal(got, want)
        assert np.array_equal(got, loop)
    slots = [2, 0, 1, 3, 0]
    assert np.array_equal(ref.keep_mask(sess, AGENTS, slots),
                          port.keep_mask(sess, AGENTS, slots))


def _pools(seed: int, n_obs: int):
    """Two pools (reference, port) taught the same seeded observations —
    enough of them that the trees split."""
    rng = np.random.default_rng(seed)
    prices = {a: (0.01 * (1 + i), 0.001 * (1 + i), 0.03)
              for i, a in enumerate(AGENTS)}
    ref = JaxPool({a: JaxPrices(*p) for a, p in prices.items()})
    port = PredictorPool({a: TokenPrices(*p) for a, p in prices.items()})
    for _ in range(n_obs):
        a = AGENTS[int(rng.integers(len(AGENTS)))]
        x = rng.uniform(0, 1, 10) * np.array([400, 10, 1, 8, 4, 8, 4, 12, 1,
                                              1])
        # targets that depend on the features, so the trees split
        y = (0.02 + 1e-3 * x[0] * (1.0 - x[2]) + 0.01 * float(rng.random()),
             0.01 * x[0] + 0.1 * float(rng.random()),
             float(x[9] > 0.5))
        ref[a].update(JaxInput(*x), *y)
        port[a].update(PredictorInput(*x), *y)
    ref[AGENTS[0]].note_residual(0.3)
    port[AGENTS[0]].note_residual(0.3)
    return ref, port, rng


@pytest.mark.parametrize("seed,n_obs", [(0, 30), (1, 400), (2, 900)])
def test_predict_matrix_matches_reference(seed, n_obs):
    ref, port, rng = _pools(seed, n_obs)
    X = rng.uniform(0, 1, (7, len(AGENTS), 10)) * 300.0
    got = port.predict_matrix(AGENTS, X)
    want = ref.predict_matrix(AGENTS, X, backend="numpy")
    for g, w in zip(got, want):
        assert np.max(np.abs(g - w)) <= 1e-12
        assert np.array_equal(g, w)         # bit-equality is expected
    # the larger streams grow real trees (the quality target splits)
    assert any(port[a].quality.root.feature >= 0 for a in AGENTS) == \
        (n_obs >= 400)
    # ... and the batched path equals the port's own scalar predictor
    for j, i in ((0, 0), (3, 2), (6, 4)):
        est = port[AGENTS[i]].predict(PredictorInput(*X[j, i]))
        assert (est.latency, est.cost, est.quality) == \
            (got[0][j, i], got[1][j, i], got[2][j, i])


def test_workload_streams_identical():
    for name in ("coqa_like", "quac_like", "hotpot_like", "dag_handoff"):
        spec = dict(name=name, n_dialogues=6, seed=3)
        got = workload.generate(workload.WorkloadSpec(**spec))
        want = jax_workload.generate(jax_workload.WorkloadSpec(**spec))
        for g, w in zip(got, want):
            assert (g.dialogue_id, g.domain, g.difficulty) == \
                (w.dialogue_id, w.domain, w.difficulty)
            if name == "dag_handoff":
                assert [(s.parents, s.domain) for s in g.steps] == \
                    [(s.parents, s.domain) for s in w.steps]
                assert all(np.array_equal(a.tokens, b.tokens)
                           for a, b in zip(g.steps, w.steps))
            else:
                assert all(np.array_equal(a, b)
                           for a, b in zip(g.turns, w.turns))


def test_analytic_engine_identical():
    rng = np.random.default_rng(4)
    ref = JaxEngine("qwen-8b", seed=11, speed=1.25, cache_slots=2)
    port = AnalyticEngine("qwen-8b", seed=11, speed=1.25, cache_slots=2)
    history = {}
    for t in range(12):
        did = f"d{int(rng.integers(3))}"
        prompt = np.concatenate([history.get(did, np.zeros(0, np.int32)),
                                 rng.integers(1, 200, 9).astype(np.int32)])
        a = ref.serve(did, prompt, now=float(t))
        b = port.serve(did, prompt, now=float(t))
        assert np.array_equal(a.output_tokens, b.output_tokens)
        assert (a.ttft, a.total_time, a.n_prompt, a.n_hit, a.n_gen) == \
            (b.ttft, b.total_time, b.n_prompt, b.n_hit, b.n_gen)
        history[did] = np.concatenate([prompt, b.output_tokens])
    assert ref.evictions == port.evictions > 0
