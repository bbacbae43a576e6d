"""The port's `AgentEngine` against the JAX `AgentEngine`, turn for turn.

Both engines serve the ``llama3-7b`` engine class (`serving/cluster.py`)
on the same weights: the JAX engine's own parameters, carried into the
port (`repro_torch.models.carry`).  One seeded script runs through both:
a three-turn dialogue (fresh, extend, extend), an identical repeat, a
prompt that is a strict prefix of the cached one, a DAG child forked from
its parent's session (``parents=``), and fresh dialogues that push the LRU
over ``cache_slots``.  Tokens, ``n_hit``, ``n_prompt``, ``n_gen``, the
stored sessions and ``evictions`` must be equal; the fork and the no-op
decode must leave the stored caches bit-identical.
"""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.serving.cluster import \
    _engine_config as jax_engine_config  # noqa: E402
from repro.serving.engine import AgentEngine as JaxEngine  # noqa: E402
from repro_torch.models.carry import params_from_reference  # noqa: E402
from repro_torch.serving import engine as engine_mod  # noqa: E402
from repro_torch.serving.cluster import _engine_config  # noqa: E402
from repro_torch.serving.engine import AgentEngine, _bucket  # noqa: E402

KW = {"max_len": 128, "max_new_tokens": 3, "cache_slots": 3}


def snapshot(cache) -> dict:
    return {"pos": cache["pos"].clone(), "slot_pos": cache["slot_pos"].clone(),
            "k": [t.clone() for t in cache["stack0"]["k"]],
            "v": [t.clone() for t in cache["stack0"]["v"]]}


def unchanged(cache, snap) -> bool:
    return (torch.equal(cache["pos"], snap["pos"])
            and torch.equal(cache["slot_pos"], snap["slot_pos"])
            and all(torch.equal(a, b) for key in ("k", "v")
                    for a, b in zip(cache["stack0"][key], snap[key])))


@pytest.fixture(scope="module")
def lockstep():
    """Run the script through both engines; returns the per-request
    results of each, the engines, and the cache-safety observations."""
    jeng = JaxEngine(jax_engine_config("llama3-7b", 255), seed=3, **KW)
    peng = AgentEngine(_engine_config("llama3-7b", 255), device="cpu",
                       params=params_from_reference(
                           jax.device_get(jeng.params)), **KW)
    rng = np.random.default_rng(0)
    turn = lambda n: rng.integers(1, 255, n).astype(np.int32)  # noqa: E731
    results = {"jax": [], "port": []}
    safety = {}
    clock = iter(range(100))

    def serve(did, prompt, parents=()):
        now = float(next(clock))
        for tag, eng in (("jax", jeng), ("port", peng)):
            r = eng.serve(did, prompt, now=now, parents=parents)
            results[tag].append((did, r))
        return results["port"][-1][1]

    p = turn(20)
    r = serve("dlg", p)                                   # fresh
    p = np.concatenate([p, r.output_tokens, turn(6)])
    r = serve("dlg", p)                                   # extend
    p = np.concatenate([p, r.output_tokens, turn(5)])
    r = serve("dlg", p)                                   # extend again
    full = peng.sessions["dlg"].prompt

    before = peng.sessions["dlg"].cache
    snap = snapshot(before)
    serve("dlg", full)                                    # identical: no-op
    safety["noop_left_cache"] = unchanged(before, snap)

    before = peng.sessions["dlg"].cache
    snap = snapshot(before)
    serve("dlg-short", full[:25], parents=("dlg",))      # prefix of cache
    safety["prefix_left_parent"] = unchanged(before, snap)

    child = np.concatenate([peng.sessions["dlg"].prompt, turn(7)])
    before = peng.sessions["dlg"].cache
    snap = snapshot(before)
    serve("dlg/child", child, parents=("dlg",))           # DAG fork
    safety["fork_left_parent"] = unchanged(before, snap)
    safety["parent_kept"] = "dlg" in peng.sessions

    for i in range(3):                                    # push the LRU
        serve(f"other-{i}", turn(30 + 10 * i))
    last = peng.sessions["dlg"].prompt if "dlg" in peng.sessions else full
    serve("dlg", np.concatenate([last, turn(4)]))
    return {"results": results, "jax": jeng, "port": peng,
            "safety": safety}


def test_engine_configs_match_reference():
    for cls in ("llama3-7b", "qwen-8b", "qwen-4b"):
        assert jax_engine_config(cls, 255).__dict__ == \
            _engine_config(cls, 255).__dict__


def test_tokens_and_cache_accounting_match_jax(lockstep):
    jres, pres = lockstep["results"]["jax"], lockstep["results"]["port"]
    assert len(jres) == len(pres) == 10
    for (jd, j), (pd, p) in zip(jres, pres):
        assert jd == pd
        np.testing.assert_array_equal(p.output_tokens, j.output_tokens)
        assert (p.n_hit, p.n_prompt, p.n_gen) == (j.n_hit, j.n_prompt,
                                                  j.n_gen), jd
    hits = [p.n_hit for _, p in pres]
    assert hits[0] == 0 and hits[1] > 0 and hits[2] > 0   # fresh, extends
    assert hits[3] == pres[3][1].n_prompt                 # identical
    assert hits[5] > 0                                    # the fork hit


def test_sessions_and_evictions_match_jax(lockstep):
    jeng, peng = lockstep["jax"], lockstep["port"]
    assert peng.evictions == jeng.evictions > 0
    assert sorted(peng.sessions) == sorted(jeng.sessions)
    for did, sess in peng.sessions.items():
        np.testing.assert_array_equal(sess.prompt, jeng.sessions[did].prompt)
        assert sess.last_used == jeng.sessions[did].last_used


def test_stored_caches_match_jax(lockstep):
    """The K/V the two engines keep for each live session agree (float32,
    within 1e-4 of their max); slot positions and lengths are equal."""
    jeng, peng = lockstep["jax"], lockstep["port"]
    for did, sess in peng.sessions.items():
        jc = jeng.sessions[did].cache
        np.testing.assert_array_equal(sess.cache["pos"].numpy(),
                                      np.asarray(jc["pos"]))
        np.testing.assert_array_equal(sess.cache["slot_pos"].numpy(),
                                      np.asarray(jc["slot_pos"]))
        for key in ("k", "v"):
            ref = np.asarray(jc["stack0"][key])
            got = torch.stack(sess.cache["stack0"][key]).numpy()
            assert np.max(np.abs(got - ref)) <= 1e-4 * np.max(np.abs(ref))


@pytest.mark.parametrize("what", ["noop_left_cache", "prefix_left_parent",
                                  "fork_left_parent", "parent_kept"])
def test_fork_and_noop_leave_stored_caches_bit_identical(lockstep, what):
    assert lockstep["safety"][what]


def test_engine_defaults_to_the_card():
    """The entry point runs on the card unless the caller asks for the CPU;
    without a card it raises instead of moving to the CPU."""
    import inspect

    sig = inspect.signature(AgentEngine.__init__)
    assert sig.parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            AgentEngine(_engine_config("qwen-4b", 255))


def test_buckets_and_serve_result_follow_the_reference():
    """Prompt buckets equal the reference's; `ServeResult` lives in the
    engine module, and the analytic engine returns that same class."""
    from repro.serving.engine import _bucket as jax_bucket
    from repro_torch.serving import analytic

    for n in (1, 15, 16, 17, 300, 1024):
        assert _bucket(n) == jax_bucket(n)
    assert analytic.ServeResult is engine_mod.ServeResult
    res = analytic.AnalyticEngine("qwen-4b").serve("d", np.arange(1, 30))
    assert isinstance(res, engine_mod.ServeResult)
