"""The port's recurrent families (rwkv6-3b, zamba2-7b) against the JAX
package: models, engines, the parameter carry and the parameter counts.

Both packages build ``get_config(arch).scaled(dtype="float32")``.  The
weights are the JAX model's own init with every leaf redrawn around it by
numpy (`test_torch_ssm.draw_params`: the reference inits its token-shift
mixes and LoRA halves to constants), carried into the port by
`repro_torch.models.carry`; inputs are drawn with numpy.

* Models: prefill logits and caches, decode steps, rwkv's ``extend`` from
  a stored state, the ``init_cache`` structure; zamba's ``extend`` raises
  ``NotImplementedError`` in both packages (the reference's own gap,
  reproduced).  Port vs JAX within 1e-4 of the logits' max (float32, sums
  in another order); the port's decode-vs-parallel and extend-vs-prefill
  within the reference's 2e-3 (``tests/test_models.py``).
* Engines, turn for turn on one plan: identical tokens, ``n_hit``,
  ``n_prompt``, modes, sessions and evictions; last-token logits of every
  stored session within 2e-3 of their max.  rwkv: fresh, an exact
  extension (extend), the repeat of the stored prompt (the no-op decode),
  a prompt that is not an exact extension (fresh again), a DAG fork, and
  LRU evictions at ``cache_slots=1``; zamba: fresh, repeat, non-extension,
  and the exact extension raising in both.  The fork and the no-op leave
  stored states bit-identical.
* Carry: every leaf of both families round-trips exactly, bf16 by its bits.
* ``param_counts`` within 8% of the count of the full-width models the
  port builds, reckoned from shapes on the meta device (nothing allocated).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.serving.engine import AgentEngine as JaxEngine  # noqa: E402
from repro_torch.configs import get_config, param_counts  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.carry import params_from_reference  # noqa: E402
from repro_torch.serving.engine import AgentEngine  # noqa: E402
from test_torch_ssm import draw_params  # noqa: E402

ARCHS = ["rwkv6-3b", "zamba2-7b"]
PORT_TOL = 1e-4
SELF_TOL = 2e-3


def rel_err(port, ref) -> float:
    port = np.asarray(port.detach().float() if isinstance(port, torch.Tensor)
                      else port, np.float32)
    ref = np.asarray(ref, np.float32)
    return float(np.max(np.abs(port - ref))) / (float(np.max(np.abs(ref)))
                                                + 1e-9)


def reference_params(jm, seed: int):
    return draw_params(jax.device_get(jax.jit(jm.init)(
        jax.random.PRNGKey(seed))), np.random.default_rng(seed))


_MODELS = {}


def both(arch):
    """(JAX model, its params, port model, the same params carried)."""
    if arch not in _MODELS:
        jcfg = jax_get_config(arch).scaled(dtype="float32")
        pcfg = get_config(arch).scaled(dtype="float32")
        assert dataclasses.asdict(jcfg) == dataclasses.asdict(pcfg)
        jm = jax_build_model(jcfg)
        jp = reference_params(jm, 0)
        _MODELS[arch] = (jm, jp, build_model(pcfg),
                         params_from_reference(jp))
    return _MODELS[arch]


def tokens(vocab, b, s, seed):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)) \
        .astype(np.int32)


def flat_state(cache, family):
    """The port's per-layer recurrent state in the reference's stacked
    layout: a list of arrays in the order of the reference's leaves."""
    if family == "rwkv":
        return [torch.stack([st[i] for st in cache["states"]]).numpy()
                for i in range(3)]
    groups, tail = cache["mamba"]["groups"], cache["mamba"]["tail"]
    out = [torch.stack([torch.stack([st[i] for st in g]) for g in groups])
           .numpy() for i in range(2)]
    if tail:
        out += [torch.stack([st[i] for st in tail]).numpy()
                for i in range(2)]
    return out + [torch.stack(cache["attn_k"]).numpy(),
                  torch.stack(cache["attn_v"]).numpy()]


def jax_flat_state(cache, family):
    if family == "rwkv":
        return [np.asarray(a) for a in cache["states"]]
    return [np.asarray(a) for a in (*cache["mamba"]["groups"],
                                    *cache["mamba"].get("tail", ()),
                                    cache["attn_k"], cache["attn_v"])]


def assert_caches_match(port, ref, family):
    np.testing.assert_array_equal(port["pos"].numpy(), np.asarray(ref["pos"]))
    if family == "zamba":
        np.testing.assert_array_equal(port["slot_pos"].numpy(),
                                      np.asarray(ref["slot_pos"]))
    for p, r in zip(flat_state(port, family), jax_flat_state(ref, family),
                    strict=True):
        assert p.shape == r.shape
        assert rel_err(p, r) < PORT_TOL


# ---------------- models ----------------

@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_extend_match_jax(arch):
    jm, jp, pm, pp = both(arch)
    vocab = pm.config.vocab_size
    toks = tokens(vocab, 2, 37, 1)
    jl, jc = jax.jit(lambda p, b: jm.prefill(p, {**b, "max_len": 64}))(
        jp, {"tokens": jnp.asarray(toks)})
    pl, pc = pm.prefill(pp, {"tokens": torch.from_numpy(toks),
                             "max_len": 64})
    assert rel_err(pl, jl) < PORT_TOL
    assert_caches_match(pc, jc, pm.family)
    decode = jax.jit(jm.decode_step)
    for i in range(2):
        step = tokens(vocab, 2, 1, 2 + i)[:, 0]
        jl, jc = decode(jp, jc, jnp.asarray(step))
        pl, pc = pm.decode_step(pp, pc, torch.from_numpy(step))
        assert rel_err(pl, jl) < PORT_TOL
    assert_caches_match(pc, jc, pm.family)
    if pm.family == "rwkv":
        ext = tokens(vocab, 2, 19, 4)
        lens = np.full((2,), 19, np.int32)
        jl, jc = jax.jit(jm.extend)(jp, jc, jnp.asarray(ext),
                                    jnp.asarray(lens))
        pl, pc = pm.extend(pp, pc, torch.from_numpy(ext),
                           torch.from_numpy(lens))
        assert rel_err(pl, jl) < PORT_TOL
        assert_caches_match(pc, jc, pm.family)


@pytest.mark.parametrize("arch", ARCHS)
def test_port_decode_matches_parallel(arch):
    _, _, pm, pp = both(arch)
    b, s = 2, 21
    full = torch.from_numpy(tokens(pm.config.vocab_size, b, s + 1, 5))
    _, cache = pm.prefill(pp, {"tokens": full[:, :s], "max_len": s + 4})
    got, _ = pm.decode_step(pp, cache, full[:, s])
    want, _ = pm.prefill(pp, {"tokens": full, "max_len": s + 4})
    assert rel_err(got, want.numpy()) < SELF_TOL


def test_port_rwkv_extend_matches_prefill():
    _, _, pm, pp = both("rwkv6-3b")
    b, s, s0 = 2, 37, 16
    full = torch.from_numpy(tokens(pm.config.vocab_size, b, s, 6))
    want, wcache = pm.prefill(pp, {"tokens": full})
    _, cache = pm.prefill(pp, {"tokens": full[:, :s0]})
    got, gcache = pm.extend(pp, cache, full[:, s0:],
                            torch.full((b,), s - s0, dtype=torch.int32))
    assert rel_err(got, want.numpy()) < SELF_TOL
    assert torch.equal(gcache["pos"], wcache["pos"])


def test_zamba_extend_raises_in_both_packages():
    jm, jp, pm, pp = both("zamba2-7b")
    toks = tokens(pm.config.vocab_size, 1, 8, 7)
    _, jc = jax.jit(lambda p, b: jm.prefill(p, {**b, "max_len": 16}))(
        jp, {"tokens": jnp.asarray(toks)})
    _, pc = pm.prefill(pp, {"tokens": torch.from_numpy(toks), "max_len": 16})
    lens = np.array([4], np.int32)
    with pytest.raises(NotImplementedError, match="zamba2 extend"):
        jm.extend(jp, jc, jnp.asarray(toks[:, :4]), jnp.asarray(lens))
    with pytest.raises(NotImplementedError, match="zamba2 extend"):
        pm.extend(pp, pc, torch.from_numpy(toks[:, :4]),
                  torch.from_numpy(lens))


@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_matches_jax(arch):
    jm, _, pm, _ = both(arch)
    jc = jm.init_cache(2, 40)
    pc = pm.init_cache(2, 40, "cpu")
    assert_caches_match(pc, jc, pm.family)
    dtypes = {str(a.dtype) for a in flat_state(pc, pm.family)}
    assert dtypes == {str(a.dtype) for a in jax_flat_state(jc, pm.family)}


# ---------------- carry and parameter counts ----------------

def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


def _port_leaf(pp, path, index):
    """The port's tensor for a reference leaf at ``path`` and stacked
    ``index`` (the leading group/layer indices the carry split off)."""
    node = pp
    keys = path.strip("/").split("/")
    top = keys[0]
    it = iter(index)
    node = node[top]
    if top in ("layers", "tail") or top.startswith("stack"):
        node = node[next(it)]
    elif top == "groups":
        node = node[next(it)][next(it)]
    rest = keys[1:]
    if top == "shared" and rest[0] == "lora":
        node = node["lora"][next(it)]
        rest = rest[1:]
    for k in rest:
        node = node[k]
    return node


@pytest.mark.parametrize("arch", ARCHS)
def test_carry_round_trips_every_leaf_exactly(arch):
    """bf16 weights (the configs' own dtype) and float32 A_log / dt_bias:
    every value and dtype of the reference pytree comes back unchanged."""
    cfg = jax_get_config(arch).scaled()
    jm = jax_build_model(cfg)
    ref = reference_params(jm, 3)
    ref = jax.tree.map(lambda a, like: np.asarray(a).astype(like.dtype),
                       ref, jax.eval_shape(jm.init, jax.random.PRNGKey(0)))
    pp = params_from_reference(ref)
    n = 0
    for path, leaf in _leaves(ref):
        leaf = np.asarray(leaf)
        depth = 2 if path.startswith("/groups") else (
            1 if path.startswith(("/layers", "/tail", "/shared/lora")) else 0)
        for index in np.ndindex(*leaf.shape[:depth]):
            got = _port_leaf(pp, path, index)
            want = leaf[index]
            assert str(got.dtype).removeprefix("torch.") == want.dtype.name
            if want.dtype.name == "bfloat16":
                assert np.array_equal(got.view(torch.int16).numpy(),
                                      want.view(np.int16))
            else:
                assert np.array_equal(got.numpy(), want)
            n += 1
    assert n == sum(1 for _ in pp.parameters())
    if arch == "zamba2-7b":
        assert pp["groups"][0][0]["mix"]["A_log"].dtype == torch.float32


class _MetaGenerator(torch.Generator):
    """A CPU generator that reports the meta device, so that an init draws
    nothing and allocates nothing: every tensor is a shape only."""

    @property
    def device(self):
        return torch.device("meta")


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_match_the_built_models(arch):
    cfg = get_config(arch)
    params = build_model(cfg).init(_MetaGenerator())
    built = sum(p.numel() for p in params.parameters())
    counted = param_counts(cfg)["total"]
    assert abs(counted - built) / built < 0.08, (counted, built)
    assert built > (3e9 if arch == "rwkv6-3b" else 6.5e9)


# ---------------- engines ----------------

def session_logits(engine, did, decode):
    sess = engine.sessions[did]
    tok = np.array([int(sess.prompt[-1])], np.int32)
    if isinstance(engine, JaxEngine):
        logits, _ = decode(engine.params, sess.cache, jnp.asarray(tok))
        return np.asarray(logits)
    with torch.no_grad():
        logits, _ = engine.model.decode_step(engine.params, sess.cache,
                                             torch.from_numpy(tok))
    return logits


def snapshot(cache):
    return [torch.clone(t) for t in jax.tree.leaves(
        cache, is_leaf=lambda x: isinstance(x, torch.Tensor))]


def unchanged(cache, snap) -> bool:
    leaves = jax.tree.leaves(cache,
                             is_leaf=lambda x: isinstance(x, torch.Tensor))
    return len(leaves) == len(snap) and all(
        torch.equal(a, b) for a, b in zip(leaves, snap))


def run_plan(arch, cache_slots, plan):
    """Serve ``plan`` through a JAX engine and a port engine on the same
    weights.  Each step is (dialogue, how to build the prompt from the
    dialogue's stored prompt, parents).  Returns the per-step results,
    the engines and the cache-safety observations."""
    jcfg = jax_get_config(arch).scaled(dtype="float32")
    kw = {"max_len": 96, "max_new_tokens": 3, "cache_slots": cache_slots}
    jeng = JaxEngine(jcfg, seed=1, **kw)
    jeng.params = jax.tree.map(jnp.asarray, reference_params(
        jeng.model, 1))
    peng = AgentEngine(get_config(arch).scaled(dtype="float32"),
                       device="cpu", params=params_from_reference(
                           jax.device_get(jeng.params)), **kw)
    decode = jax.jit(jeng.model.decode_step)
    rng = np.random.default_rng(2)
    new = lambda n: rng.integers(1, 255, n).astype(np.int32)  # noqa: E731
    out, safety, stored = [], {}, {}
    for i, (did, how, parents) in enumerate(plan):
        src = stored.get(parents[0] if parents else did)
        prompt = how(src, new)
        watched = parents[0] if parents else did
        before = peng.sessions.get(watched)
        snap = snapshot(before.cache) if before is not None else None
        res = []
        for eng in (jeng, peng):
            try:
                res.append(eng.serve(did, prompt, now=float(i),
                                     parents=parents))
            except NotImplementedError as e:
                res.append(e)
        out.append((did, prompt, res))
        if isinstance(res[1], NotImplementedError):
            continue
        if snap is not None:
            safety[i] = unchanged(before.cache, snap)
        stored[did] = peng.sessions[did].prompt
        err = rel_err(session_logits(peng, did, decode),
                      session_logits(jeng, did, decode))
        assert err < SELF_TOL, (i, err)
    return out, jeng, peng, safety


def assert_lockstep(out, jeng, peng):
    for did, prompt, (j, p) in out:
        if isinstance(j, Exception) or isinstance(p, Exception):
            continue
        np.testing.assert_array_equal(p.output_tokens, j.output_tokens)
        assert (p.n_hit, p.n_prompt, p.n_gen) == (j.n_hit, j.n_prompt,
                                                  j.n_gen), did
    assert peng.evictions == jeng.evictions
    assert sorted(peng.sessions) == sorted(jeng.sessions)
    for did, sess in peng.sessions.items():
        np.testing.assert_array_equal(sess.prompt, jeng.sessions[did].prompt)


FRESH = lambda src, new: new(20)                                  # noqa: E731
EXTEND = lambda src, new: np.concatenate([src, new(6)])          # noqa: E731
REPEAT = lambda src, new: src                                     # noqa: E731
OTHER = lambda src, new: np.concatenate([src[:15], new(4)])      # noqa: E731


@pytest.fixture(scope="module")
def rwkv_lockstep():
    plan = [("dlg", FRESH, ()), ("dlg", EXTEND, ()), ("dlg", REPEAT, ()),
            ("dlg", OTHER, ()), ("dlg/child", EXTEND, ("dlg",)),
            ("other", FRESH, ()), ("dlg", EXTEND, ())]
    return run_plan("rwkv6-3b", 1, plan)


def test_rwkv_engine_matches_jax_turn_for_turn(rwkv_lockstep):
    out, jeng, peng, _ = rwkv_lockstep
    assert peng.recurrent and jeng.recurrent
    assert_lockstep(out, jeng, peng)
    hits = [(r[1].n_hit, r[1].n_prompt) for _, _, r in out]
    assert hits[0][0] == 0                         # fresh
    assert 0 < hits[1][0] < hits[1][1]             # exact extension
    assert hits[2][0] == hits[2][1]                # repeat: the no-op
    assert hits[3][0] == 0                         # not an extension: fresh
    assert 0 < hits[4][0] < hits[4][1]             # fork from the parent
    assert hits[6][0] == 0                         # evicted (cache_slots=1)
    assert peng.evictions == 3


def test_rwkv_fork_and_noop_leave_stored_states_bit_identical(rwkv_lockstep):
    _, _, _, safety = rwkv_lockstep
    assert safety[2] and safety[4]                 # the no-op; the fork


@pytest.fixture(scope="module")
def zamba_lockstep():
    plan = [("dlg", FRESH, ()), ("dlg", REPEAT, ()), ("dlg", OTHER, ()),
            ("dlg", REPEAT, ()), ("dlg", EXTEND, ())]
    return run_plan("zamba2-7b", 2, plan)


def test_zamba_engine_matches_jax_turn_for_turn(zamba_lockstep):
    out, jeng, peng, safety = zamba_lockstep
    assert_lockstep(out, jeng, peng)
    hits = [(r[1].n_hit, r[1].n_prompt) for _, _, r in out[:4]]
    assert [h == 0 for h, _ in hits] == [True, False, True, False]
    assert all(h == n for h, n in hits[1::2])      # the no-op repeats
    assert safety[1] and safety[3]


def test_zamba_engine_exact_extension_raises_in_both(zamba_lockstep):
    """The reference's engine sends an exact extension to ``extend``,
    which its zamba model does not implement; the port does the same."""
    out, _, _, _ = zamba_lockstep
    _, _, (j, p) = out[-1]
    assert isinstance(j, NotImplementedError)
    assert isinstance(p, NotImplementedError)
