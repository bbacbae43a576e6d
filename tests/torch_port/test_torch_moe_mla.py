"""The port's MoE FFN, MLA attention and the two MoE models against the JAX
package on the same weights and inputs.

The reduced configs (``cfg.scaled(dtype="float32")``) of
``deepseek-v2-lite-16b`` (MLA attention, one dense layer and one MoE layer
with a shared expert) and ``mixtral-8x22b`` (sliding-window GQA, MoE
layers) are built by both packages.  Parameters and inputs are drawn with
numpy from seeds (or, for the engines, the JAX engine's own parameters);
the JAX side gets them as they are, the port through
`repro_torch.models.carry` or `tensor_from_numpy`.  Checked:

* ``moe_ffn`` in both dispatch modes at the default ``capacity_factor``
  (1.25: tokens are dropped) and at no drop, and a router with tied
  probabilities (ties break to the lower expert, as ``jax.lax.top_k``);
* MLA parallel (right-padded prompts), absorbed and naive decode, and
  extend, and the reference's absorbed-vs-naive contract on the model;
* whole-model prefill / decode / extend, mixtral with its window replaced
  by 8 on both sides so that the ring wraps;
* the `AgentEngine` against the JAX engine, turn for turn;
* the reference's MLA stale-latent fault (`mla_extend` adds new latents
  into slots it never clears; ROADMAP §3): after a truncate → extend →
  decode the logits differ from a fresh prefill's by more than 0.1, in
  both packages alike.

Tolerances (float32): 1e-5 of the reference's largest magnitude, unless a
test states another; the self-consistency contract keeps the reference's
2e-3.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import attention as jax_attn  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import moe as jax_moe  # noqa: E402
from repro.serving.engine import AgentEngine as JaxEngine  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import build_model, moe  # noqa: E402
from repro_torch.models.carry import (params_from_reference,  # noqa: E402
                                      tensor_from_numpy)
from repro_torch.serving.engine import AgentEngine  # noqa: E402

TOL = 1e-5
SELF_TOL = 2e-3
DEEPSEEK = "deepseek-v2-lite-16b"
MIXTRAL = "mixtral-8x22b"


def reduced(name, **over):
    """The same reduced config from both packages."""
    jcfg = jax_get_config(name).scaled(dtype="float32", **over)
    pcfg = get_config(name).scaled(dtype="float32", **over)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(pcfg)
    return jcfg, pcfg


def rel_err(port, ref) -> float:
    ref = np.asarray(ref, np.float32)
    port = port.numpy() if isinstance(port, torch.Tensor) else port
    return float(np.max(np.abs(port - ref))) / (float(np.max(np.abs(ref)))
                                                + 1e-9)


def draw(shapes, seed: int, stacked: bool = False):
    """A numpy draw of a pytree of shapes: norm weights 1 + noise, the rest
    normal with std 1/sqrt(fan-in) (an expert weight [E, in, out] by its
    middle dim, ``wo`` [H, vd, D] by H·vd), biases nonzero.  ``stacked``:
    each leaf has a leading layer dim."""
    rng = np.random.default_rng(seed)

    def one(path, leaf):
        name = jax.tree_util.keystr(path)
        shape = leaf.shape[1:] if stacked and "stack" in name else leaf.shape
        if "norm" in name or "['ln" in name:
            a = 1.0 + 0.1 * rng.standard_normal(leaf.shape)
        elif name.endswith(("['bq']", "['bk']", "['bv']")):
            a = 0.1 * rng.standard_normal(leaf.shape)
        else:
            if name.endswith("['wo']"):
                fan_in = shape[0] * shape[1]
            elif "['moe']" in name and "shared" not in name \
                    and "router" not in name:
                fan_in = shape[1]
            else:
                fan_in = shape[0]
            a = rng.standard_normal(leaf.shape) / np.sqrt(fan_in)
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(one, shapes)


def to_port(tree):
    if isinstance(tree, dict):
        return {k: to_port(v) for k, v in tree.items()}
    return tensor_from_numpy(tree)


def normal(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)) \
        .astype(np.float32)


# ---------------------------------------------------------------- MoE --
def moe_params(jcfg, seed):
    shapes = jax.eval_shape(lambda k: jax_moe.moe_init(k, jcfg, jnp.float32),
                            jax.random.PRNGKey(0))
    return draw({"moe": shapes}, seed)["moe"]


@pytest.mark.parametrize("mode", ["sort", "onehot"])
@pytest.mark.parametrize("drops", [True, False], ids=["cf1.25", "nodrop"])
@pytest.mark.parametrize("name", [DEEPSEEK, MIXTRAL])
def test_moe_ffn_matches_jax(name, drops, mode):
    over = {} if drops else {"capacity_factor": 4.0}
    jcfg, pcfg = reduced(name, **over)
    jp = moe_params(jcfg, 1)
    jp["router"][:, 0] += 0.1        # a popular expert: its bucket fills
    x = normal((2, 24, jcfg.d_model), 2) + 0.5
    ref = jax_moe.moe_ffn(jp, jnp.asarray(x), jcfg, mode=mode)
    got = moe.moe_ffn(to_port(jp), torch.from_numpy(x), pcfg, mode=mode)
    assert got.shape == ref.shape
    assert rel_err(got, ref) < TOL
    # the capacity really binds at 1.25 and never at 4.0 (E = 4 experts)
    _, idx = jax_moe._route(jp, jnp.asarray(x), jcfg)
    cap = moe._capacity(24, jcfg.top_k, jcfg.n_experts,
                        jcfg.capacity_factor)
    per_expert = np.stack([np.bincount(r.ravel(), minlength=jcfg.n_experts)
                           for r in np.asarray(idx)])
    assert (per_expert.max() > cap) == drops


def test_route_ties_break_to_lower_expert():
    """A router whose columns repeat gives tied probabilities; top-k must
    keep the lower expert of each tie, as ``jax.lax.top_k`` does."""
    jcfg, pcfg = reduced(DEEPSEEK)
    jp = moe_params(jcfg, 3)
    r = jp["router"]
    r[:, 3] = r[:, 1]            # experts 1 and 3 always tie
    r[:, 2] = r[:, 0]            # and 0 with 2
    x = normal((2, 16, jcfg.d_model), 4)
    jg, ji = jax_moe._route(jp, jnp.asarray(x), jcfg)
    pg, pi = moe._route(to_port(jp), torch.from_numpy(x), pcfg)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    pairs = {tuple(t) for t in np.asarray(ji).reshape(-1, 2)}
    assert pairs <= {(0, 2), (1, 3)} and len(pairs) == 2   # lower first
    np.testing.assert_allclose(pg.numpy(), np.asarray(jg), atol=1e-6)
    zero = dict(jp, router=np.zeros_like(r))   # all experts tie
    _, ji = jax_moe._route(zero, jnp.asarray(x), jcfg)
    _, pi = moe._route(to_port(zero), torch.from_numpy(x), pcfg)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    assert (pi.numpy() == np.arange(jcfg.top_k)).all()
    for mode in ("sort", "onehot"):
        ref = jax_moe.moe_ffn(jp, jnp.asarray(x), jcfg, mode=mode)
        got = moe.moe_ffn(to_port(jp), torch.from_numpy(x), pcfg, mode=mode)
        assert rel_err(got, ref) < TOL


# ---------------------------------------------------------------- MLA --
@pytest.fixture(scope="module")
def mla():
    jcfg, pcfg = reduced(DEEPSEEK)
    shapes = jax.eval_shape(lambda k: jax_attn.mla_init(k, jcfg,
                                                        jnp.float32),
                            jax.random.PRNGKey(0))
    jp = draw({"attn": shapes}, 5)["attn"]
    return jcfg, pcfg, jp, to_port(jp)


def latent_cache(cfg, b, m, seed, pos):
    """A random latent cache whose slots at or past ``pos`` are empty."""
    sp = np.where(np.arange(m)[None, :] < pos[:, None], np.arange(m)[None],
                  -1).astype(np.int32)
    return {"ckv": normal((b, m, cfg.kv_lora_rank), seed),
            "krope": normal((b, m, cfg.qk_rope_dim), seed + 1),
            "slot_pos": sp, "pos": pos.astype(np.int32)}


def both_caches(c):
    return ({k: jnp.asarray(v) for k, v in c.items()},
            {k: torch.from_numpy(v) for k, v in c.items()})


def assert_latents_match(port, ref):
    np.testing.assert_array_equal(port["slot_pos"].numpy(),
                                  np.asarray(ref["slot_pos"]))
    np.testing.assert_array_equal(port["pos"].numpy(), np.asarray(ref["pos"]))
    for key in ("ckv", "krope"):
        assert rel_err(port[key], ref[key]) < TOL, key


def test_mla_parallel_matches_jax(mla):
    jcfg, pcfg, jp, pp = mla
    x = normal((2, 20, jcfg.d_model), 6)
    lens = np.array([20, 13], np.int32)
    jo, (jc, jk) = jax.jit(lambda p, x, n: jax_attn.mla_parallel(
        p, x, jcfg, lens=n))(jp, jnp.asarray(x), jnp.asarray(lens))
    po, (pc, pk) = attn.mla_parallel(pp, torch.from_numpy(x), pcfg,
                                     lens=torch.from_numpy(lens))
    assert rel_err(po, jo) < TOL        # padded rows too: both mask keys
    assert rel_err(pc, jc) < TOL and rel_err(pk, jk) < TOL


@pytest.mark.parametrize("absorbed", [True, False],
                         ids=["absorbed", "naive"])
def test_mla_decode_matches_jax(mla, absorbed):
    jcfg, pcfg, jp, pp = mla
    jc, pc = both_caches(latent_cache(jcfg, 2, 24, 7, np.array([9, 23])))
    x = normal((2, jcfg.d_model), 8)
    jo, jn = jax.jit(lambda p, x, c: jax_attn.mla_decode(
        p, x, c, jcfg, absorbed=absorbed))(jp, jnp.asarray(x), jc)
    before = {k: v.clone() for k, v in pc.items()}
    po, pn = attn.mla_decode(pp, torch.from_numpy(x), pc, pcfg,
                             absorbed=absorbed)
    assert rel_err(po, jo) < TOL
    assert_latents_match(pn, jn)
    assert all(torch.equal(pc[k], before[k]) for k in pc)   # functional


def test_mla_extend_matches_jax(mla):
    jcfg, pcfg, jp, pp = mla
    jc, pc = both_caches(latent_cache(jcfg, 2, 24, 9, np.array([6, 11])))
    x = normal((2, 8, jcfg.d_model), 10)
    lens_new = np.array([8, 5], np.int32)
    jo, jn = jax.jit(lambda p, x, c, n: jax_attn.mla_extend(
        p, x, c, jcfg, n))(jp, jnp.asarray(x), jc, jnp.asarray(lens_new))
    po, pn = attn.mla_extend(pp, torch.from_numpy(x), pc, pcfg,
                             torch.from_numpy(lens_new))
    assert rel_err(po, jo) < TOL
    assert_latents_match(pn, jn)
    # the reference's add without clearing: a slot past pos held a stale
    # latent, and holds stale + new now
    new_ckv, _ = attn._mla_latent(pp, torch.from_numpy(x), torch.arange(
        6, 14), pcfg)
    torch.testing.assert_close(pn["ckv"][0, 6:14],
                               pc["ckv"][0, 6:14] + new_ckv[0],
                               rtol=0, atol=1e-6)


# ------------------------------------------------------- whole models --
def both_models(name, seed=0, **over):
    jcfg, pcfg = reduced(name, **over)
    jm = jax_build_model(jcfg)
    jp = draw(jax.eval_shape(jm.init, jax.random.PRNGKey(0)), seed,
              stacked=True)
    return jm, jp, build_model(pcfg), params_from_reference(jp)


def tokens(vocab, b, s, seed):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)) \
        .astype(np.int32)


def assert_caches_match(port, ref, keys):
    np.testing.assert_array_equal(port["pos"].numpy(), np.asarray(ref["pos"]))
    np.testing.assert_array_equal(port["slot_pos"].numpy(),
                                  np.asarray(ref["slot_pos"]))
    stacks = sorted(k for k in ref if k.startswith("stack"))
    assert stacks == sorted(k for k in port if k.startswith("stack"))
    for st in stacks:
        for key in keys:
            got = torch.stack(port[st][key]).numpy()
            assert rel_err(got, ref[st][key]) < TOL, (st, key)


MODELS = {DEEPSEEK: ({}, ("ckv", "krope")),
          MIXTRAL: ({"sliding_window": 8}, ("k", "v"))}


@pytest.mark.parametrize("name", list(MODELS))
def test_prefill_decode_extend_match_jax(name):
    over, keys = MODELS[name]
    jm, jp, pm, pp = both_models(name, **over)
    vocab = pm.config.vocab_size
    toks = tokens(vocab, 2, 24, 1)
    lens = np.array([24, 17], np.int32)     # one right-padded prompt
    max_len = 40
    jl, jc = jax.jit(lambda p, b: jm.prefill(p, {**b, "max_len": max_len}))(
        jp, {"tokens": jnp.asarray(toks), "lens": jnp.asarray(lens)})
    pl, pc = pm.prefill(pp, {"tokens": torch.from_numpy(toks),
                             "lens": torch.from_numpy(lens),
                             "max_len": max_len})
    assert rel_err(pl, jl) < TOL
    assert_caches_match(pc, jc, keys)

    step = tokens(vocab, 2, 1, 2)[:, 0]
    jl2, jc2 = jax.jit(jm.decode_step)(jp, jc, jnp.asarray(step))
    pl2, pc2 = pm.decode_step(pp, pc, torch.from_numpy(step))
    assert rel_err(pl2, jl2) < TOL
    assert_caches_match(pc2, jc2, keys)

    ext = tokens(vocab, 2, 8, 3)
    lens_new = np.array([8, 5], np.int32)
    jl3, jc3 = jax.jit(jm.extend)(jp, jc2, jnp.asarray(ext),
                                  jnp.asarray(lens_new))
    pl3, pc3 = pm.extend(pp, pc2, torch.from_numpy(ext),
                         torch.from_numpy(lens_new))
    assert rel_err(pl3, jl3) < TOL
    assert_caches_match(pc3, jc3, keys)


def test_stacks_follow_first_dense_layers():
    """deepseek: one dense layer of ``dense_d_ff``, then the MoE stack."""
    _, _, pm, pp = both_models(DEEPSEEK)
    cfg = pm.config
    assert len(pp["stack0"]) == cfg.first_dense_layers == 1
    assert len(pp["stack1"]) == cfg.n_layers - 1
    assert pp["stack0"][0]["mlp"]["wg"].shape == (cfg.d_model,
                                                  cfg.dense_d_ff or cfg.d_ff)
    assert pp["stack1"][0]["moe"]["wg"].shape == (
        cfg.n_experts, cfg.d_model, cfg.moe_d_ff)
    assert "shared" in pp["stack1"][0]["moe"]


def test_mla_absorbed_decode_equivalent():
    """The reference's contract on the port: absorbed decode = naive
    latent-expansion decode within 2e-3 (no-drop capacity)."""
    jm, jp, pm, pp = both_models(DEEPSEEK, capacity_factor=4.0)
    toks = torch.from_numpy(tokens(pm.config.vocab_size, 2, 13, 11))
    _, cache = pm.prefill(pp, {"tokens": toks, "max_len": 16})
    nxt = torch.tensor([3, 5], dtype=torch.int32)
    prev = attn.MLA_ABSORBED
    try:
        attn.MLA_ABSORBED = False
        naive, _ = pm.decode_step(pp, cache, nxt)
        attn.MLA_ABSORBED = True
        absorbed, _ = pm.decode_step(pp, cache, nxt)
    finally:
        attn.MLA_ABSORBED = prev
    assert rel_err(absorbed, naive.numpy()) < SELF_TOL
    _, jc = jax.jit(lambda p, t: jm.prefill(p, {"tokens": t,
                                                "max_len": 16}))(
        jp, jnp.asarray(toks.numpy()))
    jl, _ = jax.jit(jm.decode_step)(jp, jc, jnp.asarray(nxt.numpy()))
    assert rel_err(absorbed, jl) < TOL


@pytest.mark.parametrize("name", list(MODELS))
def test_port_decode_matches_parallel(name):
    """The reference's decode-vs-parallel contract (no-drop capacity, as
    its tests use), with mixtral's ring wrapped several times."""
    over = dict(MODELS[name][0], capacity_factor=4.0)
    _, _, pm, pp = both_models(name, **over)
    b, s = 2, 21
    full = torch.from_numpy(tokens(pm.config.vocab_size, b, s + 1, 12))
    _, cache = pm.prefill(pp, {"tokens": full[:, :s], "max_len": s + 4})
    got, _ = pm.decode_step(pp, cache, full[:, s])
    want, _ = pm.prefill(pp, {"tokens": full, "max_len": s + 4})
    assert rel_err(got, want.numpy()) < SELF_TOL


# ------------------------------------------------------------ engines --
KW = {"max_len": 128, "max_new_tokens": 3, "cache_slots": 2}


@pytest.mark.parametrize("name", list(MODELS))
def test_engine_turn_for_turn_matches_jax(name):
    """Fresh, exact extension, identical repeat, a strict prefix of the
    cache (truncate, extend, decode: the MLA fault's path), a DAG fork and
    LRU evictions, on the JAX engine's own weights."""
    jcfg, pcfg = reduced(name)
    jeng = JaxEngine(jcfg, seed=3, **KW)
    peng = AgentEngine(pcfg, device="cpu", params=params_from_reference(
        jax.device_get(jeng.params)), **KW)
    rng = np.random.default_rng(4)
    turn = lambda n: rng.integers(1, 255, n).astype(np.int32)  # noqa: E731
    script, clock = [], iter(range(100))

    def serve(did, prompt, parents=()):
        now = float(next(clock))
        j = jeng.serve(did, prompt, now=now, parents=parents)
        p = peng.serve(did, prompt, now=now, parents=parents)
        np.testing.assert_array_equal(p.output_tokens, j.output_tokens)
        assert (p.n_hit, p.n_prompt, p.n_gen) == (j.n_hit, j.n_prompt,
                                                  j.n_gen), did
        script.append(p)
        return p

    p = turn(20)
    r = serve("d", p)                                        # fresh
    p = np.concatenate([p, r.output_tokens, turn(6)])
    r = serve("d", p)                                        # extend
    full = np.concatenate([p, r.output_tokens])
    serve("d", full)                                         # identical
    serve("d", np.concatenate([full[:12], turn(9)]))        # prefix hit
    serve("d", np.concatenate([peng.sessions["d"].prompt, turn(4)]))
    serve("d/child", np.concatenate([peng.sessions["d"].prompt, turn(5)]),
          parents=("d",))                                    # fork
    for i in range(2):
        serve(f"other-{i}", turn(25 + 7 * i))               # LRU
    hits = [r.n_hit for r in script]
    assert hits[0] == 0 and hits[1] > 0 and hits[2] == script[2].n_prompt
    assert hits[3] == 12 and hits[5] > 0
    assert peng.evictions == jeng.evictions > 0
    assert sorted(peng.sessions) == sorted(jeng.sessions)


# ------------------------------------------- the MLA stale-latent fault --
def truncate(cache, keep: int, xp):
    """The serving engine's truncation: slots at or past ``keep`` marked
    empty through ``slot_pos`` only (`serving/engine.py::_truncate`)."""
    new = dict(cache)
    new["slot_pos"] = xp.where(cache["slot_pos"] < keep, cache["slot_pos"],
                               -1)
    new["pos"] = xp.full_like(cache["pos"], keep)
    return new


@pytest.mark.parametrize("name,faulty", [(DEEPSEEK, True),
                                         ("qwen2.5-32b", False)])
def test_mla_stale_latent_fault_pinned(name, faulty):
    """Prefill 10 tokens, truncate to 5, extend by 5 others, decode one
    step; against a fresh prefill of the same 10 tokens.  MLA differs by
    more than 0.1 of the logits' scale in both packages alike (the
    reference's fault, reproduced); GQA, which clears the slots first,
    agrees within 1e-5."""
    jcfg, pcfg = reduced(name)
    jm = jax_build_model(jcfg)
    jp = jax.device_get(jm.init(jax.random.PRNGKey(0)))
    pm, pp = build_model(pcfg), params_from_reference(jp)
    toks = tokens(jcfg.vocab_size, 1, 15, 0)
    first, other = toks[:, :10], toks[:, 10:]
    again = np.concatenate([first[:, :5], other], axis=1)
    nxt = np.array([7], np.int32)
    out = {}
    jfns = (jax.jit(lambda p, t: jm.prefill(p, {"tokens": t,
                                                "max_len": 16})),
            jax.jit(jm.extend), jax.jit(jm.decode_step))
    pfns = (lambda p, t: pm.prefill(p, {"tokens": t, "max_len": 16}),
            pm.extend, pm.decode_step)
    for tag, xp, (prefill, extend, decode), p, arr in (
            ("jax", jnp, jfns, jp, jnp.asarray),
            ("port", torch, pfns, pp, torch.from_numpy)):
        _, c = prefill(p, arr(first))
        _, c = extend(p, truncate(c, 5, xp), arr(other),
                      arr(np.array([5], np.int32)))
        stale, _ = decode(p, c, arr(nxt))
        _, c = prefill(p, arr(again))
        fresh, _ = decode(p, c, arr(nxt))
        out[tag] = (np.asarray(stale), np.asarray(fresh))
    for stale, fresh in out.values():
        gap = rel_err(stale, fresh)
        assert (gap > 0.1) if faulty else (gap < TOL), gap
    assert rel_err(out["port"][0], out["jax"][0]) < TOL
    assert rel_err(out["port"][1], out["jax"][1]) < TOL
