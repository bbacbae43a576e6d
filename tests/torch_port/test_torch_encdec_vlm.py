"""The port's encoder-decoder (``seamless-m4t-medium``) and patch-input
(``llava-next-34b``) models against the JAX package on the same weights
and inputs.

The reduced configs (``cfg.scaled(dtype="float32")``: 2 decoder layers,
``enc_layers`` 2 and ``src_len`` 32 for seamless, ``n_patches`` 8 for
llava) are built by both packages.  Parameters are drawn with numpy in the
JAX model's layout (or, for the engines, taken from the JAX engine); the
JAX side gets them as they are, the port through
`repro_torch.models.carry`.  Frames and patches are 0.1 · N(0, 1), drawn
with numpy, as the reference's model tests scale them: zero frames would
leave the encoder and the cross-attention unchecked.  Checked:

* the encoder, and the seamless prefill (logits, self and cross K/V,
  ``slot_pos``, ``pos``) and three decode steps;
* llava's patched prefill, three decode steps and an extend;
* the reference's decode-vs-parallel and extend-vs-prefill contracts on
  the port (2e-3);
* the `AgentEngine` against the JAX engine, turn for turn (seamless on
  the engine's zero frames, llava on text alone, as the reference's engine
  serves them);
* the reference's encoder-decoder gap: ``extend``, an engine turn that
  needs it and ``warmup()`` raise `NotImplementedError` in both packages;
* the registry: the reference's ten names, every one built, the analytic
  parameter counts equal.

Tolerances (float32): port vs JAX within 1e-4 of the reference's largest
magnitude (the same math with sums in another order); ``slot_pos`` and
``pos`` exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import list_archs as jax_list_archs  # noqa: E402
from repro.configs import param_counts as jax_param_counts  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.serving.engine import AgentEngine as JaxEngine  # noqa: E402
from repro_torch.configs import get_config, list_archs  # noqa: E402
from repro_torch.configs import param_counts  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.carry import params_from_reference  # noqa: E402
from repro_torch.serving.engine import AgentEngine  # noqa: E402

TOL = 1e-4
SELF_TOL = 2e-3
SEAMLESS = "seamless-m4t-medium"
LLAVA = "llava-next-34b"
STACKED = ("['stack", "['encoder']", "['decoder']")


def reduced(name):
    jcfg = jax_get_config(name).scaled(dtype="float32")
    pcfg = get_config(name).scaled(dtype="float32")
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(pcfg)
    return jcfg, pcfg


def numpy_params(jm, seed: int = 0) -> dict:
    """The JAX model's parameter pytree drawn with numpy: norm weights
    1 + noise, the rest normal with std 1/sqrt(fan-in); a leaf of a stacked
    group (``stack<i>``, ``encoder``, ``decoder``) has a leading layer dim,
    and ``wo`` [H, hd, D] has fan-in H·hd."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        shape = leaf.shape[1:] if any(g in name for g in STACKED) \
            else leaf.shape
        if "norm" in name or "['ln" in name:
            return (1.0 + 0.1 * rng.standard_normal(leaf.shape)) \
                .astype(np.float32)
        fan_in = shape[0] * shape[1] if name.endswith("['wo']") \
            else shape[0]
        return (rng.standard_normal(leaf.shape) / np.sqrt(fan_in)) \
            .astype(np.float32)

    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    return jax.tree_util.tree_map_with_path(draw, shapes)


def both(name):
    """(JAX model, its numpy params, port model, the same params carried)."""
    jcfg, pcfg = reduced(name)
    jm = jax_build_model(jcfg)
    jp = numpy_params(jm)
    return jm, jp, build_model(pcfg), params_from_reference(jp)


def rel_err(port, ref) -> float:
    ref = np.asarray(ref, np.float32)
    port = port.numpy() if isinstance(port, torch.Tensor) else port
    return float(np.max(np.abs(port - ref))) / (float(np.max(np.abs(ref)))
                                                + 1e-9)


def tokens(vocab, b, s, seed):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)) \
        .astype(np.int32)


def side_input(cfg, b, seed) -> dict:
    """0.1 · N(0, 1) frames (encoder-decoder) or patches (patch input)."""
    rng = np.random.default_rng(seed)
    if cfg.is_encdec:
        return {"frames": (0.1 * rng.standard_normal(
            (b, cfg.src_len, cfg.d_model))).astype(np.float32)}
    return {"patches": (0.1 * rng.standard_normal(
        (b, cfg.n_patches, cfg.d_model))).astype(np.float32)}


def prefill_both(jm, jp, pm, pp, arrays: dict, max_len: int):
    """The same batch through the JAX prefill (jitted, ``max_len`` closed
    over) and the port's."""
    jout = jax.jit(lambda p, b: jm.prefill(p, {**b, "max_len": max_len}))(
        jp, {k: jnp.asarray(v) for k, v in arrays.items()})
    pout = pm.prefill(pp, {**{k: torch.from_numpy(v)
                              for k, v in arrays.items()},
                           "max_len": max_len})
    return jout, pout


def assert_caches_match(port, ref, name):
    np.testing.assert_array_equal(port["pos"].numpy(), np.asarray(ref["pos"]))
    np.testing.assert_array_equal(port["slot_pos"].numpy(),
                                  np.asarray(ref["slot_pos"]))
    if name == SEAMLESS:
        groups = [(port, ref, key) for key in ("k", "v", "xk", "xv")]
    else:
        groups = [(port["stack0"], ref["stack0"], key) for key in ("k", "v")]
    for p, r, key in groups:
        got = torch.stack(p[key]).numpy()
        assert got.shape == np.asarray(r[key]).shape, key
        assert rel_err(got, r[key]) < TOL, key


def test_registry_lists_the_references_ten_archs():
    assert list_archs() == jax_list_archs()
    assert len(list_archs()) == 10
    for name in list_archs():
        assert dataclasses.asdict(get_config(name)) \
            == dataclasses.asdict(jax_get_config(name))


@pytest.mark.parametrize("name", [SEAMLESS, LLAVA])
def test_param_counts_match_reference(name):
    assert param_counts(get_config(name)) \
        == jax_param_counts(jax_get_config(name))
    pm = build_model(get_config(name).scaled(dtype="float32"))
    params = pm.init(torch.Generator().manual_seed(0))
    jm = jax_build_model(jax_get_config(name).scaled(dtype="float32"))
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    assert sum(p.numel() for p in params.parameters()) \
        == sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes))


def test_encode_matches_jax():
    jm, jp, pm, pp = both(SEAMLESS)
    frames = side_input(pm.config, 2, 1)["frames"]
    want = jax.jit(jm.extras["encode"])(jp, jnp.asarray(frames))
    got = pm.extras["encode"](pp, torch.from_numpy(frames))
    assert got.shape == (2, pm.config.src_len, pm.config.d_model)
    assert rel_err(got, want) < TOL


@pytest.mark.parametrize("name", [SEAMLESS, LLAVA])
def test_prefill_decode_match_jax(name):
    """A right-padded batch of two, then three decode steps; for llava an
    extend after them (seamless's raises: see below)."""
    jm, jp, pm, pp = both(name)
    cfg = pm.config
    toks = tokens(cfg.vocab_size, 2, 24, 2)
    lens = np.array([24, 17], np.int32)
    max_len = 24 + cfg.n_patches + 16
    (jl, jc), (pl, pc) = prefill_both(
        jm, jp, pm, pp, {"tokens": toks, "lens": lens,
                         **side_input(cfg, 2, 3)}, max_len)
    assert rel_err(pl, jl) < TOL
    assert_caches_match(pc, jc, name)
    if name == LLAVA:     # the patches count in the positions
        np.testing.assert_array_equal(pc["pos"].numpy(), lens + 8)
    jdec = jax.jit(jm.decode_step)
    for i in range(3):
        step = tokens(cfg.vocab_size, 2, 1, 4 + i)[:, 0]
        jl, jc = jdec(jp, jc, jnp.asarray(step))
        pl, pc = pm.decode_step(pp, pc, torch.from_numpy(step))
        assert rel_err(pl, jl) < TOL, i
        assert_caches_match(pc, jc, name)
    if name == LLAVA:
        ext = tokens(cfg.vocab_size, 2, 8, 7)
        lens_new = np.array([8, 5], np.int32)
        jl, jc = jax.jit(jm.extend)(jp, jc, jnp.asarray(ext),
                                    jnp.asarray(lens_new))
        pl, pc = pm.extend(pp, pc, torch.from_numpy(ext),
                           torch.from_numpy(lens_new))
        assert rel_err(pl, jl) < TOL
        assert_caches_match(pc, jc, name)


@pytest.mark.parametrize("name", [SEAMLESS, LLAVA])
def test_port_decode_matches_parallel(name):
    """The reference's contract (tests/test_models.py) on the port: a
    decode step after a prefill of S tokens equals a prefill of S + 1."""
    _, _, pm, pp = both(name)
    cfg = pm.config
    b, s = 2, 21
    full = torch.from_numpy(tokens(cfg.vocab_size, b, s + 1, 8))
    side = {k: torch.from_numpy(v) for k, v in side_input(cfg, b, 9).items()}
    ml = s + cfg.n_patches + 4
    _, cache = pm.prefill(pp, {"tokens": full[:, :s], "max_len": ml, **side})
    got, _ = pm.decode_step(pp, cache, full[:, s])
    want, _ = pm.prefill(pp, {"tokens": full, "max_len": ml, **side})
    assert rel_err(got, want.numpy()) < SELF_TOL


def test_port_extend_matches_prefill():
    """The reference's contract on llava: a patched prefill of 13 tokens
    extended by 8 equals a patched prefill of the 21."""
    _, _, pm, pp = both(LLAVA)
    cfg = pm.config
    b, s, s0 = 2, 21, 13
    full = torch.from_numpy(tokens(cfg.vocab_size, b, s, 10))
    side = {k: torch.from_numpy(v) for k, v in side_input(cfg, b, 11).items()}
    ml = s + cfg.n_patches + 4
    want, _ = pm.prefill(pp, {"tokens": full, "max_len": ml, **side})
    _, cache = pm.prefill(pp, {"tokens": full[:, :s0], "max_len": ml,
                               **side})
    got, _ = pm.extend(pp, cache, full[:, s0:],
                       torch.full((b,), s - s0, dtype=torch.int32))
    assert rel_err(got, want.numpy()) < SELF_TOL


def test_encdec_extend_raises_in_both():
    jm, jp, pm, pp = both(SEAMLESS)
    cfg = pm.config
    (_, jc), (_, pc) = prefill_both(
        jm, jp, pm, pp, {"tokens": tokens(cfg.vocab_size, 1, 8, 12),
                         **side_input(cfg, 1, 13)}, 16)
    ext, lens_new = tokens(cfg.vocab_size, 1, 4, 14), np.array([4], np.int32)
    with pytest.raises(NotImplementedError, match="enc-dec extend"):
        jm.extend(jp, jc, jnp.asarray(ext), jnp.asarray(lens_new))
    with pytest.raises(NotImplementedError, match="enc-dec extend"):
        pm.extend(pp, pc, torch.from_numpy(ext), torch.from_numpy(lens_new))


# ------------------------------------------------------------ engines --
KW = {"max_len": 64, "max_new_tokens": 3, "cache_slots": 2}


def engines(name):
    jcfg, pcfg = reduced(name)
    jeng = JaxEngine(jcfg, seed=3, **KW)
    peng = AgentEngine(pcfg, device="cpu", params=params_from_reference(
        jax.device_get(jeng.params)), **KW)
    return jeng, peng


@pytest.mark.parametrize("name", [SEAMLESS, LLAVA])
def test_engine_turn_for_turn_matches_jax(name):
    """Fresh, the identical repeat, a truncation-only hit (a prefix of the
    stored prompt: truncate, then the no-op decode) and LRU evictions;
    llava (text alone) also an exact extension, a partial prefix hit and a
    DAG fork.  Seamless's exact extension needs ``extend``, which raises in
    both engines (the reference's gap, ROADMAP §3)."""
    jeng, peng = engines(name)
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

    r = serve("d", turn(20))                                 # fresh
    full = peng.sessions["d"].prompt
    serve("d", full)                                         # identical
    serve("d", full[:15])                                    # truncation
    assert [x.n_hit for x in script] == [0, 23, 15]
    if name == LLAVA:
        p = np.concatenate([peng.sessions["d"].prompt, turn(6)])
        assert serve("d", p).n_hit == 18                     # extend
        full = peng.sessions["d"].prompt
        assert serve("d", np.concatenate([full[:12], turn(9)])).n_hit == 12
        assert serve("d/child", np.concatenate(
            [peng.sessions["d"].prompt, turn(5)]), parents=("d",)).n_hit > 0
    else:
        more = np.concatenate([peng.sessions["d"].prompt, turn(6)])
        with pytest.raises(NotImplementedError, match="enc-dec extend"):
            jeng.serve("d", more, now=50.0)
        with pytest.raises(NotImplementedError, match="enc-dec extend"):
            peng.serve("d", more, now=50.0)
    for i in range(2):
        serve(f"other-{i}", turn(25 + 7 * i))               # LRU
    assert r.n_gen == 3
    assert peng.evictions == jeng.evictions > 0
    assert sorted(peng.sessions) == sorted(jeng.sessions)


def test_encdec_warmup_raises_in_both():
    """``warmup()`` serves its prefill buckets (32 and 64 at ``max_len``
    64) under one warm-up session, so the 64-token bucket already extends
    the 32-token one, and then the extend buckets extend it: the
    encoder-decoder raises in both engines, with or without extend
    buckets.  One prefill bucket per call goes through."""
    for eng in engines(SEAMLESS):
        for kw in ({}, {"extend_buckets": ()}):
            eng.drop_session("__warm__")
            with pytest.raises(NotImplementedError, match="enc-dec extend"):
                eng.warmup(**kw)
        eng.drop_session("__warm__")
        for b in (32, 64):
            eng.warmup(prefill_buckets=(b,), extend_buckets=())
        assert "__warm__" not in eng.sessions
