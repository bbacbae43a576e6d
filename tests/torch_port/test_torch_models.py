"""The port's dense GQA model against the JAX model on the same weights.

Reduced ``qwen3-8b`` (``scaled(dtype="float32")``: GQA with qk-norm), the
``llama3-7b`` engine class (MHA, no qk-norm, head dim 64) and a
sliding-window variant (the ring-buffer cache layout) are built by both
packages; one parameter pytree in the JAX model's layout,
drawn with numpy, goes to the JAX model as it is and to the port through
`repro_torch.models.carry`; inputs are drawn with numpy too.  Checked: prefill
logits and caches, the hidden state of every layer on valid rows, decode
steps, extend, and the port's own decode-vs-parallel and extend-vs-prefill
consistency as ``tests/test_models.py`` checks the reference.

Tolerances (float32): port vs JAX within 1e-4 of the logits' max (the same
math with sums in another order); the self-consistency checks keep the
reference's 2e-3.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import blocks as jax_blocks  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.serving.cluster import \
    _engine_config as jax_engine_config  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import blocks, build_model  # noqa: E402
from repro_torch.models.carry import params_from_reference  # noqa: E402
from repro_torch.serving.cluster import _engine_config  # noqa: E402

PORT_TOL = 1e-4
SELF_TOL = 2e-3
CONFIGS = {
    "qwen3-8b": lambda g: g("qwen3-8b").scaled(dtype="float32"),
    "llama3-7b-engine": lambda g: (jax_engine_config if g is jax_get_config
                                   else _engine_config)("llama3-7b", 255),
    "qwen3-8b-window": lambda g: g("qwen3-8b").scaled(dtype="float32",
                                                      sliding_window=8),
}


def numpy_params(jm, seed: int = 0) -> dict:
    """The JAX model's parameter pytree drawn with numpy: its shapes (from
    ``eval_shape``, no compile), norm weights 1 + noise, the rest normal
    with std 1/sqrt(fan-in) as the reference's init draws."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        shape = leaf.shape
        if "norm" in name or "ln" in name:
            return (1.0 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
        fan_in = shape[1] if "stack" in name else shape[0]
        if name.endswith("['wo']"):
            fan_in = shape[1] * shape[2]
        return (rng.standard_normal(shape) / np.sqrt(fan_in)) \
            .astype(np.float32)

    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    return jax.tree_util.tree_map_with_path(draw, shapes)


def both(name):
    """(JAX model, its numpy params, port model, the same params carried)."""
    jcfg = CONFIGS[name](jax_get_config)
    pcfg = CONFIGS[name](get_config)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(pcfg)
    jm = jax_build_model(jcfg)
    jp = numpy_params(jm)
    pm = build_model(pcfg)
    return jm, jp, pm, params_from_reference(jp)


def rel_err(port, ref) -> float:
    ref = np.asarray(ref, np.float32)
    scale = float(np.max(np.abs(ref))) + 1e-9
    return float(np.max(np.abs(port.numpy() - ref))) / scale


def stacked(cache, key):
    return torch.stack(cache["stack0"][key]).numpy()


def assert_caches_match(port, ref):
    """k/v/slot_pos/pos of the port's per-layer cache against the JAX
    stacked one; k/v within the port tolerance of their max."""
    np.testing.assert_array_equal(port["pos"].numpy(), np.asarray(ref["pos"]))
    np.testing.assert_array_equal(port["slot_pos"].numpy(),
                                  np.asarray(ref["slot_pos"]))
    for key in ("k", "v"):
        assert rel_err(torch.from_numpy(stacked(port, key)),
                       ref["stack0"][key]) < PORT_TOL


def tokens(vocab, b, s, seed):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)) \
        .astype(np.int32)


def prefill_both(jm, jp, pm, pp, toks, lens, max_len):
    jl, jc = jax.jit(lambda p, b: jm.prefill(p, {**b, "max_len": max_len}))(
        jp, {"tokens": jnp.asarray(toks), "lens": jnp.asarray(lens)})
    pl, pc = pm.prefill(pp, {"tokens": torch.from_numpy(toks),
                             "lens": torch.from_numpy(lens),
                             "max_len": max_len})
    return (jl, jc), (pl, pc)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_prefill_decode_extend_match_jax(name):
    jm, jp, pm, pp = both(name)
    vocab = pm.config.vocab_size
    toks = tokens(vocab, 2, 24, 1)
    lens = np.array([24, 17], np.int32)     # one right-padded prompt
    max_len = 40
    (jl, jc), (pl, pc) = prefill_both(jm, jp, pm, pp, toks, lens, max_len)
    assert rel_err(pl, jl) < PORT_TOL
    assert_caches_match(pc, jc)

    step = tokens(vocab, 2, 1, 2)[:, 0]
    jl2, jc2 = jax.jit(jm.decode_step)(jp, jc, jnp.asarray(step))
    pl2, pc2 = pm.decode_step(pp, pc, torch.from_numpy(step))
    assert rel_err(pl2, jl2) < PORT_TOL
    assert_caches_match(pc2, jc2)

    ext = tokens(vocab, 2, 8, 3)
    lens_new = np.array([8, 5], np.int32)
    jl3, jc3 = jax.jit(jm.extend)(jp, jc2, jnp.asarray(ext),
                                  jnp.asarray(lens_new))
    pl3, pc3 = pm.extend(pp, pc2, torch.from_numpy(ext),
                         torch.from_numpy(lens_new))
    assert rel_err(pl3, jl3) < PORT_TOL
    assert_caches_match(pc3, jc3)


@pytest.mark.parametrize("name", ["qwen3-8b", "llama3-7b-engine"])
def test_hidden_states_match_jax_on_valid_rows(name):
    """Layer by layer on a right-padded batch.  The reference masks keys at
    or past each sequence's length; the port calls the attention kernel as
    the TPU kernel is called, with the causal mask only.  Under the causal
    mask a valid row never reaches a padded key, so the two agree on valid
    rows; padded rows differ, and nothing reads them (the cache layout
    zeroes their K/V and the logits come from the last valid row)."""
    jm, jp, pm, pp = both(name)
    cfg = pm.config
    toks = tokens(cfg.vocab_size, 2, 16, 4)
    lens = np.array([16, 9], np.int32)
    jx = jp["embed"][jnp.asarray(toks)]
    px = pp["embed"][torch.from_numpy(toks).long()]
    valid = np.arange(16)[None, :] < lens[:, None]
    block = jax.jit(lambda p_l, x: jax_blocks.attn_block_parallel(
        p_l, x, jm.config, ffn_kind="dense", lens=jnp.asarray(lens))[0])
    for layer in range(cfg.n_layers):
        jx = block(jax.tree.map(lambda a: a[layer], jp["stack0"]), jx)
        px, _ = blocks.attn_block_parallel(pp["stack0"][layer], px, cfg)
        assert rel_err(px[torch.from_numpy(valid)],
                       np.asarray(jx)[valid]) < PORT_TOL


@pytest.mark.parametrize("name", list(CONFIGS))
def test_port_decode_matches_parallel(name):
    _, _, pm, pp = both(name)
    b, s = 2, 21
    full = torch.from_numpy(tokens(pm.config.vocab_size, b, s + 1, 5))
    la, cache = pm.prefill(pp, {"tokens": full[:, :s], "max_len": s + 4})
    la2, _ = pm.decode_step(pp, cache, full[:, s])
    lb, _ = pm.prefill(pp, {"tokens": full, "max_len": s + 4})
    assert rel_err(la2, lb) < SELF_TOL


@pytest.mark.parametrize("name", list(CONFIGS))
def test_port_extend_matches_prefill(name):
    _, _, pm, pp = both(name)
    b, s, s0 = 2, 21, 13
    full = torch.from_numpy(tokens(pm.config.vocab_size, b, s, 6))
    ref, _ = pm.prefill(pp, {"tokens": full, "max_len": s + 4})
    _, cache = pm.prefill(pp, {"tokens": full[:, :s0], "max_len": s + 4})
    got, _ = pm.extend(pp, cache, full[:, s0:],
                       torch.full((b,), s - s0, dtype=torch.int32))
    assert rel_err(got, ref) < SELF_TOL


@pytest.mark.parametrize("name", ["qwen3-8b", "qwen3-8b-window"])
def test_init_cache_matches_jax(name):
    jm, _, pm, _ = both(name)
    jc = jm.init_cache(2, 40)
    pc = pm.init_cache(2, 40, "cpu")
    assert_caches_match(pc, jc)
    assert len(pc["stack0"]["k"]) == pm.config.n_layers
    assert pc["stack0"]["k"][0].dtype == torch.float32


def test_unported_families_raise():
    """The registry lists only what the port builds (dense GQA, RWKV-6,
    zamba2); the other families name the slice that ports them."""
    base = get_config("qwen3-8b").scaled(dtype="float32")
    for over in ({"n_experts": 4, "top_k": 2}, {"attn_kind": "mla"},
                 {"enc_layers": 2}):
        with pytest.raises(NotImplementedError, match="slice"):
            build_model(dataclasses.replace(base, **over))
