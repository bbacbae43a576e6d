"""The port's training path against the JAX package's, on the CPU.

Reduced float32 configs (``scaled(dtype="float32")``) are built by both
packages on one set of weights: drawn with numpy in the JAX model's layout
(norm weights 1 + noise, the rest std 1/sqrt(fan-in); the recurrent
families redrawn around the reference's own init, as
``test_torch_recurrent.py`` does), given to the JAX model as they are and
to the port through `repro_torch.models.carry`; JAX gradients are carried
into the port's layout the same way.  Inputs are drawn with numpy.

Checked:

* ``next_token_loss`` with -100 targets (1e-6 relative);
* each family's ``loss`` and every gradient leaf against
  ``jax.value_and_grad`` of the reference's ``loss``: qwen3-8b,
  mixtral-8x22b (window 16), deepseek-v2-lite-16b (MLA + MoE), rwkv6-3b,
  zamba2-7b, llava-next-34b (with patches) and seamless-m4t-medium (with
  frames): the loss within 1e-5 relative, each leaf within 1e-4 of its
  largest reference magnitude (zamba2-7b, at weight seeds 0 and 1,
  against a float64 oracle instead: see below);
* the reference's two training faults, pinned in both packages:
  seamless without frames and llava without patches raise;
* ``lr_schedule``, ``adamw_update`` over 3 clipped steps, compression and
  its error feedback, ``SyntheticLM`` bit for bit, and ``make_train_step``
  (plain, ``accum_steps=2``, compressed) for 3 steps against the
  reference's jitted step (losses and parameters within 1e-5 of their
  max);
* the reference test's contracts (``tests/test_training.py``) on the port:
  the loss falls, a crashed run resumes bit for bit, a stale
  ``.tmp_step_*`` never shadows a complete step, a shape mismatch on
  restore raises, accumulation matches one batch;
* the CLI (``--device cpu --smoke``) prints the reference CLI's lines;
* ``flash_attention_bwd_plain`` (the backward kernel's oracle) against
  autograd of ``attention_ref`` (1e-6) and ``jax.vjp`` of the reference's
  jnp attention (1e-5), causal, windowed and non-causal with Sq != Sk, at
  GQA groups 1, 4 and 6.

zamba2-7b's gate: its float32 gradient is ill-conditioned at these
weights in both packages, so its two cases hold the port against an exact
oracle instead of a flat tolerance.  The oracle is the JAX package's own
``loss`` differentiated under ``jax.enable_x64(True)`` with the reference's
float32 islands (``astype(jnp.float32)`` in the loss, the norms, RoPE, the
softmax and the scans) read as float64: each model module's ``jnp`` is
swapped, inside the test, for a view whose ``float32`` is ``float64``, and
the oracle's jaxpr is checked to hold no float32 value.  Nothing under
``src/repro`` changes.  (A config built with ``scaled(dtype="float64")``
is no such oracle in either package: both cast to float32 at those
islands, the port's ``next_token_loss`` by ``.float()``, so its loss
prints the float32 loss to every digit.)  Let d_jax be the largest
distance of a leaf of the JAX package's float32 gradient from the oracle
(each leaf's error over the oracle leaf's largest magnitude); every leaf
of the port's float32 gradient must lie within
``max(1e-4, 1.5 * d_jax)`` of the oracle, and within that bound plus
d_jax of the JAX package's gradient (at weight seed 0 also within the
earlier flat 8e-4 of it).  Measured on the CPU: at weight seed 0,
d_jax = 1.31e-3 and the port 1.50e-3 (``embed``); at seed 1,
d_jax = 1.49e-4 (``shared.lora.0.kb``) and the port 9.95e-5
(``groups.1.1.mix.A_log``), while the two float32 gradients lie 1.71e-4
apart (``groups.0.1.mix.conv_w``), past the 1e-4 this case held until the
float64 oracle showed the excess to be the reference's rounding.  The
bound is the gradient's worst leaf, not each leaf's own: a leaf the
reference happens to round well (seed 1's ``groups.1.1.mix.A_log``,
2.5e-5) says nothing of the problem's conditioning.
"""
import contextlib
import dataclasses
import functools
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.launch import train as jax_train_cli  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import attention as jax_attention  # noqa: E402
from repro.models import blocks as jax_blocks  # noqa: E402
from repro.models import layers as jax_layers  # noqa: E402
from repro.models import lm as jax_lm  # noqa: E402
from repro.models import moe as jax_moe  # noqa: E402
from repro.models import ssm as jax_ssm  # noqa: E402
from repro.models.attention import \
    attend_parallel as jax_attend_parallel  # noqa: E402
from repro.models.layers import \
    next_token_loss as jax_next_token_loss  # noqa: E402
from repro.training import compress as jax_compress  # noqa: E402
from repro.training import loop as jax_loop  # noqa: E402
from repro.training import optimizer as jax_opt  # noqa: E402
from repro.training.data import SyntheticLM as JaxSyntheticLM  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention_bwd_plain, flash_attention_plain)
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.carry import params_from_reference  # noqa: E402
from repro_torch.models.layers import next_token_loss  # noqa: E402
from repro_torch.training import (CompressionConfig, OptConfig,  # noqa: E402
                                  SyntheticLM, adamw_init, adamw_update,
                                  latest_step, restore_checkpoint,
                                  save_checkpoint, train_loop)
from repro_torch.training.compress import (  # noqa: E402
    compress_with_feedback, init_feedback)
from repro_torch.training.loop import (init_opt_state,  # noqa: E402
                                       loss_and_grads, make_train_step)
from repro_torch.training.optimizer import lr_schedule  # noqa: E402
from repro_torch.utils.tree import (tree_leaves,  # noqa: E402
                                    tree_paths_and_leaves)
from test_torch_encdec_vlm import numpy_params  # noqa: E402
from test_torch_ssm import draw_params  # noqa: E402

LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
ORACLE_GATED = {"zamba2-7b"}    # the module docstring says why
FLAT_CAP = {("zamba2-7b", 0): 8e-4}     # the case's earlier flat gate
FAMILIES = {
    "qwen3-8b": {},
    "mixtral-8x22b": {"sliding_window": 16},
    "deepseek-v2-lite-16b": {},
    "rwkv6-3b": {},
    "zamba2-7b": {},
    "llava-next-34b": {},
    "seamless-m4t-medium": {},
}
B, S = 2, 24


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module: its small models run many
    small ops, ~3x faster on one thread, and far faster than on many when
    the test runner's workers share the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def reduced(name, **overrides):
    jcfg = jax_get_config(name).scaled(dtype="float32", **overrides)
    pcfg = get_config(name).scaled(dtype="float32", **overrides)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(pcfg)
    return jcfg, pcfg


def reference_params(jm, jcfg, seed: int = 0) -> dict:
    if jcfg.ssm_kind:
        return draw_params(jax.device_get(jax.jit(jm.init)(
            jax.random.PRNGKey(seed))), np.random.default_rng(seed))
    return numpy_params(jm, seed)


def unfrozen(jp):
    pp = params_from_reference(jp)
    for p in tree_leaves(pp):
        p.requires_grad_(True)
    return pp


def make_batch(cfg, seed: int, b: int = B, s: int = S) -> dict:
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s))
             .astype(np.int32)}
    if cfg.is_encdec:
        batch["frames"] = (0.1 * rng.standard_normal(
            (b, cfg.src_len, cfg.d_model))).astype(np.float32)
    if cfg.n_patches:
        batch["patches"] = (0.1 * rng.standard_normal(
            (b, cfg.n_patches, cfg.d_model))).astype(np.float32)
    return batch


def to_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def to_torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def leaf_err(port, ref) -> float:
    """Max abs error over the reference's largest magnitude."""
    port = port.detach().double().numpy()
    ref = np.asarray(ref, np.float64)
    return float(np.abs(port - ref).max() / (np.abs(ref).max() + 1e-30))


def worst_leaves(port_tree, ref_tree, tol):
    """[(path, error)] of the leaves of ``port_tree`` (a port tree) off
    ``ref_tree`` (a port tree of the reference's values) by ``tol`` or
    more, in relative error to each reference leaf's max."""
    ref = tree_leaves(ref_tree)
    return [(n, e) for (n, p), r in zip(tree_paths_and_leaves(port_tree),
                                        ref)
            if (e := leaf_err(p, r.numpy())) >= tol]


# ---------------------------------------------------------------- loss --

def test_next_token_loss_matches_reference():
    rng = np.random.default_rng(0)
    logits = (3 * rng.standard_normal((3, 17, 50))).astype(np.float32)
    tokens = rng.integers(0, 50, (3, 17)).astype(np.int32)
    tokens[0, 5:9] = -100
    tokens[2, :] = -100                       # a row with no valid target
    want = float(jax_next_token_loss(jnp.asarray(logits),
                                     jnp.asarray(tokens)))
    got = float(next_token_loss(torch.from_numpy(logits),
                                torch.from_numpy(tokens)))
    assert abs(got - want) <= 1e-6 * abs(want)
    all_ignored = np.full_like(tokens, -100)
    assert float(next_token_loss(torch.from_numpy(logits),
                                 torch.from_numpy(all_ignored))) == 0.0


@functools.cache
def reference_loss(name):
    """(JAX config, port config, JAX model, its jitted value_and_grad),
    one compile per family for all of its seeds."""
    jcfg, pcfg = reduced(name, **FAMILIES[name])
    jm = jax_build_model(jcfg)
    return jcfg, pcfg, jm, jax.jit(jax.value_and_grad(jm.loss))


class _Float64Numpy:
    """``jax.numpy`` with ``float32`` read as ``float64``."""

    def __getattr__(self, name):
        return jnp.float64 if name == "float32" else getattr(jnp, name)


@contextlib.contextmanager
def float64_reference():
    """The JAX package's models at float64 throughout: x64 on, and each
    model module's float32 islands read as float64.  Both are global, so
    both are undone on the way out."""
    mods = (jax_layers, jax_attention, jax_moe, jax_ssm, jax_blocks, jax_lm)
    with jax.enable_x64(True), pytest.MonkeyPatch.context() as mp:
        for mod in mods:
            mp.setattr(mod, "jnp", _Float64Numpy())
        yield


def float64_oracle(jcfg, jp, batch):
    """The reference loss's exact gradient at ``jp`` on ``batch``, as a
    port tree of float64 tensors."""
    as64 = lambda a: (np.asarray(a, np.float64) if a.dtype.kind == "f"
                      else a)
    with float64_reference():
        jm = jax_build_model(dataclasses.replace(jcfg, dtype="float64"))
        value_and_grad = jax.value_and_grad(jm.loss)
        args = (jax.tree.map(as64, jp),
                to_jax({k: as64(v) for k, v in batch.items()}))
        assert "f32" not in str(jax.make_jaxpr(value_and_grad)(*args))
        _, grads = jax.jit(value_and_grad)(*args)
        return params_from_reference(jax.device_get(grads))


def oracle_dist(tree, oracle) -> list:
    """Each leaf's max abs distance from the oracle over the oracle
    leaf's largest magnitude."""
    return [float((p.detach().double() - o).abs().max()
                  / (o.abs().max() + 1e-30))
            for p, o in zip(tree_leaves(tree), tree_leaves(oracle))]


@pytest.mark.parametrize("name,seed", [
    *((name, 0) for name in FAMILIES), ("zamba2-7b", 1)],
    ids=[*FAMILIES, "zamba2-7b-seed1"])
def test_loss_and_gradients_match_jax(name, seed):
    """Weights from ``seed``, the batch from ``seed + 1``."""
    jcfg, pcfg, jm, value_and_grad = reference_loss(name)
    jp = reference_params(jm, jcfg, seed)
    batch = make_batch(jcfg, seed + 1)
    jl, jg = value_and_grad(jp, to_jax(batch))
    pm = build_model(pcfg)
    pp = unfrozen(jp)
    loss, grads = loss_and_grads(pm, pp, to_torch(batch))
    assert abs(float(loss) - float(jl)) <= LOSS_TOL * abs(float(jl))
    ref = params_from_reference(jax.device_get(jg))
    assert [n for n, _ in tree_paths_and_leaves(grads)] == \
        [n for n, _ in tree_paths_and_leaves(ref)]
    tol = GRAD_TOL
    if name in ORACLE_GATED:
        oracle = float64_oracle(jcfg, jp, batch)
        d_jax = max(oracle_dist(ref, oracle))
        gate = max(GRAD_TOL, 1.5 * d_jax)
        names = [n for n, _ in tree_paths_and_leaves(grads)]
        far = [(n, d) for n, d in zip(names, oracle_dist(grads, oracle))
               if d > gate]
        assert not far, (gate, d_jax, far)
        tol = min(gate + d_jax, FLAT_CAP.get((name, seed), np.inf))
    bad = worst_leaves(grads, ref, tol)
    assert not bad, bad


def test_reference_training_faults_raise_in_both_packages():
    """seamless's loss reads batch["frames"]; llava's prepends n_patches
    -100 targets whether or not the batch holds patches."""
    for name, missing, error in (("seamless-m4t-medium", "frames", KeyError),
                                 ("llava-next-34b", "patches", ValueError)):
        jcfg, pcfg = reduced(name)
        jm = jax_build_model(jcfg)
        jp = reference_params(jm, jcfg)
        batch = make_batch(jcfg, 2)
        del batch[missing]
        with pytest.raises(error):
            jax.jit(jm.loss)(jp, to_jax(batch))
        with pytest.raises(error):
            build_model(pcfg).loss(params_from_reference(jp),
                                   to_torch(batch))


# ----------------------------------------------------------- optimizer --

def test_lr_schedule_matches_reference():
    cfg = OptConfig(lr=3e-3, warmup_steps=10, total_steps=50)
    jcfg = jax_opt.OptConfig(lr=3e-3, warmup_steps=10, total_steps=50)
    for step in (0, 4, 9, 10, 30, 49, 50, 60):
        want = float(jax_opt.lr_schedule(jcfg, jnp.asarray(step, jnp.int32)))
        got = lr_schedule(cfg, torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        # within 1e-7 of the peak: near the cosine's end, 1 + cos(pi·t)
        # cancels, and one float32 ulp of cos is a large share of it
        assert abs(float(got) - want) <= 1e-7 * cfg.lr, step


def _small_tree(rng):
    return {"w": rng.standard_normal((16, 8)).astype(np.float32),
            "b": {"c": rng.standard_normal(8).astype(np.float32)},
            "e": rng.standard_normal((5, 3)).astype(np.float32)}


def _tensors(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def test_adamw_matches_reference_with_clipping():
    rng = np.random.default_rng(3)
    params = _small_tree(rng)
    cfg = OptConfig(lr=1e-2, warmup_steps=2, total_steps=6, grad_clip=0.5)
    jcfg = jax_opt.OptConfig(lr=1e-2, warmup_steps=2, total_steps=6,
                             grad_clip=0.5)
    jparams = jax.tree.map(jnp.asarray, params)
    jstate = jax_opt.adamw_init(jparams)
    pparams = _tensors(params)
    pstate = adamw_init(pparams)
    for p, w in zip(tree_leaves(pparams), tree_leaves(pstate["master"])):
        assert p.data_ptr() != w.data_ptr()      # master never aliases
    for _ in range(3):
        grads = jax.tree.map(lambda a: (4 * rng.standard_normal(a.shape))
                             .astype(np.float32), params)
        jparams, jstate, jstats = jax_opt.adamw_update(
            jparams, jax.tree.map(jnp.asarray, grads), jstate, jcfg)
        pparams, pstate, pstats = adamw_update(pparams, _tensors(grads),
                                               pstate, cfg)
        assert float(jstats["grad_norm"]) > cfg.grad_clip   # clipping bites
        assert abs(float(pstats["grad_norm"]) - float(jstats["grad_norm"])) \
            <= 1e-6 * float(jstats["grad_norm"])
        assert float(pstats["lr"]) == pytest.approx(float(jstats["lr"]),
                                                    rel=1e-7)
    assert int(pstate["step"]) == int(jstate["step"]) == 3
    for got, want in zip(tree_leaves(pparams), jax.tree.leaves(jparams)):
        assert leaf_err(got, want) < 1e-6
    for key in ("m", "v", "master"):
        for got, want in zip(tree_leaves(pstate[key]),
                             jax.tree.leaves(jstate[key])):
            assert leaf_err(got, want) < 1e-6, key


def test_compression_and_feedback_match_reference():
    rng = np.random.default_rng(4)
    grads = {"w": (rng.standard_normal((40, 33)) * 3).astype(np.float32),
             "v": rng.standard_normal(300).astype(np.float32)}
    grads["w"][0, :8] = [0.5, 1.5, 2.5, -0.5, -1.5, 127, -127, 0]
    cfg = CompressionConfig(enabled=True, block=64)
    jcfg = jax_compress.CompressionConfig(enabled=True, block=64)
    jg = jax.tree.map(jnp.asarray, grads)
    jfb = jax_compress.init_feedback(jg)
    pg = _tensors(grads)
    pfb = init_feedback(pg)
    for _ in range(2):
        jc, jfb = jax_compress.compress_with_feedback(jg, jfb, jcfg)
        prev = pfb
        pc, pfb = compress_with_feedback(pg, pfb, cfg)
        for got, want in zip(tree_leaves(pc), jax.tree.leaves(jc)):
            assert leaf_err(got, want) < 1e-6
        for got, want in zip(tree_leaves(pfb), jax.tree.leaves(jfb)):
            assert float((got.double() - torch.from_numpy(
                np.array(want)).double()).abs().max()) < 1e-6
        # compressed + new residual = gradient + old residual
        for key in grads:
            assert torch.allclose(pc[key] + pfb[key], pg[key] + prev[key],
                                  atol=1e-5)
    off = compress_with_feedback(pg, pfb, CompressionConfig(enabled=False))
    assert off[0] is pg and off[1] is pfb


def test_synthetic_lm_batches_equal_the_reference():
    for seed, step in ((0, 0), (3, 7), (11, 123)):
        want = JaxSyntheticLM(97, 19, 5, seed=seed).batch_at(step)["tokens"]
        got = SyntheticLM(97, 19, 5, seed=seed).batch_at(step)["tokens"]
        assert got.dtype == want.dtype and np.array_equal(got, want)


# ---------------------------------------------------------- train step --

def tiny(name="qwen3-8b"):
    over = dict(n_layers=2, d_model=64, d_ff=128, vocab_size=64)
    jcfg = jax_get_config(name).scaled(dtype="float32", **over)
    pcfg = get_config(name).scaled(dtype="float32", **over)
    return jcfg, pcfg


def assert_steps_close(port_tree, ref_tree, n_steps: int, lr: float):
    """Parameters after ``n_steps`` steps of both packages: each leaf
    within 1e-5 of its largest reference magnitude but for at most 0.1 %
    of its elements (or 4), and those within the most ``n_steps`` updates
    can differ by (2·lr each).  AdamW's first steps divide a gradient by
    its own magnitude (m̂/(√v̂ + ε)), so an element whose gradient sits at
    the float32 noise floor of two implementations moves by a different
    O(lr) in each, as does one whose int8-compressed value sits on a
    rounding boundary (measured: at most 2 elements of a leaf, up to
    2.3e-4 apart): the step's discontinuities, not a difference of the
    functions, which the optimizer and compression tests hold on equal
    inputs."""
    for (name, p), r in zip(tree_paths_and_leaves(port_tree),
                            tree_leaves(ref_tree)):
        d = (p.detach() - r).abs()
        loose = d > 1e-5 * r.abs().max()
        assert int(loose.sum()) <= max(1e-3 * d.numel(), 4), \
            (name, int(loose.sum()))
        assert float(d.max()) <= 2 * n_steps * lr, (name, float(d.max()))


@pytest.mark.parametrize("mode", ["plain", "accum", "compress"])
def test_train_step_matches_reference_jitted_step(mode):
    jcfg, pcfg = tiny()
    jm, pm = jax_build_model(jcfg), build_model(pcfg)
    jp = numpy_params(jm)
    comp = (CompressionConfig(enabled=True) if mode == "compress" else None)
    jcomp = (jax_compress.CompressionConfig(enabled=True)
             if mode == "compress" else None)
    accum = 2 if mode == "accum" else 1
    kw = dict(lr=3e-3, warmup_steps=2, total_steps=10)
    jstep = jax.jit(jax_loop.make_train_step(jm, jax_opt.OptConfig(**kw),
                                             jcomp, accum))
    pstep = make_train_step(pm, OptConfig(**kw), comp, accum)
    data = SyntheticLM(64, 32, 8, seed=3)
    jstate = jax_loop.init_opt_state(jax.tree.map(jnp.asarray, jp), jcomp)
    pp = unfrozen(jp)
    pstate = init_opt_state(pp, comp)
    jparams = jax.tree.map(jnp.asarray, jp)
    for step in range(3):
        batch = data.batch_at(step)
        jparams, jstate, jm_ = jstep(jparams, jstate, to_jax(batch))
        pp, pstate, pm_ = pstep(pp, pstate, to_torch(batch))
        assert abs(float(pm_["loss"]) - float(jm_["loss"])) \
            <= 1e-5 * abs(float(jm_["loss"])), step
        assert float(pm_["grad_norm"]) == pytest.approx(
            float(jm_["grad_norm"]), rel=1e-5)
    assert_steps_close(pp, params_from_reference(jax.device_get(jparams)),
                       3, kw["lr"])


@pytest.fixture(scope="module")
def tiny_model():
    return build_model(tiny()[1])


@pytest.fixture(scope="module")
def data():
    return SyntheticLM(64, 32, 8, seed=3)


def test_loss_decreases(tiny_model, data):
    out = train_loop(tiny_model, data, steps=40, device="cpu",
                     opt_cfg=OptConfig(lr=3e-3, warmup_steps=10,
                                       total_steps=40))
    first, last = out["losses"][0][1], out["losses"][-1][1]
    assert last < first - 0.5


def test_crash_resume_is_bit_exact(tiny_model, data, tmp_path):
    d = str(tmp_path / "ckpt")
    opt = OptConfig(lr=3e-3, warmup_steps=5, total_steps=30)
    kw = dict(steps=30, opt_cfg=opt, device="cpu", log_every=1)
    with pytest.raises(RuntimeError, match="injected crash"):
        train_loop(tiny_model, data, ckpt_dir=d, ckpt_every=10,
                   crash_at_step=15, **kw)
    assert latest_step(d) == 10
    resumed = train_loop(tiny_model, data, ckpt_dir=d, ckpt_every=10, **kw)
    ref = train_loop(tiny_model, data, **kw)
    assert resumed["losses"] == ref["losses"][10:]
    for a, b in zip(tree_leaves(resumed["params"]),
                    tree_leaves(ref["params"])):
        assert torch.equal(a, b)
    for a, b in zip(tree_leaves(resumed["opt_state"]),
                    tree_leaves(ref["opt_state"])):
        assert torch.equal(a, b)


def test_checkpoint_atomicity_and_shape_check(tmp_path):
    d = str(tmp_path / "c")
    tree = {"a": torch.arange(10, dtype=torch.float32),
            "b": {"c": torch.ones((3, 3), dtype=torch.float64)},
            "h": torch.linspace(-2, 2, 7).to(torch.bfloat16)}
    save_checkpoint(d, 5, tree, {"note": "x"})
    # a crashed (partial) save must not shadow the good one
    os.makedirs(os.path.join(d, ".tmp_step_00000007"))
    with open(os.path.join(d, ".tmp_step_00000007", "leaf_00000.npy"),
              "w") as f:
        f.write("garbage")
    assert latest_step(d) == 5
    like = {"a": torch.zeros(10), "b": {"c": torch.zeros((3, 3))},
            "h": torch.zeros(7, dtype=torch.bfloat16)}
    restored, meta, step = restore_checkpoint(d, 5, like)
    assert step == 5 and meta["note"] == "x"
    for key in ("a", "h"):
        assert restored[key].dtype == tree[key].dtype
        assert torch.equal(restored[key], tree[key])
    assert torch.equal(restored["b"]["c"], tree["b"]["c"])
    with pytest.raises(ValueError, match="shape mismatch"):
        restore_checkpoint(d, 5, {"a": torch.zeros(11),
                                  "b": {"c": torch.zeros((3, 3))},
                                  "h": torch.zeros(7)})


def test_checkpoint_names_params_and_optimizer_state(tiny_model, tmp_path):
    params = tiny_model.init(torch.Generator().manual_seed(0))
    state = init_opt_state(params, CompressionConfig(enabled=True))
    save_checkpoint(str(tmp_path), 1, (params, state))
    names = [n for n, _ in tree_paths_and_leaves((params, state))]
    assert names[0] == "0/embed" and "0/stack0.0.attn.wq" in names
    for group in ("adam/master", "adam/m", "adam/v", "feedback"):
        assert f"1/{group}/stack0.1.mlp.wd" in names
    assert "1/adam/step" in names
    restored, _, _ = restore_checkpoint(str(tmp_path), 1, (params, state))
    for a, b in zip(tree_leaves(restored), tree_leaves((params, state))):
        assert torch.equal(a, b)


def test_grad_accumulation_equivalence(tiny_model, data):
    params = tiny_model.init(torch.Generator().manual_seed(0))
    for p in tree_leaves(params):
        p.requires_grad_(True)
    batch = to_torch(data.batch_at(0))
    m = []
    for accum in (1, 2):
        state = init_opt_state(params)
        step = make_train_step(tiny_model, OptConfig(total_steps=10),
                               accum_steps=accum)
        saved = [p.detach().clone() for p in tree_leaves(params)]
        _, _, metrics = step(params, state, batch)
        m.append(metrics)
        with torch.no_grad():                 # undo the in-place update
            for p, s in zip(tree_leaves(params), saved):
                p.copy_(s)
    assert float(m[0]["loss"]) == pytest.approx(float(m[1]["loss"]),
                                                rel=1e-4)
    assert float(m[0]["grad_norm"]) == pytest.approx(
        float(m[1]["grad_norm"]), rel=1e-3)


def test_cli_prints_the_reference_lines(capsys, monkeypatch):
    argv = ["--arch", "qwen3-8b", "--smoke", "--steps", "3",
            "--seq-len", "16", "--batch", "2"]
    monkeypatch.setattr("sys.argv", ["train", *argv])
    jax_train_cli.main()
    want = capsys.readouterr().out.splitlines()
    train_cli.main([*argv, "--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    shape = re.compile(r"^(step +\d+  loss )\d+\.\d{4}$|"
                       r"^(done: 3 steps in )\d+\.\d+s \(\d+ tok/s\)$")
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        mg, mw = shape.match(g), shape.match(w)
        assert mg and mw and mg.groups() == mw.groups(), (g, w)


def test_cli_refuses_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(["--arch", "qwen3-8b", "--smoke", "--steps", "1"])


# ------------------------------------------------- attention's gradient --

BWD_CASES = {     # b, sq, sk, h, hkv, d, causal, window
    "causal-g1": (2, 24, 24, 3, 3, 16, True, 0),
    "window-g4": (1, 40, 40, 8, 2, 12, True, 7),
    "noncausal-sq<sk-g6": (2, 10, 29, 6, 1, 16, False, 0),
    "noncausal-sq>sk-g4": (1, 33, 17, 4, 1, 8, False, 0),
    "noncausal-window-g4": (1, 20, 26, 4, 1, 8, False, 5),
}


@pytest.mark.parametrize("case", list(BWD_CASES))
def test_flash_bwd_plain_matches_autograd_and_jax(case):
    b, sq, sk, h, hkv, d, causal, window = BWD_CASES[case]
    rng = np.random.default_rng(sq + sk)
    q, k, v, do = ((rng.standard_normal(shape)).astype(np.float32)
                   for shape in ((b, sq, h, d), (b, sk, hkv, d),
                                 (b, sk, hkv, d), (b, sq, h, d)))
    kw = dict(causal=causal, window=window)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    o = flash_attention_plain(tq, tk, tv, **kw)
    want = torch.autograd.grad(o, (tq, tk, tv), torch.from_numpy(do))
    got = flash_attention_bwd_plain(tq.detach(), tk.detach(), tv.detach(),
                                    o.detach(), torch.from_numpy(do), **kw)
    ref = jax.jit(lambda a, c, e, g: jax.vjp(
        lambda a, c, e: jax_attend_parallel(a, c, e, **kw), a, c, e)[1](g))(
        *map(jnp.asarray, (q, k, v, do)))
    for g, w, r in zip(got, want, ref):
        assert g.shape == w.shape and g.dtype == torch.float32
        assert leaf_err(g, w.numpy()) < 1e-6
        assert leaf_err(g, r) < 1e-5
