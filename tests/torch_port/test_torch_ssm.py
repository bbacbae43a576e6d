"""The port's recurrences, mixers and blocks against the JAX package.

* Kernels' plain versions: ``wkv6_plain`` / ``ssd_plain`` from a zero
  state against the Pallas ``wkv6`` / ``ssd`` in interpret mode (as
  ``tests/test_kernels.py`` runs them) and against the stepwise oracles
  ``wkv6_ref`` / ``ssd_ref`` of both packages, at the reference's shapes
  including S = 35 and 37 (not multiples of the chunk of 16); from a
  nonzero state against ``repro.models.ssm.wkv6_chunked`` /
  ``ssd_chunked``.  Tolerance 1e-3 absolute, the reference's own.
* Mixers and blocks at ``scaled()`` widths in float32, parallel and step
  forms, with nonzero incoming states: RWKV-6 time and channel mix, the
  Mamba-2 mixer (its width-4 conv state included) and zamba2's shared
  attention block.  The same float32 math with sums in another order:
  within 1e-5 of the output's max (2e-5 for the parallel Mamba-2 mixer,
  whose chunked scan adds up over more terms).

Parameters are drawn with numpy in the reference's layout and handed to
both packages; inputs too.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.kernels import ref as jax_ref  # noqa: E402
from repro.kernels.ssd import ssd as pallas_ssd  # noqa: E402
from repro.kernels.wkv6 import wkv6 as pallas_wkv6  # noqa: E402
from repro.models import blocks as jax_blocks  # noqa: E402
from repro.models import ssm as jax_ssm  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.ref import ssd_ref, wkv6_ref  # noqa: E402
from repro_torch.kernels.ssd import ssd_plain  # noqa: E402
from repro_torch.kernels.wkv6 import wkv6_plain  # noqa: E402
from repro_torch.models import blocks, ssm  # noqa: E402
from repro_torch.models.carry import tensor_from_numpy  # noqa: E402

KERNEL_TOL = 1e-3


def t(a):
    return torch.from_numpy(np.array(a))


def max_err(port, ref) -> float:
    return float(np.max(np.abs(np.asarray(port, np.float32)
                               - np.asarray(ref, np.float32))))


def rel_err(port, ref) -> float:
    ref = np.asarray(ref, np.float32)
    return max_err(port, ref) / (float(np.max(np.abs(ref))) + 1e-9)


# ---------------- the recurrences ----------------

def wkv6_inputs(b, s, h, dk, seed, state=False):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((b, s, h, dk)).astype(np.float32)
               for _ in range(3))
    lw = np.clip(-np.exp(rng.standard_normal((b, s, h, dk))), -4.0,
                 -1e-3).astype(np.float32)
    u = rng.standard_normal((h, dk)).astype(np.float32)
    s0 = (rng.standard_normal((b, h, dk, dk)) if state
          else np.zeros((b, h, dk, dk))).astype(np.float32)
    return r, k, v, lw, u, s0


def ssd_inputs(b, s, h, hd, ds, seed, state=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, hd)).astype(np.float32)
    bm = rng.standard_normal((b, s, ds)).astype(np.float32)
    cm = rng.standard_normal((b, s, ds)).astype(np.float32)
    dt = (np.abs(rng.standard_normal((b, s, h))) * 0.5).astype(np.float32)
    a_log = (rng.standard_normal(h) * 0.3).astype(np.float32)
    dsk = rng.standard_normal(h).astype(np.float32)
    s0 = (rng.standard_normal((b, h, hd, ds)) if state
          else np.zeros((b, h, hd, ds))).astype(np.float32)
    return x, bm, cm, dt, a_log, dsk, s0


@pytest.mark.parametrize("b,s,h,dk", [(2, 48, 3, 16), (1, 35, 2, 32),
                                      (1, 37, 2, 8)])
def test_wkv6_plain_matches_pallas_and_oracles(b, s, h, dk):
    args = wkv6_inputs(b, s, h, dk, s)
    o, s_t = wkv6_plain(*map(t, args[:5]))          # zero state
    for want_o, want_s in (pallas_wkv6(*args[:5]), jax_ref.wkv6_ref(*args),
                           wkv6_ref(*map(t, args))):
        assert max_err(o, want_o) < KERNEL_TOL
        assert max_err(s_t, want_s) < KERNEL_TOL
    assert o.dtype == torch.float32 and s_t.dtype == torch.float32


@pytest.mark.parametrize("b,s,h,hd,ds", [(2, 48, 3, 16, 8), (1, 37, 2, 32, 16),
                                         (1, 35, 2, 16, 8)])
def test_ssd_plain_matches_pallas_and_oracles(b, s, h, hd, ds):
    args = ssd_inputs(b, s, h, hd, ds, s)
    y, s_t = ssd_plain(*map(t, args[:6]))           # zero state
    for want_y, want_s in (pallas_ssd(*args[:6]), jax_ref.ssd_ref(*args),
                           ssd_ref(*map(t, args))):
        assert max_err(y, want_y) < KERNEL_TOL
        assert max_err(s_t, want_s) < KERNEL_TOL


@pytest.mark.parametrize("s", [35, 48])
def test_plain_versions_from_a_state_match_the_chunked_forms(s):
    """A nonzero initial state (the extend path) against the reference
    model's chunked forms and the port's stepwise oracles; the ops route
    CPU tensors to the plain versions without counting a launch."""
    args = wkv6_inputs(1, s, 2, 16, s, state=True)
    ops.reset_launch_counts()
    o, s_t = ops.wkv6_op(*map(t, args))
    for want_o, want_s in (run(jax_ssm.wkv6_chunked, *args),
                           wkv6_ref(*map(t, args))):
        assert max_err(o, want_o) < KERNEL_TOL
        assert max_err(s_t, want_s) < KERNEL_TOL
    args = ssd_inputs(1, s, 3, 16, 8, s, state=True)
    y, s_t = ops.ssd_op(*map(t, args))
    for want_y, want_s in (run(jax_ssm.ssd_chunked, *args),
                           ssd_ref(*map(t, args))):
        assert max_err(y, want_y) < KERNEL_TOL
        assert max_err(s_t, want_s) < KERNEL_TOL
    assert ops.launch_counts()["wkv6"] == ops.launch_counts()["ssd"] == 0


def test_plain_versions_keep_the_input_dtype():
    """bf16 inputs give a bf16 output and a float32 state (the kernels'
    contract); the float32 math matches a float32 run on the same values."""
    args = [t(a) for a in wkv6_inputs(1, 21, 2, 8, 0)]
    lo = [a.to(torch.bfloat16) for a in args[:3]]
    o, s_t = wkv6_plain(*lo, *args[3:])
    o32, s32 = wkv6_plain(*(a.float() for a in lo), *args[3:])
    assert o.dtype == torch.bfloat16 and s_t.dtype == torch.float32
    assert torch.equal(o, o32.to(torch.bfloat16)) and torch.equal(s_t, s32)
    args = [t(a) for a in ssd_inputs(1, 21, 2, 8, 4, 0)]
    lo = [a.to(torch.bfloat16) for a in args[:3]]
    y, s_t = ssd_plain(*lo, *args[3:])
    assert y.dtype == torch.bfloat16 and s_t.dtype == torch.float32


def test_kernel_wrappers_and_ops_never_fall_back():
    """The CUDA wrappers refuse CPU tensors (they launch or raise; nothing
    falls back to a plain version), and the ops refuse a device that has
    neither a kernel nor a plain version."""
    from repro_torch.kernels.ssd import ssd_cuda
    from repro_torch.kernels.wkv6 import wkv6_cuda

    wargs = [t(a) for a in wkv6_inputs(1, 5, 2, 8, 0)]
    sargs = [t(a) for a in ssd_inputs(1, 5, 2, 8, 4, 0)]
    with pytest.raises(ValueError, match="CUDA tensors"):
        wkv6_cuda(*wargs)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ssd_cuda(*sargs)
    with pytest.raises(ValueError, match="no kernel or plain version"):
        ops.wkv6_op(*(a.to("meta") for a in wargs))
    with pytest.raises(ValueError, match="no kernel or plain version"):
        ops.ssd_op(*(a.to("meta") for a in sargs))


# ---------------- mixers and blocks ----------------

def draw_params(tree, rng):
    """A reference parameter tree redrawn with numpy, so that no weight is
    a constant (the reference inits zero mixes and LoRA halves): arrays of
    two or more dims normal with std 1/sqrt(their second-last dim), vectors
    their init plus noise of std 0.1 (ones stay near 1, the decay base w0
    near -0.6)."""
    def draw(leaf):
        a = np.asarray(leaf, np.float32)
        noise = rng.standard_normal(a.shape).astype(np.float32)
        if a.ndim >= 2:
            return noise / np.float32(np.sqrt(a.shape[-2]))
        return a + np.float32(0.1) * noise
    return jax.tree.map(draw, tree)


def to_port(tree):
    return jax.tree.map(lambda a: tensor_from_numpy(a), tree)


def run(fn, *args, **static):
    """A reference function under ``jax.jit`` (eager JAX dispatches op by
    op, which is slow on the CPU); keyword arguments are closed over."""
    return jax.jit(lambda *a: fn(*a, **static))(*args)


@pytest.fixture(scope="module")
def rwkv_case():
    jcfg = jax_get_config("rwkv6-3b").scaled(dtype="float32")
    pcfg = get_config("rwkv6-3b").scaled(dtype="float32")
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(pcfg)
    rng = np.random.default_rng(0)
    jp = draw_params(jax.device_get(run(
        jax_blocks.rwkv_block_init, jax.random.PRNGKey(0), cfg=jcfg,
        dtype=jnp.float32)), rng)
    return jcfg, pcfg, jp, to_port(jp), rng


def test_rwkv6_mixers_match_jax(rwkv_case):
    jcfg, pcfg, jp, pp, rng = rwkv_case
    b, s, d, h, hd = 2, 21, pcfg.d_model, pcfg.ssm_heads, pcfg.ssm_state
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    shift = rng.standard_normal((b, d)).astype(np.float32)
    wkv = (0.3 * rng.standard_normal((b, h, hd, hd))).astype(np.float32)
    x1 = x[:, 0]
    for xx, parallel in ((x, True), (x1, False)):
        jo, (jsh, jst) = run(
            lambda p, xx, sh, st, par=parallel: jax_ssm.rwkv6_time_mix(
                p, xx, jcfg, shift_state=sh, wkv_state=st, parallel=par),
            jp["mix"], xx, shift, wkv)
        po, (psh, pst) = ssm.rwkv6_time_mix(
            pp["mix"], t(xx), pcfg, shift_state=t(shift), wkv_state=t(wkv),
            parallel=parallel)
        assert rel_err(po, jo) < 1e-5 and rel_err(pst, jst) < 1e-5
        assert torch.equal(psh, t(np.asarray(jsh)))
        jo, _ = run(
            lambda p, xx, sh, par=parallel: jax_ssm.rwkv6_channel_mix(
                p, xx, shift_state=sh, parallel=par), jp["mix"], xx, shift)
        po, _ = ssm.rwkv6_channel_mix(pp["mix"], t(xx), shift_state=t(shift),
                                      parallel=parallel)
        assert rel_err(po, jo) < 1e-5
    # whole blocks, parallel then step from the state it left
    state = (shift, wkv, shift[::-1].copy())
    jy, jst = run(lambda p, x, st: jax_blocks.rwkv_block_parallel(
        p, x, jcfg, state=st), jp, x, state)
    py, pst = blocks.rwkv_block_parallel(pp, t(x), pcfg,
                                         state=tuple(map(t, state)))
    assert rel_err(py, jy) < 1e-5
    jy, _ = run(lambda p, x, st: jax_blocks.rwkv_block_step(
        p, x, jcfg, st), jp, x1, jst)
    py, _ = blocks.rwkv_block_step(pp, t(x1), pcfg, pst)
    assert rel_err(py, jy) < 1e-5


@pytest.fixture(scope="module")
def zamba_case():
    jcfg = jax_get_config("zamba2-7b").scaled(dtype="float32")
    pcfg = get_config("zamba2-7b").scaled(dtype="float32")
    rng = np.random.default_rng(1)
    jm = draw_params(jax.device_get(run(
        jax_blocks.mamba_block_init, jax.random.PRNGKey(1), cfg=jcfg,
        dtype=jnp.float32)), rng)
    js = draw_params(jax.device_get(run(
        jax_blocks.shared_attn_init, jax.random.PRNGKey(2), cfg=jcfg,
        dtype=jnp.float32, n_groups=2)), rng)
    return jcfg, pcfg, jm, js, rng


def test_mamba2_mixer_and_block_match_jax(zamba_case):
    jcfg, pcfg, jp, _, rng = zamba_case
    pp = to_port(jp)
    b, s, d = 2, 37, pcfg.d_model
    di, h, ds = 2 * d, pcfg.ssm_heads, pcfg.ssm_state
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    conv = rng.standard_normal((b, 3, di)).astype(np.float32)
    st = (0.3 * rng.standard_normal((b, h, di // h, ds))).astype(np.float32)
    for xx, parallel, tol in ((x, True, 2e-5), (x[:, 0], False, 1e-5)):
        jo, (jc, js) = run(
            lambda p, xx, c, st, par=parallel: jax_ssm.mamba2_block(
                p, xx, jcfg, conv_state=c, ssm_state=st, parallel=par),
            jp["mix"], xx, conv, st)
        po, (pc, ps) = ssm.mamba2_block(pp["mix"], t(xx), pcfg,
                                        conv_state=t(conv), ssm_state=t(st),
                                        parallel=parallel)
        assert rel_err(po, jo) < tol and rel_err(ps, js) < tol
        assert rel_err(pc, jc) < 1e-5
    jy, jst = run(jax_blocks.mamba_block_parallel, jp, x, cfg=jcfg)
    py, pst = blocks.mamba_block_parallel(pp, t(x), pcfg)
    assert rel_err(py, jy) < 2e-5
    jy, _ = run(lambda p, x, st: jax_blocks.mamba_block_step(
        p, x, jcfg, st), jp, x[:, 0], jst)
    py, _ = blocks.mamba_block_step(pp, t(x[:, 0]), pcfg, pst)
    assert rel_err(py, jy) < 1e-5


def test_shared_attention_block_matches_jax(zamba_case):
    """Parallel over a prompt, then one decode step against the cache that
    prefill lays out, through each group's own LoRA."""
    from repro.models import attention as jax_attn
    from repro_torch.models import attention

    jcfg, pcfg, _, jp, rng = zamba_case
    pp = {"block": to_port(jp["block"]),
          "lora": [to_port(jax.tree.map(lambda a, g=g: a[g], jp["lora"]))
                   for g in range(2)]}
    b, s, m = 2, 19, 32
    x = rng.standard_normal((b, s, pcfg.d_model)).astype(np.float32)
    lens = np.full((b,), s, np.int32)
    x1 = x[:, -1]

    def jax_side(p, lora, x, x1, lens):
        y, (k, v) = jax_blocks.shared_attn_parallel(p, lora, x, jcfg)
        kc, vc, sp = jax_attn.prefill_cache_layout(k, v, lens, m)
        y1, nc = jax_blocks.shared_attn_decode(
            p, lora, x1, {"k": kc, "v": vc, "slot_pos": sp, "pos": lens},
            jcfg)
        return y, k, y1, nc

    for g in range(2):
        lora_j = jax.tree.map(lambda a, g=g: a[g], jp["lora"])
        jy, jk, jy1, jn = run(jax_side, jp, lora_j, x, x1, lens)
        py, (pk, pv) = blocks.shared_attn_parallel(pp, pp["lora"][g], t(x),
                                                   pcfg)
        assert rel_err(py, jy) < 1e-5 and rel_err(pk, jk) < 1e-5
        pkc, pvc, psp = attention.prefill_cache_layout(pk, pv, t(lens), m)
        pcl = {"k": pkc, "v": pvc, "slot_pos": psp, "pos": t(lens)}
        py1, pn = blocks.shared_attn_decode(pp, pp["lora"][g], t(x1), pcl,
                                            pcfg)
        assert rel_err(py1, jy1) < 1e-5 and rel_err(pn["k"], jn["k"]) < 1e-5
        assert torch.equal(pn["slot_pos"], t(np.asarray(jn["slot_pos"])))
