"""The scans keep every 16th chunk state for the backward, as the
reference's ``models/scan_config.chunk_scan_checkpointed`` does, where a
sequence has a whole number of at least two segments of 16 chunks; every
state elsewhere.

* (a) The port's CPU route under grad (``ops.wkv6_op`` / ``ops.ssd_op``:
  `wkv6.wkv6_checkpointed` / `ssd.ssd_checkpointed`) against
  ``jax.value_and_grad`` of the reference's ``models/ssm.{wkv6,ssd}_
  chunked``: S = 512 and 768 (two and three segments), 520 (ragged: whole)
  and 256 (short: whole), a few heads of 8 to 16, with and without an
  initial state and a final-state gradient; the loss and each gradient
  within 1e-4 of its largest reference magnitude
  (``test_torch_scan_bwd.py``'s tolerance).
* (b) That route equals the plain route without checkpointing (autograd
  through ``wkv6_plain`` / ``ssd_plain``) bit for bit, output and
  gradients, float32 and bf16 inputs.
* (c) What is saved: under ``saved_tensors_hooks`` the route saves n / 16
  state tensors where n >= 32 chunks and 16 divides n, at least n
  elsewhere; the dry run's probe (`launch/dryrun._SavedCounter`) counts
  each segment's inputs once and none of the backward's recompute.
* (d) The kernels' segment walk, replayed in float32 with the bf16 splits
  (the recipes of ``test_torch_scan_design.py`` and
  ``test_torch_scan_bwd.py``): from the last segment, its states
  recomputed from its checkpoint by the forward's recipe, the reverse pass
  carried in from the later segment, the chunk pass on the segment, the
  per-(batch, chunk) partials summed once at the end; bit for bit the
  whole-state recipe.

The card's side (the checkpoints the whole forward's states at every
16th chunk, the checkpointed backward kernels the whole-state ones bit for
bit and the plain backward within 1e-4 / 3e-2) is in
``test_torch_cuda.py``, which imports no JAX.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models import ssm as jax_ssm  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.ssd import ssd_bwd_plain  # noqa: E402
from repro_torch.kernels.wkv6 import (SEGMENT, _stride_of,  # noqa: E402
                                      kept_stride, wkv6_bwd_plain)
from test_torch_scan_bwd import (REF_TOL, SSD_NAMES,  # noqa: E402
                                 WKV6_NAMES, cotangents, ssd_bwd_recipe, t,
                                 within, wkv6_bwd_recipe)
from test_torch_scan_design import (CHUNK, ssd_inputs,  # noqa: E402
                                    ssd_recipe, wkv6_inputs, wkv6_recipe)

LENGTHS = [(512, True, True), (768, False, False), (520, True, False),
           (256, False, True)]


def _wkv6_case(s, state, dtype="float32", h=2, dk=16):
    args = wkv6_inputs(1, s, h, dk, dtype, s + dk, state=state)
    do, dst = cotangents((1, s, h, dk), (1, h, dk, dk), s, dtype)
    return args, do, dst


def _ssd_case(s, state, dtype="float32", h=3, hd=12, ds=10):
    args = ssd_inputs(1, s, h, hd, ds, dtype, s + hd, state=state)
    do, dst = cotangents((1, s, h, hd), (1, h, hd, ds), s, dtype)
    return args, do, dst


def _route_grads(op, targs, do, dst):
    """The op's output, final state and gradients of every input (s0
    None: none for it) under the cotangents."""
    leaves = [None if a is None else a.clone().requires_grad_(True)
              for a in targs]
    out, s_t = op(*leaves)
    outs, cots = [out], [t(do).to(out.dtype)]
    if dst is not None:
        outs.append(s_t)
        cots.append(t(dst))
    wanted = [a for a in leaves if a is not None]
    return out, s_t, torch.autograd.grad(outs, wanted, cots)


# ---------------- (a) against the reference ----------------

def _loss(out, s_t, do, dst):
    with torch.no_grad():
        total = (out * t(do)).sum()
        if dst is not None:
            total = total + (s_t * t(dst)).sum()
    return float(total)


def _jax_value_and_grad(fn, args, state_shape, do, dst):
    s0 = args[-1] if args[-1] is not None else np.zeros(state_shape,
                                                        np.float32)
    jargs = [jnp.asarray(a) for a in (*args[:-1], s0)]

    def loss(*a):
        out, s_t = fn(*a)
        total = jnp.sum(out * jnp.asarray(do))
        if dst is not None:
            total = total + jnp.sum(s_t * jnp.asarray(dst))
        return total

    value, grads = jax.value_and_grad(loss, argnums=tuple(
        range(len(jargs))))(*jargs)
    return float(value), [np.array(g) for g in grads]


@pytest.mark.parametrize("s,state,grad_st", LENGTHS)
def test_wkv6_route_matches_the_reference_value_and_grad(s, state, grad_st):
    args, do, dst = _wkv6_case(s, state)
    dst = dst if grad_st else None
    out, s_t, got = _route_grads(ops.wkv6_op, list(map(t, args)), do, dst)
    value = _loss(out, s_t, do, dst)
    want_value, want = _jax_value_and_grad(jax_ssm.wkv6_chunked, args,
                                           (1, 2, 16, 16), do, dst)
    assert abs(value - want_value) <= REF_TOL * max(abs(want_value), 1.0)
    for name, g, w in zip(WKV6_NAMES, got, want):
        within(g, torch.from_numpy(w), REF_TOL, name)


@pytest.mark.parametrize("s,state,grad_st", LENGTHS)
def test_ssd_route_matches_the_reference_value_and_grad(s, state, grad_st):
    args, do, dst = _ssd_case(s, state)
    dst = dst if grad_st else None
    out, s_t, got = _route_grads(ops.ssd_op, list(map(t, args)), do, dst)
    value = _loss(out, s_t, do, dst)
    want_value, want = _jax_value_and_grad(jax_ssm.ssd_chunked, args,
                                           (1, 3, 12, 10), do, dst)
    assert abs(value - want_value) <= REF_TOL * max(abs(want_value), 1.0)
    for name, g, w in zip(SSD_NAMES, got, want):
        within(g, torch.from_numpy(w), REF_TOL, name)


# ---------------- (b) bit for bit the unchecked plain route ----------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [512, 768])
def test_checkpointed_route_is_the_plain_route_bit_for_bit(s, dtype):
    for case, op, plain_bwd, cast in (
            (_wkv6_case, ops.wkv6_op, wkv6_bwd_plain, 3),
            (_ssd_case, ops.ssd_op, ssd_bwd_plain, 3)):
        args, do, dst = case(s, True, dtype)
        targs = [x.to(getattr(torch, dtype)) if i < cast else x
                 for i, x in enumerate(map(t, args))]
        out, s_t, got = _route_grads(op, targs, do, dst)
        with torch.no_grad():
            want_out, want_st = op(*targs)          # the plain forward
        want = plain_bwd(*targs, t(do).to(targs[0].dtype), t(dst))
        assert torch.equal(out, want_out) and torch.equal(s_t, want_st)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g, w)


# ---------------- (c) what is saved ----------------

def _saved_states(op, targs, state_shape):
    """The state-shaped float32 tensors the op saves for its backward."""
    leaves = [None if a is None else a.clone().requires_grad_(True)
              for a in targs]
    seen = []

    def pack(x):
        if tuple(x.shape) == state_shape and x.dtype == torch.float32:
            seen.append(x)
        return x

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda x: x):
        op(*leaves)
    return len(seen)


@pytest.mark.parametrize("s", [512, 768, 520, 256])
def test_the_route_saves_every_16th_state(s):
    n = -(-s // CHUNK)
    for case, op, shape in ((_wkv6_case, ops.wkv6_op, (1, 2, 16, 16)),
                            (_ssd_case, ops.ssd_op, (1, 3, 12, 10))):
        args, _, _ = case(s, True)
        saved = _saved_states(op, list(map(t, args)), shape)
        if kept_stride(n) == SEGMENT:
            assert saved == n // SEGMENT
        else:
            assert saved >= n


def test_kept_stride_follows_the_reference_condition():
    assert [kept_stride(n) for n in (0, 16, 31, 32, 33, 48, 256)] \
        == [1, 1, 1, 16, 1, 16, 16]
    states = torch.empty(1, 2, 16, 4, 4)
    assert _stride_of("f", states, 16) == 1
    assert _stride_of("f", torch.empty(1, 2, 2, 4, 4), 32) == SEGMENT
    assert _stride_of("f", torch.empty(1, 2, 32, 4, 4), 32) == 1
    for kept, n in ((2, 33), (1, 16), (3, 32)):
        with pytest.raises(ValueError):
            _stride_of("f", torch.empty(1, 2, kept, 4, 4), n)


def test_the_dry_runs_probe_counts_each_segments_inputs_once():
    """Inside a checkpointed layer (`scan_config.remat_probe`'s probe) the
    scan saves its inputs and the two segments' incoming states, each
    storage once; its backward's recompute saves nothing the probe or the
    outer hooks count."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.launch.dryrun import _SavedCounter

    args, do, _ = _wkv6_case(512, True)
    leaves = [t(a).requires_grad_(True) for a in args]
    with FlopCounterMode(display=False) as flops:
        saved = _SavedCounter([], flops)
        with saved.hooks():
            out, _ = saved.probe(ops.wkv6_op, leaves)
            torch.autograd.grad(out, leaves, t(do))
    state = 2 * 16 * 16 * 4
    inputs = sum(a.untyped_storage().nbytes() for a in leaves)
    assert saved.layer_peak == inputs + state      # s0 among the inputs
    assert not saved.outer


# ---------------- (d) the kernels' segment walk ----------------

def _wkv6_walk(r, k, v, log_w, u, ckpt, do, dst, dtype):
    """``csrc/wkv6_bwd.cu``'s checkpointed backward as recipes: each
    segment from the last, its states recomputed from its checkpoint."""
    b, s, h, dk = r.shape
    n_seg, tok = ckpt.shape[2], SEGMENT * CHUNK
    outs, carry = [None] * n_seg, dst
    for g in reversed(range(n_seg)):
        sl = slice(g * tok, (g + 1) * tok)
        seg = [x[:, sl] for x in (r, k, v, log_w)]
        states = torch.empty(b, h, SEGMENT, dk, dk)
        wkv6_recipe(*seg, u, ckpt[:, :, g], dtype, states=states)
        outs[g] = wkv6_bwd_recipe(*seg, u, states, do[:, sl], carry, dtype,
                                  partials=True)
        carry = outs[g][5]
    cat = [torch.cat([o[i] for o in outs], 1) for i in range(5)]
    n = n_seg * SEGMENT
    return (*cat[:4], cat[4].reshape(b * n, h, dk).sum(0), carry)


def _ssd_walk(x, bm, cm, dt, a_log, d_skip, ckpt, dy, dst, dtype):
    b, s, h, hd = x.shape
    n_seg, tok = ckpt.shape[2], SEGMENT * CHUNK
    outs, carry = [None] * n_seg, dst
    for g in reversed(range(n_seg)):
        sl = slice(g * tok, (g + 1) * tok)
        seg = [z[:, sl] for z in (x, bm, cm, dt)]
        states = torch.empty(b, h, SEGMENT, hd, bm.shape[-1])
        ssd_recipe(*seg, a_log, d_skip, ckpt[:, :, g], dtype, states=states)
        outs[g] = ssd_bwd_recipe(*seg, a_log, d_skip, states, dy[:, sl],
                                 carry, dtype, partials=True)
        carry = outs[g][6]
    cat = [torch.cat([o[i] for o in outs], 1) for i in range(6)]
    n = n_seg * SEGMENT
    return (*cat[:4], cat[4].reshape(b * n, h).sum(0),
            cat[5].reshape(b * n, h).sum(0), carry)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,state,grad_st", [(512, True, True),
                                             (768, False, False)])
def test_the_segment_walk_is_the_whole_recipe_bit_for_bit(s, state, grad_st,
                                                          dtype):
    n = s // CHUNK
    args, do, dst = _wkv6_case(s, state, dtype, h=3, dk=16)
    dst = t(dst) if grad_st else None
    targs = list(map(t, args))
    states = torch.empty(1, 3, n, 16, 16)
    wkv6_recipe(*targs, dtype, states=states)
    whole = wkv6_bwd_recipe(*targs[:5], states, t(do), dst, dtype)
    walk = _wkv6_walk(*targs[:5], states[:, :, ::SEGMENT], t(do), dst, dtype)
    for name, a, w in zip(WKV6_NAMES, walk, whole):
        assert torch.equal(a, w), name

    args, do, dst = _ssd_case(s, state, dtype, h=9, hd=16, ds=16)
    dst = t(dst) if grad_st else None
    targs = list(map(t, args))
    states = torch.empty(1, 9, n, 16, 16)
    ssd_recipe(*targs, dtype, states=states)
    whole = ssd_bwd_recipe(*targs[:6], states, t(do), dst, dtype)
    walk = _ssd_walk(*targs[:6], states[:, :, ::SEGMENT], t(do), dst, dtype)
    for name, a, w in zip(SSD_NAMES, walk, whole):
        assert torch.equal(a, w), name
