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
* (d) The kernels' backward from the checkpoints, replayed in float32
  with the bf16 splits (the recipes of ``test_torch_scan_design.py`` and
  ``test_torch_scan_bwd.py``) by the plan the C call issues
  (`wkv6.checkpoint_plan`): each segment's states recomputed from its
  checkpoint by a state-only recipe (the state update's operands alone)
  into one of two buffers used in turn, its reverse pass carried in from
  the later segment into one of two dS buffers, its chunk pass on them,
  the per-(batch, chunk) partials summed once at the end; bit for bit the
  whole-state recipe, in the plan's issue order and in orders the card
  may run it (each stream in order, a wait after the record it waits
  for).  The plan itself, under CUDA's stream and event rules: each
  segment's states and dS are written before its chunk pass reads them,
  and no buffer is rewritten before the chunk pass that read it is done.

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
from repro_torch.kernels import wkv6 as wkv6_mod  # noqa: E402
from repro_torch.kernels.wkv6 import (SEGMENT, _stride_of,  # noqa: E402
                                      checkpoint_plan, kept_stride,
                                      wkv6_bwd_plain)
from test_torch_scan_bwd import (REF_TOL, SSD_NAMES,  # noqa: E402
                                 WKV6_NAMES, cotangents, ssd_bwd_recipe, t,
                                 within, wkv6_bwd_recipe)
from test_torch_scan_design import (CHUNK, PARTS, SLICE,  # noqa: E402
                                    chunks, parts, pmm, ssd_inputs,
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
    from repro_torch.launch.traffic import ByteCounter

    args, do, _ = _wkv6_case(512, True)
    leaves = [t(a).requires_grad_(True) for a in args]
    with FlopCounterMode(display=False) as flops:
        saved = _SavedCounter([], flops, ByteCounter())
        with saved.hooks():
            out, _ = saved.probe(ops.wkv6_op, leaves)
            torch.autograd.grad(out, leaves, t(do))
    state = 2 * 16 * 16 * 4
    inputs = sum(a.untyped_storage().nbytes() for a in leaves)
    assert saved.layer_peak == inputs + state      # s0 among the inputs
    assert not saved.outer


# ---------------- (d) the kernels' backward from the checkpoints -------

def _wkv6_state_recipe(k, v, log_w, s0, dtype, states):
    """The incoming state of every chunk into ``states`` [B, H, n, dk, dk]
    as ``wkv6_recompute_intra_kernel`` and ``wkv6_recompute_state_kernel``
    compute them: of pass A only k_dec and exp(p_last), of pass B only the
    state update."""
    ni, nc = PARTS[dtype]
    b, s, h, dk = k.shape
    kc, vc, lc = (chunks(x, s) for x in (k, v, log_w))
    p = torch.cumsum(lc, dim=2)
    kdec = parts(kc * torch.exp(p[:, :, -1:] - p), nc)
    el = torch.exp(p[:, :, -1])                          # [B, n, H, d]
    vp = parts(vc, ni)
    for j0 in range(0, dk, SLICE):
        sl = slice(j0, j0 + SLICE)
        st = s0[:, :, :, sl].transpose(2, 3)             # [B, H, j, d]
        for c in range(kc.shape[1]):
            states[:, :, c, :, sl] = st.transpose(2, 3)
            st = st * el[:, c, :, None, :] + pmm(
                "bshj,bshd->bhjd", [x[:, c, :, :, sl] for x in vp],
                [x[:, c] for x in kdec])


def _ssd_state_recipe(x, bm, dt, a_log, s0, dtype, states):
    """The incoming state of every chunk into ``states`` [B, H, n, hd, ds]
    as ``ssd_recompute_intra_kernel`` and ``ssd_recompute_state_kernel``
    compute them: of pass A only w and exp(p_last), of pass B only the
    state update."""
    ni, nc = PARTS[dtype]
    b, s, h, hd = x.shape
    xc, bc, dtc = chunks(x, s), chunks(bm, s), chunks(dt, s)
    p = torch.cumsum(-torch.exp(a_log)[None, None, None, :] * dtc, dim=2)
    p_last = p[:, :, -1:, :]
    x_f = sum(parts(xc, ni))
    w = torch.exp(torch.clamp(p_last - p, max=0.0)) * dtc
    el = torch.exp(p_last[:, :, 0, :])
    for i0 in range(0, hd, SLICE):
        sl = slice(i0, i0 + SLICE)
        st = s0[:, :, sl]                                # [B, H, 16, ds]
        for c in range(xc.shape[1]):
            states[:, :, c, sl] = st
            wx = w[:, c, :, :, None] * x_f[:, c, :, :, sl]
            st = st * el[:, c, :, None, None] \
                + pmm("bshi,bsn->bhin", parts(wx, nc), parts(bc[:, c], ni))


def _plan_deps(rows):
    """For each row of a plan, the rows that must be done before it runs,
    under CUDA's rules for rows issued in order: a row follows the rows
    before it on its stream; a wait follows the last record of its event
    issued before it (none: no wait), and a record covers what its stream
    has done by then."""
    last, deps = {}, []
    recorded = {}
    for i, (op, _, s, e) in enumerate(rows):
        deps.append({last[s]} if s in last else set())
        if op == wkv6_mod.WAIT and e in recorded:
            deps[i].add(recorded[e])
        if op == wkv6_mod.RECORD:
            recorded[e] = i
        last[s] = i
    return deps


def _happens_before(rows):
    """For each row, the set of rows that are done before it runs (the
    transitive closure of `_plan_deps`)."""
    before = []
    for d in _plan_deps(rows):
        before.append(set(d).union(*(before[j] for j in d)))
    return before


def _orders(rows):
    """Orders in which the card may run the plan's rows: as issued, and
    the two greedy orders that run, of the rows whose dependencies are
    done, first those on the recompute's and reverse passes' streams (the
    walks as early as the plan lets them) or first the others (the walks
    as late as it lets them)."""
    deps = _plan_deps(rows)
    yield list(range(len(rows)))
    walks = (wkv6_mod.RECOMPUTE_STREAM, wkv6_mod.REVERSE_STREAM)
    for early in (True, False):
        done, order = set(), []
        while len(order) < len(rows):
            ready = [i for i in range(len(rows))
                     if i not in done and deps[i] <= done]
            i = min(ready, key=lambda i: ((rows[i][2] in walks) != early, i))
            done.add(i)
            order.append(i)
        yield order


def _replay(n_seg, order, recompute, reverse, chunk, dst):
    """The plan's ops in ``order`` over two state buffers and two dS
    buffers used in turn (segment g's in g % 2) and the two carries of dS
    between segments: ``recompute(g)`` the segment's states,
    ``reverse(g, carry_in)`` its gradient down to the segment's start,
    ``chunk(g, states, carry_in)`` its outputs.  Returns each segment's
    outputs and ds0."""
    rows = checkpoint_plan(n_seg)
    states, ds_in, carry = [None, None], [None, None], [None, None]
    outs, ds0 = [None] * n_seg, None
    for i in order:
        op, g, _, _ = rows[i]
        if op == wkv6_mod.RECOMPUTE:
            states[g % 2] = recompute(g)
        elif op == wkv6_mod.REVERSE:
            ds_in[g % 2] = dst if g == n_seg - 1 else carry[(g + 1) % 2]
            out = reverse(g, ds_in[g % 2])
            if g == 0:
                ds0 = out
            else:
                carry[g % 2] = out
        elif op == wkv6_mod.CHUNK_PASS:
            outs[g] = chunk(g, states[g % 2], ds_in[g % 2])
    return outs, ds0


def _wkv6_walk(r, k, v, log_w, u, ckpt, do, dst, dtype, order=None):
    """``csrc/wkv6_bwd.cu``'s backward from the checkpoints as recipes, in
    the plan's ``order`` (None: as issued)."""
    b, s, h, dk = r.shape
    n_seg, tok = ckpt.shape[2], SEGMENT * CHUNK

    def seg(g, *xs):
        return [x[:, g * tok:(g + 1) * tok] for x in xs]

    def recompute(g):
        states = torch.full((b, h, SEGMENT, dk, dk), float("nan"))
        _wkv6_state_recipe(*seg(g, k, v, log_w), ckpt[:, :, g], dtype,
                           states)
        return states

    def reverse(g, carry):    # the reverse pass alone reads no state
        return wkv6_bwd_recipe(*seg(g, r, k, v, log_w), u,
                               torch.zeros(b, h, SEGMENT, dk, dk),
                               *seg(g, do), carry, dtype)[5]

    def chunk(g, states, carry):
        return wkv6_bwd_recipe(*seg(g, r, k, v, log_w), u, states,
                               *seg(g, do), carry, dtype, partials=True)

    order = order or range(len(checkpoint_plan(n_seg)))
    outs, ds0 = _replay(n_seg, order, recompute, reverse, chunk, dst)
    cat = [torch.cat([o[i] for o in outs], 1) for i in range(5)]
    n = n_seg * SEGMENT
    return (*cat[:4], cat[4].reshape(b * n, h, dk).sum(0), ds0)


def _ssd_walk(x, bm, cm, dt, a_log, d_skip, ckpt, dy, dst, dtype,
              order=None):
    """``csrc/ssd_bwd.cu``'s backward from the checkpoints as recipes, in
    the plan's ``order`` (None: as issued)."""
    b, s, h, hd = x.shape
    n_seg, tok = ckpt.shape[2], SEGMENT * CHUNK

    def seg(g, *zs):
        return [z[:, g * tok:(g + 1) * tok] for z in zs]

    def recompute(g):
        states = torch.full((b, h, SEGMENT, hd, bm.shape[-1]), float("nan"))
        sx, sb, sdt = seg(g, x, bm, dt)
        _ssd_state_recipe(sx, sb, sdt, a_log, ckpt[:, :, g], dtype, states)
        return states

    def reverse(g, carry):    # the reverse pass alone reads no state
        return ssd_bwd_recipe(*seg(g, x, bm, cm, dt), a_log, d_skip,
                              torch.zeros(b, h, SEGMENT, hd, bm.shape[-1]),
                              *seg(g, dy), carry, dtype)[6]

    def chunk(g, states, carry):
        return ssd_bwd_recipe(*seg(g, x, bm, cm, dt), a_log, d_skip, states,
                              *seg(g, dy), carry, dtype, partials=True)

    order = order or range(len(checkpoint_plan(n_seg)))
    outs, ds0 = _replay(n_seg, order, recompute, reverse, chunk, dst)
    cat = [torch.cat([o[i] for o in outs], 1) for i in range(6)]
    n = n_seg * SEGMENT
    return (*cat[:4], cat[4].reshape(b * n, h).sum(0),
            cat[5].reshape(b * n, h).sum(0), ds0)


def _wkv6_whole(s, state, grad_st, dtype):
    """The inputs of a WKV6 case, its checkpoints and the whole-state
    recipe's gradients."""
    n = s // CHUNK
    args, do, dst = _wkv6_case(s, state, dtype, h=3, dk=16)
    dst = t(dst) if grad_st else None
    targs = list(map(t, args))
    states = torch.empty(1, 3, n, 16, 16)
    wkv6_recipe(*targs, dtype, states=states)
    whole = wkv6_bwd_recipe(*targs[:5], states, t(do), dst, dtype)
    return (*targs[:5], states[:, :, ::SEGMENT], t(do), dst), whole


def _ssd_whole(s, state, grad_st, dtype):
    """The inputs of an SSD case, its checkpoints and the whole-state
    recipe's gradients."""
    n = s // CHUNK
    args, do, dst = _ssd_case(s, state, dtype, h=9, hd=16, ds=16)
    dst = t(dst) if grad_st else None
    targs = list(map(t, args))
    states = torch.empty(1, 9, n, 16, 16)
    ssd_recipe(*targs, dtype, states=states)
    whole = ssd_bwd_recipe(*targs[:6], states, t(do), dst, dtype)
    return (*targs[:6], states[:, :, ::SEGMENT], t(do), dst), whole


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,state,grad_st", [(512, True, True),
                                             (768, False, False)])
def test_the_segment_walk_is_the_whole_recipe_bit_for_bit(s, state, grad_st,
                                                          dtype):
    walk_args, whole = _wkv6_whole(s, state, grad_st, dtype)
    walk = _wkv6_walk(*walk_args, dtype)
    for name, a, w in zip(WKV6_NAMES, walk, whole):
        assert torch.equal(a, w), name
    walk_args, whole = _ssd_whole(s, state, grad_st, dtype)
    walk = _ssd_walk(*walk_args, dtype)
    for name, a, w in zip(SSD_NAMES, walk, whole):
        assert torch.equal(a, w), name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_the_plan_in_each_order_the_card_may_run_it_is_the_whole_recipe(
        dtype):
    """At 768 tokens (three segments: segment 0 reuses segment 2's
    buffers), the plan run with the walks as early and as late as its
    waits let them: the same bits as the whole-state recipe.  Run early,
    segment 0's recompute and reverse pass come before segment 1's chunk
    pass, into the buffers segment 2's chunk pass read."""
    rows = checkpoint_plan(3)
    orders = list(_orders(rows))
    at = {(op, g): i for i, (op, g, _, _) in enumerate(rows)}
    chunk1 = at[wkv6_mod.CHUNK_PASS, 1]
    for op in (wkv6_mod.RECOMPUTE, wkv6_mod.REVERSE):
        assert orders[1].index(at[op, 0]) < orders[1].index(chunk1)
        assert orders[0].index(at[op, 0]) > orders[0].index(chunk1)
    for make, walk, names in ((_wkv6_whole, _wkv6_walk, WKV6_NAMES),
                              (_ssd_whole, _ssd_walk, SSD_NAMES)):
        walk_args, whole = make(768, True, True, dtype)
        for order in orders[1:]:
            got = walk(*walk_args, dtype, order=order)
            for name, a, w in zip(names, got, whole):
                assert torch.equal(a, w), name


def _plan_hazards(rows, n_seg):
    """What the plan leaves unordered that must be ordered: a chunk pass
    not after its segment's recompute and reverse pass, a buffer rewritten
    (segment g's recompute or reverse pass) before the chunk pass of
    segment g + 2 that read it is done, a reverse pass not after the later
    segment's (its carry), the sums not after every chunk pass, the
    caller's last row not after every other row."""
    before = _happens_before(rows)
    at = {(op, g): i for i, (op, g, _, _) in enumerate(rows)
          if op not in (wkv6_mod.RECORD, wkv6_mod.WAIT)}
    rc, rv, ch = wkv6_mod.RECOMPUTE, wkv6_mod.REVERSE, wkv6_mod.CHUNK_PASS
    bad = []
    for g in range(n_seg):
        for op in (rc, rv):
            if at[op, g] not in before[at[ch, g]]:
                bad.append(("read before written", op, g))
            if g + 2 < n_seg and at[ch, g + 2] not in before[at[op, g]]:
                bad.append(("rewritten while read", op, g))
        if g + 1 < n_seg and at[rv, g + 1] not in before[at[rv, g]]:
            bad.append(("carry", g))
        if at[ch, g] not in before[at[wkv6_mod.SUMS, 0]]:
            bad.append(("sums", g))
    final = max(i for i, row in enumerate(rows)
                if row[2] == wkv6_mod.CALLER)
    if not all(i in before[final] or i == final for i in range(len(rows))
               if rows[i][0] not in (wkv6_mod.RECORD, wkv6_mod.WAIT)):
        bad.append(("not joined",))
    return bad


@pytest.mark.parametrize("n_seg", [2, 3, 8, 16])
def test_the_plan_orders_every_buffer_use(n_seg):
    """The rows the C call issues (recorded as issued, under CUDA's stream
    and event rules): each segment's states and dS are written before its
    chunk pass reads them, no buffer of the two is rewritten while a read
    recorded before is pending, the carries run in turn, and the caller's
    stream ends after everything; each segment's recompute and reverse
    pass are on side streams of their own, its chunk pass on the caller's
    stream or a third (even / odd segments)."""
    rows = checkpoint_plan(n_seg)
    assert _plan_hazards(rows, n_seg) == []
    ops = [row for row in rows if row[0] not in (wkv6_mod.RECORD,
                                                 wkv6_mod.WAIT)]
    assert sorted((op, g) for op, g, _, _ in ops) == sorted(
        [(wkv6_mod.SUMS, 0)] + [(op, g) for g in range(n_seg) for op in (
            wkv6_mod.RECOMPUTE, wkv6_mod.REVERSE, wkv6_mod.CHUNK_PASS)])
    streams = {(op, g): s for op, g, s, _ in ops}
    for g in range(n_seg):
        assert streams[wkv6_mod.RECOMPUTE, g] == wkv6_mod.RECOMPUTE_STREAM
        assert streams[wkv6_mod.REVERSE, g] == wkv6_mod.REVERSE_STREAM
        assert streams[wkv6_mod.CHUNK_PASS, g] == (
            wkv6_mod.CHUNK_STREAM if g % 2 else wkv6_mod.CALLER)


def test_the_hazard_check_sees_a_missing_wait():
    """Without the waits on the chunk passes' events, the recompute of a
    segment may rewrite a buffer whose chunk pass is pending; without the
    joins the caller may end first: the check reports both."""
    rows = checkpoint_plan(4)
    no_war = tuple(row for row in rows if not (
        row[0] == wkv6_mod.WAIT and row[2] == wkv6_mod.RECOMPUTE_STREAM
        and row[3] in (wkv6_mod.CHUNKED, wkv6_mod.CHUNKED + 1)))
    assert ("rewritten while read", wkv6_mod.RECOMPUTE, 0) \
        in _plan_hazards(no_war, 4)
    no_join = tuple(row for row in rows if not (
        row[0] == wkv6_mod.WAIT and row[2] == wkv6_mod.CALLER
        and row[3] >= wkv6_mod.JOINED))
    assert ("not joined",) in _plan_hazards(no_join, 4)
