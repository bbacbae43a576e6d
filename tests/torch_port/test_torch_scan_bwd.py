"""The scans' gradients on the CPU: the plain backward versions against the
JAX package, and the backward kernels' recipe replayed in float32.

* ``wkv6_bwd_plain`` / ``ssd_bwd_plain`` (PyTorch's autograd through the
  plain chunked forwards, the card kernels' oracle) against ``jax.vjp`` of
  the reference's ``models/ssm.{wkv6,ssd}_chunked`` and of its stepwise
  ``kernels/ref.{wkv6,ssd}_ref``, from a state, with cotangents on both the
  output and the final state; each gradient within 1e-4 of its largest
  reference magnitude (what held: ~1e-6).
* The recipe of ``csrc/wkv6_bwd.cu`` and ``csrc/ssd_bwd.cu``: the reverse
  pass over chunks from the last (the state gradient dS, its outgoing value
  kept per chunk; its increment exp(p)∘dYᵀ·C or dOᵀ·r_dec a tensor-core
  product), the chunk-parallel pass from each chunk's saved incoming
  state and that dS (SSD: every product on the tensor cores; WKV6: every
  product, its per-channel pair sums in float32 and Σ S_out∘dS_out formed
  from S_in), the log-decay gradient (WKV6: by the chunk-local identity,
  suffix sums inside the chunk plus Σ S_out∘dS_out; SSD: as the four kinds
  of term that expand a_τ·Σ S_{τ-1}∘dS_τ, since the identity cancels at
  strong decays, pinned below), and the reductions in the kernels' fixed
  orders.  Replayed in float32 at the kernels' chunk (16) with the bf16
  splits at their rounding points, as ``test_torch_scan_design.py`` does
  for the forward: every product sums the part products of its operands
  (``pmm``), inputs as the instance's input parts (bf16: one, exact;
  float32: three), computed operands and the float32 states and dS as its
  computed parts (two; three); bf16 enters as the inputs' values and as
  the saved states (from the forward's recipe), and leaves as dr, dk, dv
  (dx, dB, dC) rounded once.  Held against the plain backward under the
  card's gates, and at strong decays from a state also against
  ``jax.vjp`` of the reference's chunked form: float32 within 1e-4 and
  bf16 within 3e-2 of each gradient's largest magnitude, and each row (a
  token and head of dr / dk / dv / dlog_w / dx, a token of dB / dC)
  within 2e-2 of its own largest value, counted as at least 1e-3 of the
  gradient's largest.
* ``ops.wkv6_op`` / ``ops.ssd_op`` under grad on the CPU: the plain
  versions through PyTorch's autograd, no kernel launch counted.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ref as jax_ref  # noqa: E402
from repro.models import ssm as jax_ssm  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.ssd import ssd_bwd_plain  # noqa: E402
from repro_torch.kernels.wkv6 import wkv6_bwd_plain  # noqa: E402
from test_torch_scan_design import (CHUNK, PARTS, chunks, parts,  # noqa: E402
                                    pmm, rounded, ssd_inputs, ssd_recipe,
                                    wkv6_inputs, wkv6_recipe)

REF_TOL = 1e-4
BWD_TOL = {"float32": 1e-4, "bfloat16": 3e-2}
ROW_TOL, ROW_FLOOR = 2e-2, 1e-3
WKV6_NAMES = ("dr", "dk", "dv", "dlog_w", "du", "ds0")
SSD_NAMES = ("dx", "dB", "dC", "ddt", "da_log", "dD", "ds0")
ROWS = {"dr", "dk", "dv", "dlog_w", "dx", "dB", "dC"}


def t(a):
    return None if a is None else torch.from_numpy(np.asarray(a, np.float32))


def cotangents(out_shape, state_shape, seed, dtype="float32"):
    rng = np.random.default_rng(seed)
    do = rounded(rng.standard_normal(out_shape).astype(np.float32), dtype)
    dst = rng.standard_normal(state_shape).astype(np.float32)
    return do, dst


def within(got, want, tol, what):
    err = float((got.double() - want.double()).abs().max())
    scale = float(want.double().abs().max())
    assert err <= tol * scale + 1e-30, f"{what}: {err} of {scale}"


def rows_within(got, want, what, axis):
    """Each row (the gradient reduced over ``axis``) within ROW_TOL of its
    own largest plain value, floored at ROW_FLOOR of the whole gradient's."""
    got, want = got.double(), want.double()
    least = max(ROW_FLOOR * float(want.abs().max()), 1e-30)
    err = ((got - want).abs().amax(axis)
           / want.abs().amax(axis).clamp_min(least))
    assert float(err.max()) <= ROW_TOL, f"{what}: a row off by {err.max()}"


# ---------------- the plain backward against the JAX package ----------------

def jax_vjp(fn, args, do, dst):
    _, pull = jax.vjp(fn, *(jnp.asarray(a) for a in args))
    return pull((jnp.asarray(do), jnp.asarray(dst)))


@pytest.mark.parametrize("fn", ["chunked", "ref"])
@pytest.mark.parametrize("s,dk,strong", [(37, 16, False), (37, 64, False),
                                         (32, 16, True)])
def test_wkv6_bwd_plain_matches_jax_vjp(fn, s, dk, strong):
    args = wkv6_inputs(2, s, 2, dk, "float32", s + dk, state=True,
                       strong=strong)
    do, dst = cotangents((2, s, 2, dk), (2, 2, dk, dk), dk)
    jfn = jax_ssm.wkv6_chunked if fn == "chunked" else jax_ref.wkv6_ref
    want = jax_vjp(jfn, args, do, dst)
    got = wkv6_bwd_plain(*map(t, args), t(do), t(dst))
    for name, g, w in zip(WKV6_NAMES, got, want):
        within(g, torch.from_numpy(np.array(w)), REF_TOL, name)


@pytest.mark.parametrize("fn", ["chunked", "ref"])
@pytest.mark.parametrize("s,hd,ds,strong", [(37, 24, 16, False),
                                            (37, 64, 64, False),
                                            (32, 16, 8, True)])
def test_ssd_bwd_plain_matches_jax_vjp(fn, s, hd, ds, strong):
    args = ssd_inputs(2, s, 3, hd, ds, "float32", s + hd, state=True,
                      strong=strong)
    do, dst = cotangents((2, s, 3, hd), (2, 3, hd, ds), hd)
    jfn = jax_ssm.ssd_chunked if fn == "chunked" else jax_ref.ssd_ref
    want = jax_vjp(jfn, args, do, dst)
    got = ssd_bwd_plain(*map(t, args), t(do), t(dst))
    for name, g, w in zip(SSD_NAMES, got, want):
        within(g, torch.from_numpy(np.array(w)), REF_TOL, name)


def test_plain_bwd_without_a_state_or_its_gradient():
    """s0 None is a zero state and dst None a zero cotangent: the same
    gradients as zeros given explicitly."""
    args = wkv6_inputs(1, 21, 2, 8, "float32", 5, state=False)
    do, _ = cotangents((1, 21, 2, 8), (1, 2, 8, 8), 5)
    zero = torch.zeros(1, 2, 8, 8)
    a = wkv6_bwd_plain(*map(t, args), t(do))
    b = wkv6_bwd_plain(*map(t, args[:5]), zero, t(do), zero)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    args = ssd_inputs(1, 21, 2, 8, 4, "float32", 5, state=False)
    do, _ = cotangents((1, 21, 2, 8), (1, 2, 8, 4), 6)
    zero = torch.zeros(1, 2, 8, 4)
    a = ssd_bwd_plain(*map(t, args), t(do))
    b = ssd_bwd_plain(*map(t, args[:6]), zero, t(do), zero)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


# ---------------- the backward kernels' recipe ----------------

def as_dtype(x, dtype):
    return x.to(getattr(torch, dtype))


def wkv6_bwd_recipe(r, k, v, log_w, u, states, do, dst, dtype,
                    partials=False):
    """(dr, dk, dv, dlog_w, du, ds0) as ``wkv6_bwd_reverse_kernel``, then
    ``wkv6_bwd_intra_kernel`` and ``wkv6_bwd_du_kernel`` compute them,
    from the forward's per-chunk ``states`` [B, H, n, dk, dk]: the products
    with their operands in the instance's parts (inputs NI, computed
    operands and the float32 states NC), the per-channel pair sums in
    float32, Σ S_out∘dS_out from S_in.  With ``partials`` du is left as
    its per-(batch, chunk) partials [B, n, H, dk], before the fixed-order
    sum."""
    ni, nc = PARTS[dtype]
    b, s, h, dk = r.shape
    rc, kc, vc, lc, oc = (chunks(x, s) for x in (r, k, v, log_w, do))
    n = rc.shape[1]
    p = torch.cumsum(lc, dim=2)                  # serial, per channel
    q = torch.cat([torch.zeros_like(p[:, :, :1]), p[:, :, :-1]], dim=2)
    p_last = p[:, :, -1]                         # [B, n, H, d]
    op, vp = parts(oc, ni), parts(vc, ni)

    # the reverse pass: dS_out of each chunk, then ds0; dSᵀ += dOᵀ·r_dec
    dss = torch.zeros(b, h, dk, dk) if dst is None else dst.clone()
    d_out = torch.empty(b, h, n, dk, dk)
    rdec = rc * torch.exp(q)
    for c in reversed(range(n)):
        d_out[:, :, c] = dss
        dss = torch.exp(p_last[:, c])[..., None] * dss + pmm(
            "bthd,bthj->bhdj", parts(rdec[:, c], nc), [x[:, c] for x in op])
    ds0 = dss

    # the chunk-parallel pass, every chunk at once
    s_in = states.permute(0, 2, 1, 3, 4)         # [B, n, H, d, j]
    ds_out = d_out.permute(0, 2, 1, 3, 4)
    sinp, dsop = parts(s_in, nc), parts(ds_out, nc)
    strict = torch.tril(torch.ones(CHUNK, CHUNK, dtype=torch.bool), -1)
    vd = pmm("bcthj,bcshj->bchts", op, vp)       # v_s·dO_t
    ex = torch.where(strict[None, None, :, :, None, None],
                     torch.exp(torch.clamp(q[:, :, :, None] - p[:, :, None],
                                           max=0.0)), 0.0)  # [B,n,t,s,H,d]
    vdt = vd.permute(0, 1, 3, 4, 2)[..., None]                # [B,n,t,s,H,1]
    drp = torch.exp(q) * pmm("bcthj,bchdj->bcthd", op, sinp) \
        + (ex * kc[:, :, None] * vdt).sum(3)
    ekl = torch.exp(p_last[:, :, None] - p)
    dkp = ekl * pmm("bcshj,bchdj->bcshd", vp, dsop) \
        + (ex * rc[:, :, :, None] * vdt).sum(2)
    diag = torch.diagonal(vd, dim1=3, dim2=4).permute(0, 1, 3, 2)[..., None]
    dr = drp + u * kc * diag
    dk_ = dkp + u * rc * diag
    a = (rc[:, :, :, None] * kc[:, :, None] * ex).sum(-1)     # [B,n,t,s,H]
    a = a + torch.diag_embed((rc * u * kc).sum(-1).transpose(2, 3)) \
        .permute(0, 1, 3, 4, 2)
    dv = pmm("bcshd,bchdj->bcshj", parts(kc * ekl, nc), dsop) \
        + pmm("bctsh,bcthj->bcshj", parts(a, nc), op)
    vds = pmm("bcshj,bchdj->bcshd", vp, dsop)                 # v·dS_outᵀ
    # Σ_j S_out∘dS_out with S_out = diag(exp(p_last))·S_in + k_decᵀ·v
    sod = torch.exp(p_last) * (s_in * ds_out).sum(-1) \
        + (kc * ekl * vds).sum(2)                             # [B,n,H,d]
    rdr, kdk = rc * drp, kc * dkp
    # Σ_{t>τ} r∘dr' - Σ_{s>=τ} k∘dk' by suffix sums inside the chunk
    sr = torch.flip(torch.cumsum(torch.flip(rdr, [2]), 2), [2]) - rdr
    sk = torch.flip(torch.cumsum(torch.flip(kdk, [2]), 2), [2])
    dlog_w = (sr - sk) + sod[:, :, None]
    du = (rc * kc * diag).sum(2)                              # [B,n,H,d]
    if not partials:
        du = du.reshape(b * n, h, dk).sum(0)      # (batch, chunk) order

    def unchunk(x):
        return x.reshape(b, n * CHUNK, h, dk)[:, :s]

    return (as_dtype(unchunk(dr), dtype), as_dtype(unchunk(dk_), dtype),
            as_dtype(unchunk(dv), dtype), unchunk(dlog_w), du, ds0)


def ssd_bwd_recipe(x, bm, cm, dt, a_log, d_skip, states, dy, dst, dtype,
                   identity_with=None, partials=False):
    """(dx, dB, dC, ddt, da_log, dD, ds0) as ``ssd_bwd_reverse_kernel``,
    then ``ssd_bwd_intra_kernel`` (8 heads a block) and the two sums
    compute them, from the forward's per-chunk ``states`` [B, H, n, hd,
    ds]: every product with its operands in the instance's parts (inputs
    NI, computed operands and the float32 states NC).  ``identity_with``
    (the final state) forms dla by the suffix identity instead, the
    kernel's rejected variant.  With ``partials`` da_log and dD are left
    as their per-(batch, chunk) partials [B, n, H], before the
    fixed-order sum."""
    ni, nc = PARTS[dtype]
    b, s, h, hd = x.shape
    xc, yc = chunks(x, s), chunks(dy, s)                      # [B,n,16,H,i]
    bc, cc = chunks(bm, s), chunks(cm, s)                     # [B,n,16,N]
    dtc = chunks(dt, s)                                       # [B,n,16,H]
    n = xc.shape[1]
    a = torch.exp(a_log)
    la = -a * dtc
    p = torch.cumsum(la, dim=2)
    ep = torch.exp(p)
    p_last = p[:, :, -1]                                      # [B, n, H]
    xp, yp, bp, cp = (parts(z, ni) for z in (xc, yc, bc, cc))

    # the reverse pass: dS += (exp(p)∘dY)ᵀ·C
    dss = torch.zeros(b, h, hd, bm.shape[-1]) if dst is None else dst.clone()
    d_out = torch.empty(b, h, n, hd, bm.shape[-1])
    for c in reversed(range(n)):
        d_out[:, :, c] = dss
        dss = torch.exp(p_last[:, c])[..., None, None] * dss + pmm(
            "bthi,btn->bhin", parts(ep[:, c, :, :, None] * sum(yp)[:, c], nc),
            [z[:, c] for z in cp])
    ds0 = dss

    # the chunk-parallel pass
    s_in = states.permute(0, 2, 1, 3, 4)                      # [B,n,H,i,N]
    ds_out = d_out.permute(0, 2, 1, 3, 4)
    sinp, dsop = parts(s_in, nc), parts(ds_out, nc)
    incl = torch.tril(torch.ones(CHUNK, CHUNK, dtype=torch.bool))
    cb = pmm("bctn,bcsn->bcts", cp, bp)
    e = torch.where(incl[None, None, :, :, None], torch.exp(torch.clamp(
        p[:, :, :, None] - p[:, :, None], max=0.0)), 0.0)  # [B,n,t,s,H]
    g = cb[..., None] * e
    xd = pmm("bcthi,bcshi->bctsh", yp, xp)                    # x_s·dY_t
    wl = torch.exp(torch.clamp(p_last[:, :, None] - p, max=0.0))
    sb = pmm("bcsn,bchin->bcshi", bp, dsop)                   # B·dS_outᵀ
    gd = pmm("bctsh,bcthi->bcshi", parts(g, nc), yp)          # Gᵀ·dY
    dx = dtc[..., None] * (gd + wl[..., None] * sb) \
        + d_skip[:, None] * sum(yp)
    dsi = pmm("bcthi,bchin->bcthn", yp, sinp)                 # dY·S_in
    xds = pmm("bcshi,bchin->bcshn", xp, dsop)                 # x·dS_out
    dch = pmm("bctsh,bcsn->bcthn", parts(e * dtc[:, :, None] * xd, nc), bp) \
        + ep[..., None] * dsi
    dbh = dtc[..., None] * (pmm("bctsh,bctn->bcshn", parts(e * xd, nc), cp)
                            + wl[..., None] * xds)
    xsb = (sum(xp) * sb).sum(-1)                              # [B,n,16,H]
    direct = (g * xd).sum(2) + wl * xsb
    # dla: the four kinds of term of a_τ·Σ S_{τ-1}∘dS_τ, each computed as it
    # stands (no difference of sums): the pairs with s < τ <= t, the S_in
    # terms of the outputs from τ on, the S_in∘dS_out term, and the dS_out
    # terms of the tokens before τ
    tau = torch.arange(CHUNK)
    rect = ((tau[None, :, None] >= tau[:, None, None])
            & (tau[None, None, :] < tau[:, None, None])).float()  # [τ, t, s]
    pairs = torch.einsum("uts,bctsh->bcuh", rect, dtc[:, :, None] * g * xd)
    csd = (cc[:, :, :, None] * dsi).sum(-1)                   # [B,n,16,H]
    suffix = lambda z: torch.flip(torch.cumsum(torch.flip(z, [2]), 2), [2])  # noqa: E731
    before = wl * dtc * xsb
    inner = torch.exp(p_last) * (s_in * ds_out).sum((-1, -2))  # [B, n, H]
    dla = pairs + suffix(ep * csd) + inner[:, :, None] \
        + (torch.cumsum(before, 2) - before)
    if identity_with is not None:
        s_out = torch.cat([states[:, :, 1:], identity_with[:, :, None]], 2)
        sod = (s_out.permute(0, 2, 1, 3, 4) * ds_out).sum((-1, -2))
        dla = (suffix((cc[:, :, :, None] * dch).sum(-1))
               - suffix((bc[:, :, :, None] * dbh).sum(-1))) + sod[:, :, None]
    ddt = direct - a * dla
    # [B, n, H], in token order whatever the number of chunks
    da_log = sum(dla[:, :, i] * la[:, :, i] for i in range(CHUNK))
    dd = torch.diagonal(xd, dim1=2, dim2=3).sum(-1)
    if not partials:                              # (batch, chunk) order
        da_log = da_log.reshape(b * n, h).sum(0)
        dd = dd.reshape(b * n, h).sum(0)
    # dB and dC: each block's heads in order, then the groups in order
    groups = [slice(g0, g0 + 8) for g0 in range(0, h, 8)]
    db = sum(dbh[:, :, :, gr].sum(3) for gr in groups)
    dc = sum(dch[:, :, :, gr].sum(3) for gr in groups)

    def unchunk(z, *tail):
        return z.reshape(b, n * CHUNK, *tail)[:, :s]

    ds = bm.shape[-1]
    return (as_dtype(unchunk(dx, h, hd), dtype),
            as_dtype(unchunk(db, ds), dtype), as_dtype(unchunk(dc, ds), dtype),
            unchunk(ddt, h), da_log, dd, ds0)


def check_recipe(got, want, names, dtype):
    for name, g, w in zip(names, got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert bool(torch.isfinite(g.float()).all()), name
        within(g, w, BWD_TOL[dtype], name)
        if name in ROWS:
            rows_within(g, w, name, -1)


def reference_vjp(fn, targs, state_shape, do, dst, dtype, n_typed):
    """``jax.vjp`` of the reference's chunked scan at the same (rounded)
    input values, s0 and dsT None as zeros; its first ``n_typed``
    gradients rounded to the instance's type, as the kernels return them."""
    zeros = np.zeros(state_shape, np.float32)
    args = [a.numpy() for a in targs[:-1]] + [
        zeros if targs[-1] is None else targs[-1].numpy()]
    want = jax_vjp(fn, args, do, zeros if dst is None else dst)
    want = [torch.from_numpy(np.array(w, np.float32)) for w in want]
    return [as_dtype(w, dtype) if i < n_typed else w
            for i, w in enumerate(want)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,dk,state,grad_st,strong", [
    (37, 16, True, True, False), (32, 64, False, False, False),
    (61, 64, True, False, False), (48, 16, True, True, True),
    (33, 64, False, True, True), (100, 24, False, True, True)])
def test_wkv6_bwd_recipe_matches_the_plain_backward(s, dk, state, grad_st,
                                                    strong, dtype):
    """The replay against the plain backward, and at strong decays from a
    state also against ``jax.vjp`` of the reference's chunked form."""
    args = wkv6_inputs(2, s, 3, dk, dtype, s + dk, state=state,
                       strong=strong)
    do, dst = cotangents((2, s, 3, dk), (2, 3, dk, dk), s, dtype)
    dst = dst if grad_st else None
    targs = list(map(t, args))
    n = -(-s // CHUNK)
    states = torch.empty(2, 3, n, dk, dk)
    wkv6_recipe(*targs, dtype, states=states)
    got = wkv6_bwd_recipe(*targs[:5], states, t(do), t(dst), dtype)
    typed = [as_dtype(x, dtype) for x in targs[:3]] + targs[3:]
    want = wkv6_bwd_plain(*typed, as_dtype(t(do), dtype), t(dst))
    check_recipe(got, want, WKV6_NAMES, dtype)
    if strong and state:    # one case a type: each jax.vjp takes ~2 s here
        check_recipe(got, reference_vjp(jax_ssm.wkv6_chunked, targs,
                                        (2, 3, dk, dk), do, dst, dtype, 3),
                     WKV6_NAMES, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,h,hd,ds,state,grad_st,strong", [
    (37, 3, 24, 16, True, True, False), (32, 10, 64, 64, False, False, False),
    (61, 2, 64, 64, True, False, False), (48, 3, 16, 16, True, True, True),
    (33, 9, 32, 64, False, True, True), (40, 9, 80, 40, True, True, False)])
def test_ssd_bwd_recipe_matches_the_plain_backward(s, h, hd, ds, state,
                                                   grad_st, strong, dtype):
    """The replay against the plain backward, and at strong decays from a
    state also against ``jax.vjp`` of the reference's chunked form."""
    args = list(ssd_inputs(2, s, h, hd, ds, dtype, s + hd, state=state,
                           strong=strong))
    if strong:     # as chip_smoke's strong case: dt·x of order one
        args[0] = rounded(args[0] * np.float32(0.05), dtype)
    do, dst = cotangents((2, s, h, hd), (2, h, hd, ds), s, dtype)
    dst = dst if grad_st else None
    targs = list(map(t, args))
    n = -(-s // CHUNK)
    states = torch.empty(2, h, n, hd, ds)
    ssd_recipe(*targs, dtype, states=states)
    got = ssd_bwd_recipe(*targs[:6], states, t(do), t(dst), dtype)
    typed = [as_dtype(x, dtype) for x in targs[:3]] + targs[3:]
    want = ssd_bwd_plain(*typed, as_dtype(t(do), dtype), t(dst))
    check_recipe(got, want, SSD_NAMES, dtype)
    if strong and state:    # one case a type: each jax.vjp takes ~2 s here
        check_recipe(got, reference_vjp(jax_ssm.ssd_chunked, targs,
                                        (2, h, hd, ds), do, dst, dtype, 3),
                     SSD_NAMES, dtype)


# ---------------- the ops on the CPU ----------------

def test_scan_ops_under_grad_on_the_cpu_are_plain_autograd():
    args = [t(a) for a in wkv6_inputs(1, 20, 2, 8, "float32", 1, state=True)]
    leaves = [a.clone().requires_grad_(True) for a in args]
    do, dst = cotangents((1, 20, 2, 8), (1, 2, 8, 8), 2)
    ops.reset_launch_counts()
    o, s_t = ops.wkv6_op(*leaves)
    got = torch.autograd.grad((o, s_t), leaves, (t(do), t(dst)))
    want = wkv6_bwd_plain(*args, t(do), t(dst))
    for g, w in zip(got, want):
        assert torch.allclose(g, w, rtol=1e-6, atol=1e-6)
    args = [t(a) for a in ssd_inputs(1, 20, 2, 8, 4, "float32", 1,
                                     state=True)]
    leaves = [a.clone().requires_grad_(True) for a in args]
    do, dst = cotangents((1, 20, 2, 8), (1, 2, 8, 4), 3)
    y, s_t = ops.ssd_op(*leaves)
    got = torch.autograd.grad((y, s_t), leaves, (t(do), t(dst)))
    want = ssd_bwd_plain(*args, t(do), t(dst))
    for g, w in zip(got, want):
        assert torch.allclose(g, w, rtol=1e-6, atol=1e-6)
    assert not any(ops.launch_counts().values())


def test_the_suffix_identity_is_not_enough_for_ssds_log_decay():
    """Why ``ssd_bwd_chunk_kernel`` expands dla into its four kinds of term:
    at strong decays (dt up to 20, la down to ~-40) the identity
    Σ_{t>=τ} C·dC^h - Σ_{s>=τ} B·dB^h + Σ S_out∘dS_out cancels to noise that
    da_log = Σ dla·la multiplies, and misses the float32 gate that the
    expansion meets."""
    args = list(ssd_inputs(2, 48, 3, 16, 16, "float32", 64, state=True,
                           strong=True))
    args[0] = args[0] * np.float32(0.05)
    do, dst = cotangents((2, 48, 3, 16), (2, 3, 16, 16), 48)
    targs = list(map(t, args))
    states = torch.empty(2, 3, 3, 16, 16)
    _, s_t = ssd_recipe(*targs, "float32", states=states)
    want = ssd_bwd_plain(*targs, t(do), t(dst))[4]
    scale = float(want.abs().max())
    exp = ssd_bwd_recipe(*targs[:6], states, t(do), t(dst), "float32")[4]
    ide = ssd_bwd_recipe(*targs[:6], states, t(do), t(dst), "float32",
                         identity_with=s_t)[4]
    assert float((exp - want).abs().max()) <= BWD_TOL["float32"] * scale
    assert float((ide - want).abs().max()) > BWD_TOL["float32"] * scale
