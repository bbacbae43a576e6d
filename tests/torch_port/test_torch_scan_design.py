"""The recipe of the port's two-pass scan kernels, emulated on the CPU.

``csrc/ssd.cu`` and ``csrc/wkv6.cu`` split each chunked scan into a
chunk-parallel pass A (everything that does not need the carried state)
and a serial pass B over chunks (the two products that do), and run the
products on the tensor cores with float32 operands carried as bf16 parts
(``csrc/scan_mma.cuh``).  This file replays that recipe in float32 PyTorch:
pass A and pass B in the kernels' order, at their chunk length (16) and
pass-B slice width (16 state rows or columns), with every bf16 split made
by ``.to(torch.bfloat16)`` at the kernels' rounding points and every
product summing the part products (i, j) with i + j < max(parts), as the
``mma``s do.  Two instances, as on the card:

* bf16: inputs x, B, C (r, k, v) rounded to bf16 enter whole; computed
  float32 operands (M, w∘x, the state; A, r_dec, k_dec, the state) go as
  two parts; the output is rounded to bf16;
* float32: every operand as three parts.

Held, with inputs drawn by numpy from a seed, against the JAX package:
its Pallas kernels in interpret mode (``repro.kernels.ssd.ssd``,
``repro.kernels.wkv6.wkv6``, zero state) and the reference model's
``models/ssm.{ssd,wkv6}_chunked`` (a stored state), on the same (rounded)
input values.  Gates: float32 within 1e-3; a bf16 output within one bf16
rounding of the reference's (|got - want| <= 2^-7·|want| + 1e-3); the
float32 state within 1e-3.  Shapes are small, with ragged and exact
multiples of the chunk, and a case with decays far past the usual clip
(log_w down to -50, dt up to 20).
"""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.ssd import ssd as pallas_ssd  # noqa: E402
from repro.kernels.wkv6 import wkv6 as pallas_wkv6  # noqa: E402
from repro.models import ssm as jax_ssm  # noqa: E402

CHUNK = 16            # tokens per chunk, both kernels
SLICE = 16            # state rows (SSD) / columns (WKV6) per pass-B warp
TOL = 1e-3
PARTS = {"bfloat16": (1, 2), "float32": (3, 3)}   # (inputs, computed)


# ---------------- the tensor-core products ----------------

def parts(x: torch.Tensor, n: int) -> list:
    """x as n bf16 parts (held in float32): hi = bf16(x), then each part
    rounds what the earlier ones left."""
    out = []
    for _ in range(n):
        h = x.to(torch.bfloat16).float()
        out.append(h)
        x = x - h
    return out


def pmm(eq: str, a: list, b: list) -> torch.Tensor:
    """The product of two operands given as parts: the part products
    (i, j) with i + j < max(len(a), len(b)), each exact in float32 (bf16
    times bf16) and summed in float32."""
    top = max(len(a), len(b))
    return sum(torch.einsum(eq, a[i], b[j]) for i in range(len(a))
               for j in range(len(b)) if i + j < top)


def chunks(t: torch.Tensor, s: int) -> torch.Tensor:
    """[B, S, ...] zero-padded to whole chunks: [B, n, 16, ...]."""
    pad = (-s) % CHUNK
    t = torch.nn.functional.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
    return t.reshape(t.shape[0], -1, CHUNK, *t.shape[2:])


# ---------------- the SSD recipe ----------------

def ssd_recipe(x, bm, cm, dt, a_log, d_skip, s0, dtype, parts_of=None,
               states=None):
    """(y, sT) as ``ssd_intra_kernel`` then ``ssd_state_kernel`` compute
    them; inputs are float32 tensors holding the instance's input values;
    ``parts_of`` (inputs, computed) overrides the instance's part counts;
    ``states`` [B, H, n, hd, ds], when given, receives each chunk's
    incoming state as pass B holds it (the kernel's ``states`` output)."""
    ni, nc = parts_of or PARTS[dtype]
    b, s, h, hd = x.shape
    xc, bc, cc = chunks(x, s), chunks(bm, s), chunks(cm, s)
    dtc = chunks(dt, s)                                  # [B, n, 16, H]
    n = xc.shape[1]
    tri = torch.tril(torch.ones(CHUNK, CHUNK, dtype=torch.bool))

    # pass A, every chunk at once
    cp, bp = parts(cc, ni), parts(bc, ni)
    cb = pmm("bctn,bcsn->bcts", cp, bp)                  # once per chunk
    la = -torch.exp(a_log)[None, None, None, :] * dtc
    p = torch.cumsum(la, dim=2)                          # [B, n, 16, H]
    p_last = p[:, :, -1:, :]
    dec = torch.exp(torch.clamp(p[:, :, :, None, :] - p[:, :, None, :, :],
                                max=0.0))                # [B, n, t, s, H]
    m = torch.where(tri[None, None, :, :, None],
                    cb[..., None] * dec * dtc[:, :, None, :, :], 0.0)
    xp = parts(xc, ni)
    x_f = sum(xp)
    y_intra = pmm("bctsh,bcshi->bcthi", parts(m, nc), xp) \
        + d_skip[None, None, None, :, None] * x_f
    w = torch.exp(torch.clamp(p_last - p, max=0.0)) * dtc     # [B, n, 16, H]
    ep, el = torch.exp(p), torch.exp(p_last[:, :, 0, :])

    # pass B, serial over chunks, one slice of 16 state rows at a time
    state = torch.zeros(b, h, hd, bm.shape[-1]) if s0 is None else s0.clone()
    y = torch.empty(b, n, CHUNK, h, hd)
    for i0 in range(0, hd, SLICE):
        sl = slice(i0, i0 + SLICE)
        st = state[:, :, sl]                             # [B, H, 16, ds]
        for c in range(n):
            if states is not None:
                states[:, :, c, sl] = st
            inter = pmm("btn,bhin->bthi", parts(cc[:, c], ni), parts(st, nc))
            y[:, c, :, :, sl] = y_intra[:, c, :, :, sl] \
                + ep[:, c, :, :, None] * inter
            wx = w[:, c, :, :, None] * x_f[:, c, :, :, sl]   # [B, 16, H, i]
            st = st * el[:, c, :, None, None] \
                + pmm("bshi,bsn->bhin", parts(wx, nc), parts(bc[:, c], ni))
        state[:, :, sl] = st
    y = y.reshape(b, n * CHUNK, h, hd)[:, :s]
    return y.to(getattr(torch, dtype)), state


# ---------------- the WKV6 recipe ----------------

def wkv6_recipe(r, k, v, log_w, u, s0, dtype, parts_of=None, states=None):
    """(o, sT) as ``wkv6_intra_kernel`` then ``wkv6_state_kernel`` compute
    them; inputs are float32 tensors holding the instance's input values;
    ``parts_of`` (inputs, computed) overrides the instance's part counts;
    ``states`` [B, H, n, dk, dk], when given, receives each chunk's
    incoming state as pass B holds it (the kernel's ``states`` output)."""
    ni, nc = parts_of or PARTS[dtype]
    b, s, h, dk = r.shape
    rc, kc, vc, lc = (chunks(t, s) for t in (r, k, v, log_w))  # [B,n,16,H,d]
    n = rc.shape[1]
    strict = torch.tril(torch.ones(CHUNK, CHUNK, dtype=torch.bool), -1)

    # pass A, every chunk at once: running sums in token order per channel
    p = torch.cumsum(lc, dim=2)
    q = torch.cat([torch.zeros_like(p[:, :, :1]), p[:, :, :-1]], dim=2)
    p_last = p[:, :, -1:]
    expo = q[:, :, :, None] - p[:, :, None, :]           # [B,n,t,s,H,d]
    assert bool((expo[:, :, strict] <= 0).all())         # the exponent rule
    dec = torch.exp(torch.where(strict[None, None, :, :, None, None], expo,
                                -torch.inf))
    a = (rc[:, :, :, None] * kc[:, :, None, :] * dec).sum(-1)   # [B,n,t,s,H]
    diag = (rc * u[None, None, None] * kc).sum(-1)               # [B,n,t,H]
    a = a + torch.diag_embed(diag.transpose(2, 3)).permute(0, 1, 3, 4, 2)
    vp = parts(vc, ni)
    o_intra = pmm("bctsh,bcshj->bcthj", parts(a, nc), vp)
    rdec = parts(rc * torch.exp(q), nc)                  # the scratch planes
    kdec = parts(kc * torch.exp(p_last - p), nc)
    el = torch.exp(p_last[:, :, 0])                      # [B, n, H, d]

    # pass B, serial over chunks, one slice of 16 state columns at a time;
    # the warp holds Sᵀ
    state = torch.zeros(b, h, dk, dk) if s0 is None else s0.clone()
    o = torch.empty(b, n, CHUNK, h, dk)
    for j0 in range(0, dk, SLICE):
        sl = slice(j0, j0 + SLICE)
        st = state[:, :, :, sl].transpose(2, 3)          # [B, H, j, d]
        for c in range(n):
            if states is not None:
                states[:, :, c, :, sl] = st.transpose(2, 3)
            o[:, c, :, :, sl] = o_intra[:, c, :, :, sl] + pmm(
                "bthd,bhjd->bthj", [x[:, c] for x in rdec], parts(st, nc))
            st = st * el[:, c, :, None, :] + pmm(
                "bshj,bshd->bhjd", [x[:, c, :, :, sl] for x in vp],
                [x[:, c] for x in kdec])
        state[:, :, :, sl] = st.transpose(2, 3)
    o = o.reshape(b, n * CHUNK, h, dk)[:, :s]
    return o.to(getattr(torch, dtype)), state


# ---------------- inputs and gates ----------------

def rounded(a: np.ndarray, dtype: str) -> np.ndarray:
    """The values an input of the instance's type holds, as float32."""
    t = torch.from_numpy(a)
    return (t.to(torch.bfloat16).float() if dtype == "bfloat16" else t).numpy()


def ssd_inputs(b, s, h, hd, ds, dtype, seed, state, strong=False):
    rng = np.random.default_rng(seed)
    f = np.float32
    x, bm, cm = (rounded(rng.standard_normal(sh).astype(f), dtype)
                 for sh in ((b, s, h, hd), (b, s, ds), (b, s, ds)))
    dt = np.abs(rng.standard_normal((b, s, h))).astype(f) \
        * (f(10.0) if strong else f(0.5))
    if strong:
        dt = np.minimum(dt, 20.0).astype(f)
    a_log = (rng.standard_normal(h) * 0.3).astype(f)
    dsk = rng.standard_normal(h).astype(f)
    s0 = rng.standard_normal((b, h, hd, ds)).astype(f) if state else None
    return x, bm, cm, dt, a_log, dsk, s0


def wkv6_inputs(b, s, h, dk, dtype, seed, state, strong=False):
    rng = np.random.default_rng(seed)
    f = np.float32
    r, k, v = (rounded(rng.standard_normal((b, s, h, dk)).astype(f), dtype)
               for _ in range(3))
    raw = rng.standard_normal((b, s, h, dk))
    lw = (np.clip(-np.exp(raw * 2.0 + 1.0), -50.0, -1e-3) if strong
          else np.clip(-np.exp(raw), -4.0, -1e-3)).astype(f)
    u = rng.standard_normal((h, dk)).astype(f)
    s0 = rng.standard_normal((b, h, dk, dk)).astype(f) if state else None
    return r, k, v, lw, u, s0


def assert_gates(got, want, dtype):
    (go, gs), (wo, ws) = got, want
    wo = torch.from_numpy(np.array(wo, np.float32))
    ws = torch.from_numpy(np.array(ws, np.float32))
    assert bool(torch.isfinite(go.float()).all()) \
        and bool(torch.isfinite(gs).all())
    if dtype == "bfloat16":
        want_o = wo.to(torch.bfloat16).float()
        diff = (go.float() - want_o).abs()
        assert bool((diff <= 2.0 ** -7 * want_o.abs() + TOL).all()), \
            float(diff.max())
    else:
        assert float((go - wo).abs().max()) < TOL
    assert float((gs - ws).abs().max()) < TOL


def run(fn, *args):
    return jax.jit(fn)(*args)


def t(a):
    return None if a is None else torch.from_numpy(a)


# ---------------- the tests ----------------

@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("b,s,h,hd,ds", [(1, 37, 3, 24, 40), (2, 32, 2, 16, 8),
                                         (1, 17, 2, 32, 16)])
def test_ssd_recipe_matches_pallas_from_zero(b, s, h, hd, ds, dtype):
    args = ssd_inputs(b, s, h, hd, ds, dtype, s + hd, state=False)
    got = ssd_recipe(*map(t, args), dtype)
    assert_gates(got, pallas_ssd(*args[:6]), dtype)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("b,s,h,dk", [(1, 37, 2, 24), (2, 32, 3, 8),
                                      (1, 17, 2, 16)])
def test_wkv6_recipe_matches_pallas_from_zero(b, s, h, dk, dtype):
    args = wkv6_inputs(b, s, h, dk, dtype, s + dk, state=False)
    got = wkv6_recipe(*map(t, args), dtype)
    assert_gates(got, pallas_wkv6(*args[:5]), dtype)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("strong", [False, True])
def test_ssd_recipe_matches_the_chunked_form_from_a_state(dtype, strong):
    args = ssd_inputs(1, 33, 3, 16, 16, dtype, 7, state=True, strong=strong)
    got = ssd_recipe(*map(t, args), dtype)
    assert_gates(got, run(jax_ssm.ssd_chunked, *args), dtype)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("strong", [False, True])
def test_wkv6_recipe_matches_the_chunked_form_from_a_state(dtype, strong):
    args = wkv6_inputs(1, 33, 2, 16, dtype, 9, state=True, strong=strong)
    got = wkv6_recipe(*map(t, args), dtype)
    assert_gates(got, run(jax_ssm.wkv6_chunked, *args), dtype)


def test_one_rounding_of_a_computed_operand_is_not_enough():
    """Why computed operands go as two parts: with the state in one bf16
    part, the float32 state of a stored-state WKV6 run misses the 1e-3
    gate that two parts meet."""
    args = wkv6_inputs(1, 48, 2, 16, "bfloat16", 3, state=True)
    want = run(jax_ssm.wkv6_chunked, *args)
    ws = np.asarray(want[1], np.float32)
    one = wkv6_recipe(*map(t, args), "bfloat16", parts_of=(1, 1))
    two = wkv6_recipe(*map(t, args), "bfloat16")
    assert float(np.abs(one[1].numpy() - ws).max()) > TOL
    assert float(np.abs(two[1].numpy() - ws).max()) < TOL
