"""The recipe of the bf16 flash-attention backward kernels, emulated on the CPU.

``csrc/flash_attention_bwd.cu`` computes dQ, dK and dV of bf16 attention on
the tensor cores in two kernels, with no atomics: ``dkdv_tc_kernel`` (one
block per 64 keys of a KV head, walking the group's query heads in order
and, per head, the 64-query tiles its masks reach, 32 queries a step) and
``dq_tc_kernel`` (one block per 64 queries of a head, walking the 64-key
tiles its masks reach, 32 keys a step).  Both read the forward's saved
row log-sum-exp (``flash_tc_kernel`` with an LSE pointer) and
D = rowsum(dO ∘ O).  This file replays that recipe in float32 PyTorch:
the forward's online softmax in the log2 domain over 64-key tiles (its LSE
and its bf16 output, P rounded to bf16 for P·V), then both backward
kernels at their tile sizes, walk orders and skipped tiles, with P =
exp2(S·scale·log2 e − LSE·log2 e) and dS = P ∘ (dP − D) in float32 and
rounded by ``.to(torch.bfloat16)`` exactly where the kernels round them:
P as the A operand of Pᵀ·dO, dS as the A operand of dSᵀ·Q and dS·K.
Every tile the walk skips is checked to be wholly masked, and every tile
the kernels run without masks to be wholly unmasked.

Inputs are drawn by numpy from a seed and rounded to bf16.  Gates, the
card's: each output within 3e-2 of its largest value, each row (a query of
dQ, a key of dK / dV) within 2e-2 of its own largest, a row counting as at
least 1e-3 of the output's largest.  Held against:

* ``jax.vjp`` of the reference's ``attend_parallel`` (float32 on the same
  values), with D taken from the reference's own float32 output.  D is
  where the forward's output enters the backward, and the bf16 rounding
  of that output alone moves a row of dQ whose terms nearly cancel (few
  keys, P near 1) past the row gate, in the plain version as much as in
  the kernels: a property of the function given a bf16 output, not of
  the recipe (pinned below);
* the port's plain backward (``flash_attention_bwd_plain``) on the
  recipe's own bf16 output, rounded to bf16: the comparison the card
  makes between the kernels and their plain version.

The plain LSE oracle (``kernels/ref.py::attention_lse_ref``) is held
against JAX's ``logsumexp`` of the reference's masked, scaled scores within
1e-6 relative, the emulated forward's LSE against the oracle within 1e-4,
and its output against the reference's under the same gates.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models.attention import NEG_INF as JAX_NEG_INF  # noqa: E402
from repro.models.attention import _group  # noqa: E402
from repro.models.attention import \
    attend_parallel as jax_attend_parallel  # noqa: E402
from repro_torch.kernels.flash_attention import \
    flash_attention_bwd_plain  # noqa: E402
from repro_torch.kernels.ref import (NEG_INF, attention_lse_ref,  # noqa: E402
                                     attention_mask)

BQ = BK = 64          # query / key rows of a tile, all three kernels
STEP = 32             # queries (dK/dV kernel) or keys (dQ kernel) a step
LOG2E = 1.4426950408889634
TOL, ROW_TOL, ROW_FLOOR = 3e-2, 2e-2, 1e-3

CASES = {     # b, sq, sk, h, hkv, d, causal, window
    "causal-512-d128-g4": (1, 512, 512, 8, 2, 128, True, 0),
    "causal-window-d64": (2, 300, 300, 4, 1, 64, True, 100),
    "causal-ragged-d12": (1, 100, 100, 6, 1, 12, True, 7),
    "noncausal-sq<sk": (2, 70, 150, 4, 2, 16, False, 0),
    "noncausal-sq>sk-d100": (1, 150, 70, 4, 4, 100, False, 0),
    "noncausal-window-g4": (1, 80, 130, 4, 1, 8, False, 20),
}


def bf(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bf16, held in float32."""
    return x.to(torch.bfloat16).float()


def draw(case: str):
    b, sq, sk, h, hkv, d, _, _ = CASES[case]
    rng = np.random.default_rng(sq * 7 + sk + d)
    q, k, v, do = (bf(torch.from_numpy(rng.standard_normal(s).astype(
        np.float32))) for s in ((b, sq, h, d), (b, sk, hkv, d),
                                (b, sk, hkv, d), (b, sq, h, d)))
    return q, k, v, do


def key_range(q0, sk, causal, window):
    """The 64-key tiles a 64-query tile at q0 reads (the forward's and
    ``dq_tc_kernel``'s walk): up to its last row's diagonal, from the
    tile holding its first row's window start."""
    end = min(sk, q0 + BQ) if causal else sk
    begin = max(0, q0 - window + 1) // BK * BK if window else 0
    return range(begin, end, BK)


def query_range(k0, sq, causal, window):
    """The 64-query tiles a 64-key tile at k0 is read by
    (``dkdv_tc_kernel``'s walk): from its first key's diagonal, up to the
    last query inside its last key's window."""
    begin = k0 if causal else 0
    end = min(sq, k0 + BK - 1 + window) if window else sq
    return range(begin, end, BQ)


def edge(q0, k0, sq, sk, causal, window) -> bool:
    """Whether the kernels mask the (64-query, 64-key) tile pair: a ragged
    edge, the diagonal or the window's edge cuts it."""
    return (q0 + BQ > sq or k0 + BK > sk or (causal and k0 + BK - 1 > q0)
            or bool(window and q0 + BQ - 1 - k0 >= window))


def check_walks(mask, sq, sk, causal, window):
    """Tiles the walks skip are wholly masked (both walks visit the same
    pairs); tiles run without masks are wholly unmasked."""
    seen = torch.zeros_like(mask)
    for q0 in range(0, sq, BQ):
        for k0 in key_range(q0, sk, causal, window):
            seen[q0:q0 + BQ, k0:k0 + BK] = True
            assert q0 in query_range(k0, sq, causal, window)
            if not edge(q0, k0, sq, sk, causal, window):
                assert bool(mask[q0:q0 + BQ, k0:k0 + BK].all())
    assert not bool((mask & ~seen).any())


def forward_recipe(q, k, v, causal, window):
    """(o, lse) as ``flash_tc_kernel`` computes them: per 64-query tile,
    the 64-key tiles of ``key_range`` with the scores scaled into the log2
    domain, a running row max and sum (of the float32 P), the accumulator
    rescaled once a tile, P rounded to bf16 for P·V; o = acc / max(l,
    1e-30) rounded to bf16, lse = (m + log2 max(l, 1e-30))·ln 2."""
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    scale_log2 = torch.tensor(1.0 / math.sqrt(d) * LOG2E, dtype=torch.float32)
    mask = attention_mask(sq, sk, causal=causal, window=window)
    qg = q.reshape(b, sq, hkv, g, d)
    o = torch.empty(b, sq, hkv, g, d)
    lse = torch.empty(b, hkv, g, sq)
    for q0 in range(0, sq, BQ):
        qt = qg[:, q0:q0 + BQ]
        n = qt.shape[1]
        m = torch.full((b, hkv, g, n), NEG_INF)
        l = torch.zeros(b, hkv, g, n)
        acc = torch.zeros(b, hkv, g, n, d)
        for k0 in key_range(q0, sk, causal, window):
            x = torch.einsum("bskgd,btkd->bkgst", qt, k[:, k0:k0 + BK])
            x = torch.where(mask[q0:q0 + BQ, k0:k0 + BK], x * scale_log2,
                            NEG_INF)
            mx = torch.maximum(m, x.amax(-1))
            corr = torch.exp2(m - mx)
            p = torch.exp2(x - mx[..., None])
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkgst,btkd->bkgsd", bf(p), v[:, k0:k0 + BK])
            m = mx
        den = l.clamp_min(1e-30)
        o[:, q0:q0 + BQ] = bf(acc / den[..., None]).permute(0, 3, 1, 2, 4)
        lse[..., q0:q0 + BQ] = (m + torch.log2(den)) * math.log(2.0)
    return o.reshape(b, sq, h, d), lse.reshape(b, h, sq)


def backward_recipe(q, k, v, o, do, lse, causal, window):
    """(dq, dk, dv) as the bf16 backward kernels compute them, bf16 values
    in float32 tensors."""
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    scale = 1.0 / math.sqrt(d)
    scale_log2 = torch.tensor(scale * LOG2E, dtype=torch.float32)
    mask = attention_mask(sq, sk, causal=causal, window=window)
    qg, dog = (t.reshape(b, sq, hkv, g, d) for t in (q, do))
    delta = (do * o).sum(-1).permute(0, 2, 1).reshape(b, hkv, g, sq)
    lse2 = lse.reshape(b, hkv, g, sq) * LOG2E
    zero = torch.zeros(())

    def p_ds(s, dp, rows, cols, lse2_, delta_):
        """P and dS of a step, masked pairs 0; s / dp [..., rows, cols],
        lse2_ / delta_ broadcast over them."""
        keep = mask[rows][:, cols]
        p = torch.where(keep, torch.exp2(s * scale_log2 - lse2_), zero)
        return p, p * (dp - delta_)

    # dkdv_tc_kernel: a block per 64 keys, all its sums in order
    dk, dv = torch.zeros(b, sk, hkv, d), torch.zeros(b, sk, hkv, d)
    for k0 in range(0, sk, BK):
        kt, vt = k[:, k0:k0 + BK], v[:, k0:k0 + BK]
        acc_k = torch.zeros(b, kt.shape[1], hkv, d)
        acc_v = torch.zeros_like(acc_k)
        for gi in range(g):
            for q0 in query_range(k0, sq, causal, window):
                for s0 in range(q0, min(q0 + BQ, sq), STEP):
                    sl = slice(s0, s0 + STEP)
                    qs, ds_ = qg[:, sl, :, gi], dog[:, sl, :, gi]
                    st = torch.einsum("btkd,bskd->bkts", kt, qs)
                    dpt = torch.einsum("btkd,bskd->bkts", vt, ds_)
                    p, ds = p_ds(st.transpose(-1, -2),
                                 dpt.transpose(-1, -2), sl,
                                 slice(k0, k0 + BK),
                                 lse2[:, :, gi, sl, None],
                                 delta[:, :, gi, sl, None])
                    acc_v += torch.einsum("bkst,bskd->btkd", bf(p), ds_)
                    acc_k += torch.einsum("bkst,bskd->btkd", bf(ds), qs)
        dk[:, k0:k0 + BK] = bf(acc_k * scale)
        dv[:, k0:k0 + BK] = bf(acc_v)

    # dq_tc_kernel: a block per 64 queries of every head
    dq = torch.zeros(b, sq, hkv, g, d)
    for q0 in range(0, sq, BQ):
        sl = slice(q0, q0 + BQ)
        qt, dot = qg[:, sl], dog[:, sl]
        acc = torch.zeros(b, qt.shape[1], hkv, g, d)
        for k0 in key_range(q0, sk, causal, window):
            for s0 in range(k0, min(k0 + BK, sk), STEP):
                ks = slice(s0, s0 + STEP)
                s = torch.einsum("bskgd,btkd->bkgst", qt, k[:, ks])
                dp = torch.einsum("bskgd,btkd->bkgst", dot, v[:, ks])
                _, ds = p_ds(s, dp, sl, ks, lse2[..., sl, None],
                             delta[..., sl, None])
                acc += torch.einsum("bkgst,btkd->bskgd", bf(ds), k[:, ks])
        dq[:, sl] = bf(acc * scale)
    return dq.reshape(b, sq, h, d), dk, dv


def jax_vjp(q, k, v, do, causal, window):
    """The reference's output and (dq, dk, dv), float32 numpy arrays."""
    def fwd_bwd(a, c, e, gr):
        out, pull = jax.vjp(lambda a, c, e: jax_attend_parallel(
            a, c, e, causal=causal, window=window), a, c, e)
        return (out, *pull(gr))

    return [np.array(x) for x in jax.jit(fwd_bwd)(
        *(jnp.asarray(t.numpy()) for t in (q, k, v, do)))]


def row_errors(got, want) -> list[float]:
    """Each output's worst row error, as ``assert_gates`` measures it."""
    out = []
    for g_, w_ in zip(got, want):
        g_, w_ = g_.double(), torch.as_tensor(w_).double()
        least = ROW_FLOOR * float(w_.abs().max())
        out.append(float(((g_ - w_).abs().amax(-1)
                          / w_.abs().amax(-1).clamp_min(least)).max()))
    return out


def assert_gates(got, want) -> None:
    """Each output within TOL of its largest |want|, each row within
    ROW_TOL of its own largest, floored at ROW_FLOOR of the output's."""
    for name, g_, w_, row in zip(("dq", "dk", "dv"), got, want,
                                 row_errors(got, want)):
        w_ = torch.as_tensor(w_).double()
        assert g_.shape == w_.shape and bool(torch.isfinite(g_).all())
        err = float((g_.double() - w_).abs().max()) / float(w_.abs().max())
        assert err <= TOL, (name, err)
        assert row <= ROW_TOL, (name, row)


@pytest.mark.parametrize("case", list(CASES))
def test_backward_recipe_matches_jax_under_the_card_gates(case):
    b, sq, sk, h, hkv, d, causal, window = CASES[case]
    q, k, v, do = draw(case)
    check_walks(attention_mask(sq, sk, causal=causal, window=window), sq,
                sk, causal, window)
    _, lse = forward_recipe(q, k, v, causal, window)
    o_ref, *want = jax_vjp(q, k, v, do, causal, window)
    assert_gates(backward_recipe(q, k, v, torch.from_numpy(o_ref), do, lse,
                                 causal, window), want)


@pytest.mark.parametrize("case", list(CASES))
def test_backward_recipe_matches_the_plain_version_on_its_output(case):
    b, sq, sk, h, hkv, d, causal, window = CASES[case]
    q, k, v, do = draw(case)
    o, lse = forward_recipe(q, k, v, causal, window)
    want = flash_attention_bwd_plain(q, k, v, o, do, causal=causal,
                                     window=window)
    assert_gates(backward_recipe(q, k, v, o, do, lse, causal, window),
                 [bf(w) for w in want])


def test_the_bf16_output_alone_moves_near_cancelling_dq_rows():
    """The plain backward in float32, fed the forward's bf16 output, puts
    a dQ row of the windowed case past ROW_TOL against ``jax.vjp``; fed the
    reference's float32 output, every row is inside it.  So the recipe is
    held against JAX with the reference's own output in D."""
    b, sq, sk, h, hkv, d, causal, window = CASES["causal-window-d64"]
    q, k, v, do = draw("causal-window-d64")
    o, _ = forward_recipe(q, k, v, causal, window)
    o_ref, *want = jax_vjp(q, k, v, do, causal, window)
    kw = dict(causal=causal, window=window)
    rounded = row_errors(flash_attention_bwd_plain(q, k, v, o, do, **kw),
                         want)
    exact = row_errors(flash_attention_bwd_plain(
        q, k, v, torch.from_numpy(o_ref), do, **kw), want)
    assert rounded[0] > ROW_TOL and max(exact) <= ROW_TOL, (rounded, exact)


@pytest.mark.parametrize("case", list(CASES))
def test_lse_oracle_and_the_forward_recipe_match_jax(case):
    b, sq, sk, h, hkv, d, causal, window = CASES[case]
    q, k, v, _ = draw(case)
    want = torch.from_numpy(np.array(jax_lse(q, k, causal, window)))
    plain = attention_lse_ref(q, k, causal=causal, window=window)
    assert plain.shape == (b, h, sq) and plain.dtype == torch.float32
    assert float(((plain - want).abs() / want.abs().clamp_min(1.0))
                 .max()) <= 1e-6
    o, emulated = forward_recipe(q, k, v, causal, window)
    assert float((emulated - plain).abs().max()) <= 1e-4
    o_ref = jax_vjp(q, k, v, q, causal, window)[0]
    assert_gates([o], [o_ref])


def jax_lse(q, k, causal, window):
    """JAX's logsumexp of the reference's masked, scaled scores, [B, H, Sq]
    (``attend_parallel``'s dense path written out up to its softmax)."""
    qj, kj = jnp.asarray(q.numpy()), jnp.asarray(k.numpy())
    b, sq, h, d = qj.shape
    sk, hkv = kj.shape[1], kj.shape[2]
    s = jnp.einsum("bskgd,btkd->bkgst", _group(qj, hkv), kj) \
        * (1.0 / jnp.sqrt(d).astype(jnp.float32))
    qpos, kpos = jnp.arange(sq)[:, None], jnp.arange(sk)[None, :]
    m = jnp.ones((sq, sk), bool)
    if causal:
        m &= kpos <= qpos
    if window:
        m &= (qpos - kpos) < window
    s = jnp.where(m[None, None, None], s, JAX_NEG_INF)
    return jax.nn.logsumexp(s, axis=-1).reshape(b, h, sq)
