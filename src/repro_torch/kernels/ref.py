"""Plain PyTorch versions of the port's kernels (the CPU path and the oracles).

Each of the first five functions computes exactly what its hand-written
CUDA kernel computes, with plain tensor ops in the reference's op order:
the LCP, LCP-gather and bidding kernels agree with them bit for bit, the attention
kernels within the reference's tolerances (their sums run in another
order).  The tests hold these against the JAX package's oracles
(`repro.kernels.ref`) on the CPU, `chip_smoke.py` holds each kernel
against them on the card, and `kernels/ops.py` uses them for CPU tensors
only.  `wkv6_ref` and `ssd_ref` are the stepwise recurrences: the oracles
of the chunked plain versions in `kernels/wkv6.py` and `kernels/ssd.py`,
which are what the scan kernels and the CPU path compute.  `scan_vjp` is
autograd through such a plain forward: the backward oracle that
`wkv6_bwd_plain` and `ssd_bwd_plain` share.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


# ---------------- LCP ----------------

def lcp_ref(prompts: torch.Tensor, ledgers: torch.Tensor) -> torch.Tensor:
    """prompts: [N, L] int32; ledgers: [N, M, L] int32 -> [N, M] int32.

    The length of the common prefix of each prompt with each of its M
    ledger rows: the index of the first mismatching token, or L.
    """
    n, length = prompts.shape
    m = ledgers.shape[1]
    if length == 0:
        return torch.zeros((n, m), dtype=torch.int32, device=prompts.device)
    neq = prompts[:, None, :] != ledgers
    first = neq.to(torch.uint8).argmax(dim=-1)      # first True (0 if none)
    return torch.where(neq.any(dim=-1), first,
                       torch.full_like(first, length)).to(torch.int32)


def lcp_gather_ref(prompts: torch.Tensor, arena: torch.Tensor,
                   rows: torch.Tensor) -> torch.Tensor:
    """prompts: [N, Lp] int32; arena: [S, La] int32 (pad -2); rows: [N, M]
    int32 row indices -> [N, M] int32.

    `lcp_ref` on the dense tile ``arena[rows]``, cut or padded (-2) to the
    prompt width Lp: tokens past the arena's width never match.
    """
    n, lp = prompts.shape
    tile = arena[rows.long()]                       # [N, M, La]
    la = tile.shape[-1]
    if la >= lp:
        tile = tile[..., :lp]
    else:
        tile = torch.cat([tile, tile.new_full((*tile.shape[:2], lp - la),
                                              -2)], dim=-1)
    return lcp_ref(prompts, tile)


# ---------------- auction bidding round ----------------

def auction_bid_ref(W, ask, ask2, active, eps):
    """One Jacobi forward-bidding round of the capacitated column market.

    W: [n, m] float32 agent-level weights; ask/ask2: [m] cheapest and
    second-cheapest unit price per agent (+big where the agent has fewer
    units); active: [n] bool; eps: a float32 scalar.  Returns (best [m],
    winner [m] int32, wants [n] bool): the segment-max bid per agent (-big
    where none), the winning request per agent (ties to the lowest index, n
    where no bid), and which active requests bid at all (top profit > 0).

    The runner-up value v2 substitutes the favourite agent's own
    second-cheapest unit (ask2) at the k1 column.  The reference's
    ``mode="drop"`` scatters become scatters into one extra sink slot
    (index m) that is sliced off.
    """
    n, m = W.shape
    dev = W.device
    eps = float(eps)              # exact: eps is a float32 value
    big = torch.finfo(W.dtype).max / 4
    P = torch.where(active[:, None], W - ask[None, :], -big)
    v1 = P.amax(dim=1)
    k1 = P.argmax(dim=1)          # first index on ties, as jnp.argmax
    onehot = torch.arange(m, device=dev)[None, :] == k1[:, None]
    alt = torch.where(onehot & active[:, None], W - ask2[None, :], P)
    v2 = alt.amax(dim=1).clamp(min=0.0)
    wants = active & (v1 > 0.0)
    bid = ask[k1] + (v1 - v2) + eps
    sink = torch.full_like(k1, m)
    best = torch.full((m + 1,), -big, dtype=W.dtype, device=dev)
    best.scatter_reduce_(0, torch.where(wants, k1, sink), bid, "amax",
                         include_self=True)
    best = best[:m]
    at_best = wants & (bid == best[k1.clamp(max=m - 1)])
    winner = torch.full((m + 1,), n, dtype=torch.int32, device=dev)
    winner.scatter_reduce_(0, torch.where(at_best, k1, sink),
                           torch.arange(n, dtype=torch.int32, device=dev),
                           "amin", include_self=True)
    return best, winner[:m], wants


# ---------------- attention ----------------

def attention_mask(sq, sk, *, causal, window, device=None):
    """[Sq, Sk] bool: True where query i may read key j (j <= i when
    ``causal``; i - j < ``window`` when ``window`` > 0)."""
    qpos = torch.arange(sq, device=device)[:, None]
    kpos = torch.arange(sk, device=device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= (qpos - kpos) < window
    return mask


def attention_ref(q, k, v, *, causal=True, window=0, scale=None):
    """q: [B, Sq, H, d], k/v: [B, Sk, Hkv, d] -> [B, Sq, H, d] in q's dtype.

    GQA by head grouping (query head h reads KV head h // (H / Hkv)); the
    scores, softmax and PV product run in float32.  A key is masked (-1e30)
    above the diagonal when ``causal`` and ``window`` or more positions
    behind the query when ``window`` > 0.
    """
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    qg = q.reshape(b, sq, hkv, h // hkv, d).float()
    s = torch.einsum("bskgd,btkd->bkgst", qg, k.float())
    s = s * (scale or 1.0 / math.sqrt(d))
    mask = attention_mask(sq, sk, causal=causal, window=window,
                          device=q.device)
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgst,btkd->bskgd", p, v.float())
    return o.reshape(b, sq, h, d).to(q.dtype)


def attention_lse_ref(q, k, *, causal=True, window=0, scale=None):
    """q: [B, Sq, H, d], k: [B, Sk, Hkv, d] -> [B, H, Sq] float32.

    Each query row's natural-log log-sum-exp of its scaled scores under
    `attention_ref`'s masks (a masked score is -1e30): the flash forward
    kernel's saved LSE, computed independently of it.
    """
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    qg = q.reshape(b, sq, hkv, h // hkv, d).float()
    s = torch.einsum("bskgd,btkd->bkgst", qg, k.float())
    s = s * (scale or 1.0 / math.sqrt(d))
    mask = attention_mask(sq, sk, causal=causal, window=window,
                          device=q.device)
    lse = torch.logsumexp(torch.where(mask, s, NEG_INF), dim=-1)
    return lse.reshape(b, h, sq)


def decode_attention_ref(q, k_cache, v_cache, valid):
    """q: [B, H, d]; caches: [B, M, Hkv, d]; valid: [B, M] bool -> [B, H, d]
    in q's dtype, float32 inside; an invalid slot scores -1e30."""
    b, h, d = q.shape
    hkv = k_cache.shape[2]
    qg = q.reshape(b, hkv, h // hkv, d).float()
    s = torch.einsum("bkgd,bmkd->bkgm", qg, k_cache.float())
    s = s / math.sqrt(d)
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgm,bmkd->bkgd", p, v_cache.float())
    return o.reshape(b, h, d).to(q.dtype)


# ---------------- WKV6 (stepwise recurrence) ----------------

def wkv6_ref(r, k, v, log_w, u, s0):
    """r, k, v, log_w: [B, S, H, dk] (dv == dk); u: [H, dk]; s0: [B, H, dk,
    dv] -> (o [B, S, H, dv], sT [B, H, dk, dv]), all float32.

    o_t = r_t @ (S_{t-1} + (u*k_t)^T v_t);  S_t = diag(w_t) S_{t-1} + k_t^T v_t
    with w_t = exp(log_w_t): one token at a time, the kernels' oracle.
    """
    r, k, v, log_w = (t.float() for t in (r, k, v, log_w))
    u = u.float()
    state = s0.float()
    outs = []
    for t in range(r.shape[1]):
        kv = torch.einsum("bhd,bhv->bhdv", k[:, t], v[:, t])
        outs.append(torch.einsum("bhd,bhdv->bhv", r[:, t],
                                 state + u[None, :, :, None] * kv))
        state = state * torch.exp(log_w[:, t])[..., None] + kv
    o = torch.stack(outs, dim=1) if outs else torch.zeros_like(r)
    return o, state


# ---------------- SSD / Mamba2 (stepwise recurrence) ----------------

def ssd_ref(x, bmat, cmat, dt, a_log, d_skip, s0):
    """x: [B, S, H, hd]; bmat, cmat: [B, S, ds]; dt: [B, S, H]; a_log,
    d_skip: [H]; s0: [B, H, hd, ds] -> (y [B, S, H, hd], sT [B, H, hd, ds]),
    all float32.

    S_t = a_t S_{t-1} + dt_t (x_t outer B_t);  y_t = S_t @ C_t + D * x_t
    with a_t = exp(-exp(a_log) * dt_t): one token at a time, the kernels'
    oracle.
    """
    x, bmat, cmat, dt = (t.float() for t in (x, bmat, cmat, dt))
    neg_a = -torch.exp(a_log.float())
    d_skip = d_skip.float()
    state = s0.float()
    outs = []
    for t in range(x.shape[1]):
        a = torch.exp(neg_a[None] * dt[:, t])                      # [B, H]
        state = state * a[..., None, None] + torch.einsum(
            "bh,bhd,bn->bhdn", dt[:, t], x[:, t], bmat[:, t])
        y = torch.einsum("bhdn,bn->bhd", state, cmat[:, t])
        outs.append(y + d_skip[None, :, None] * x[:, t])
    y = torch.stack(outs, dim=1) if outs else torch.zeros_like(x)
    return y, state


# ---------------- scan gradients ----------------

def scan_vjp(plain, inputs, s0, state_shape, do, dst):
    """``torch.autograd.grad`` of ``plain(*inputs, s0)`` at the cotangents
    do (of the output) and dst (of the final state; None: zeros), s0 None
    meaning a zero state.  Returns the gradients of ``inputs`` and of s0,
    each in its input's dtype (a zero gradient where the function does not
    read an input)."""
    dev = inputs[0].device
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in inputs]
        state = (torch.zeros(state_shape, dtype=torch.float32, device=dev)
                 if s0 is None else s0.detach().float())
        state.requires_grad_(True)
        out, s_t = plain(*leaves, state)
        outs, cots = [out], [do.to(out.dtype)]
        if dst is not None:
            outs.append(s_t)
            cots.append(dst.float())
        grads = torch.autograd.grad(outs, [*leaves, state], cots,
                                    allow_unused=True)
    return tuple(torch.zeros_like(x) if g is None else g
                 for g, x in zip(grads, (*leaves, state)))
