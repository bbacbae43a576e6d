"""Linear-recurrence token mixers: RWKV-6 ("Finch") and Mamba-2 (SSD).

The port of the reference's `repro.models.ssm`.  The parallel (prefill,
extend) forms run the recurrence in chunks of 16 tokens through
`kernels/ops.py`: ``wkv6_op`` and ``ssd_op`` launch the hand-written CUDA
kernels on a CUDA tensor and run their plain chunked versions on a CPU
tensor, from the stored state when there is one.  Under grad on the card
they run through ``torch.autograd.Function``s whose backward is a
hand-written kernel too (``csrc/wkv6_bwd.cu``, ``csrc/ssd_bwd.cu``); the
casts ``u.float()``, ``a_log.float()`` and ``d_skip.float()`` below are
differentiable, so the model's parameters get their gradients.  The one-token decode
forms (`wkv6_step`, `ssd_step`) are the exact recurrence in plain PyTorch,
as the reference left them to jnp.

RWKV-6 recurrence (per head; r, k, w, u in R^dk, v in R^dv, state in
R^{dk,dv}):
    o_t = r_t @ (S_{t-1} + (u * k_t)^T v_t)
    S_t = diag(w_t) @ S_{t-1} + k_t^T v_t,     w_t = exp(-exp(w_raw_t))

Mamba-2 / SSD (per head; scalar decay a_t, x_t in R^hd, B_t, C_t in R^ds):
    S_t = a_t S_{t-1} + dt_t (x_t outer B_t)
    y_t = S_t @ C_t + D * x_t

Precision follows the reference op by op: the recurrences, log_w, dt, the
softplus and the norms in float32; the projections and mixes in the model
dtype; ``A_log`` and ``dt_bias`` are float32 parameters in any model.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.layers import group_norm_heads, normal_init, rms_norm

LORA_MIX = 32
LORA_DECAY = 64
CONV_WIDTH = 4


# =====================================================================
# RWKV-6
# =====================================================================

def rwkv6_init(cfg, dtype, *, generator: torch.Generator) -> dict:
    d, h, hd = cfg.d_model, cfg.ssm_heads, cfg.ssm_state
    dev = generator.device
    zeros = lambda *shape: torch.zeros(shape, dtype=dtype, device=dev)  # noqa: E731
    draw = lambda shape, fan_in, **kw: normal_init(  # noqa: E731
        shape, fan_in, dtype, generator=generator, **kw)
    p = {"mu_x": zeros(d)}
    for name in ("r", "k", "v", "g", "w"):
        rank = LORA_DECAY if name == "w" else LORA_MIX
        p[f"A_{name}"] = draw((d, rank), d)
        p[f"B_{name}"] = draw((rank, d), rank)
        p[f"mu_{name}"] = zeros(d)
    p.update({
        "w0": torch.full((d,), -0.6, dtype=dtype, device=dev),
        "u": draw((h, hd), hd),
        "wr": draw((d, d), d), "wk": draw((d, d), d), "wv": draw((d, d), d),
        "wgate": draw((d, d), d),
        "wo": draw((d, d), d, scale=1.0 / max(2 * cfg.n_layers, 1) ** 0.5),
        "gn_w": torch.ones((d,), dtype=dtype, device=dev),
        "gn_b": zeros(d),
        # channel mix
        "cm_mu_k": zeros(d), "cm_mu_r": zeros(d),
        "cm_k": draw((d, cfg.d_ff), d), "cm_v": draw((cfg.d_ff, d), cfg.d_ff),
        "cm_r": draw((d, d), d),
    })
    return p


def rwkv6_axes(cfg):
    ax = {
        "mu_x": "embed", "w0": "embed",
        "u": "heads head_dim",
        "wr": "embed inner", "wk": "embed inner", "wv": "embed inner",
        "wgate": "embed inner", "wo": "inner embed",
        "gn_w": "embed", "gn_b": "embed",
        "cm_mu_k": "embed", "cm_mu_r": "embed",
        "cm_k": "embed ff", "cm_v": "ff embed", "cm_r": "embed inner",
    }
    for name in ("r", "k", "v", "g", "w"):
        ax[f"A_{name}"] = "embed lora_rank"
        ax[f"B_{name}"] = "lora_rank embed"
        ax[f"mu_{name}"] = "embed"
    return ax


def _rwkv6_projections(p, x, xx, cfg):
    """Data-dependent token-shift mixes and projections.

    x: [..., D] current; xx: [..., D] the previous token's x (the shift).
    Returns r, k, v [..., H, hd], gate [..., D], log_w [..., H, hd] float32.
    """
    h, hd = cfg.ssm_heads, cfg.ssm_state
    sx = xx - x
    xbase = x + sx * p["mu_x"]
    mixed = {}
    for name in ("r", "k", "v", "g", "w"):
        lora = torch.tanh(xbase @ p[f"A_{name}"]) @ p[f"B_{name}"]
        mixed[name] = x + sx * (p[f"mu_{name}"] + lora)
    r = mixed["r"] @ p["wr"]
    k = mixed["k"] @ p["wk"]
    v = mixed["v"] @ p["wv"]
    gate = F.silu(mixed["g"] @ p["wgate"])
    w_raw = p["w0"] + torch.tanh(mixed["w"] @ p["A_w"]) @ p["B_w"]
    log_w = -torch.exp(w_raw.float())        # log of the decay, in (-inf, 0)
    split = lambda t: t.reshape(*t.shape[:-1], h, hd)  # noqa: E731
    return split(r), split(k), split(v), gate, split(log_w)


def wkv6_chunked(r, k, v, log_w, u, s0):
    """Chunkwise-parallel WKV6 from state s0.  r, k, v, log_w: [B, S, H, hd];
    u: [H, hd]; s0: [B, H, hd, hd] float32.  Returns (o [B, S, H, hd] in
    r's dtype, sT float32): the kernel on the card, its plain version on
    the CPU."""
    return ops.wkv6_op(r.contiguous(), k.contiguous(), v.contiguous(),
                       log_w.contiguous(), u.float().contiguous(),
                       s0.contiguous())


def wkv6_step(r, k, v, log_w, u, state):
    """Exact one-token recurrence.  r, k, v, log_w: [B, H, hd]; state:
    [B, H, hd, hd] float32 -> (o [B, H, hd] float32, new state)."""
    r, k, v, log_w = r.float(), k.float(), v.float(), log_w.float()
    kv = torch.einsum("bhd,bhv->bhdv", k, v)
    o = torch.einsum("bhd,bhdv->bhv", r,
                     state + u.float()[None, :, :, None] * kv)
    return o, state * torch.exp(log_w)[..., None] + kv


def rwkv6_time_mix(p, x, cfg, *, shift_state=None, wkv_state=None,
                   parallel=True):
    """The full time-mix block.  Parallel: x [B, S, D]; step: x [B, D].
    Returns (out, (new shift state [B, D], new wkv state))."""
    h, hd = cfg.ssm_heads, cfg.ssm_state
    if parallel:
        b, s, d = x.shape
        prev = (torch.zeros((b, 1, d), dtype=x.dtype, device=x.device)
                if shift_state is None else shift_state[:, None])
        xx = torch.cat([prev, x[:, :-1]], dim=1)
        r, k, v, gate, log_w = _rwkv6_projections(p, x, xx, cfg)
        s0 = (torch.zeros((b, h, hd, hd), dtype=torch.float32,
                          device=x.device)
              if wkv_state is None else wkv_state)
        o, s_t = wkv6_chunked(r, k, v, log_w, p["u"], s0)
        o = o.reshape(b, s, h * hd).to(x.dtype)
        o = group_norm_heads(o, p["gn_w"], p["gn_b"], h)
        return (o * gate) @ p["wo"], (x[:, -1], s_t)
    b, d = x.shape
    r, k, v, gate, log_w = _rwkv6_projections(p, x, shift_state, cfg)
    o, s_t = wkv6_step(r, k, v, log_w, p["u"], wkv_state)
    o = o.reshape(b, h * hd).to(x.dtype)
    o = group_norm_heads(o, p["gn_w"], p["gn_b"], h)
    return (o * gate) @ p["wo"], (x, s_t)


def rwkv6_channel_mix(p, x, *, shift_state=None, parallel=True):
    """The channel-mix block.  Returns (out, new shift state [B, D])."""
    if parallel:
        b, s, d = x.shape
        prev = (torch.zeros((b, 1, d), dtype=x.dtype, device=x.device)
                if shift_state is None else shift_state[:, None])
        xx = torch.cat([prev, x[:, :-1]], dim=1)
        new_shift = x[:, -1]
    else:
        xx = shift_state
        new_shift = x
    sx = xx - x
    xk = x + sx * p["cm_mu_k"]
    xr = x + sx * p["cm_mu_r"]
    kk = torch.square(torch.relu(xk @ p["cm_k"]))
    kv = kk @ p["cm_v"]
    rr = torch.sigmoid(xr @ p["cm_r"])
    return rr * kv, new_shift


# =====================================================================
# Mamba-2 (SSD)
# =====================================================================

def mamba2_init(cfg, dtype, *, generator: torch.Generator) -> dict:
    d = cfg.d_model
    di, ds, h = 2 * d, cfg.ssm_state, cfg.ssm_heads
    dev = generator.device
    return {
        "in_proj": normal_init((d, 2 * di + 2 * ds + h), d, dtype,
                               generator=generator),
        "conv_w": normal_init((CONV_WIDTH, di), CONV_WIDTH, dtype,
                              generator=generator),
        "conv_b": torch.zeros((di,), dtype=dtype, device=dev),
        # a = exp(-exp(A_log) * dt); float32 in every model, as the reference
        "A_log": torch.zeros((h,), dtype=torch.float32, device=dev),
        "D": torch.ones((h,), dtype=dtype, device=dev),
        "dt_bias": torch.zeros((h,), dtype=torch.float32, device=dev),
        "gn_w": torch.ones((di,), dtype=dtype, device=dev),
        "out_proj": normal_init((di, d), di, dtype, generator=generator,
                                scale=1.0 / max(2 * cfg.n_layers, 1) ** 0.5),
    }


def mamba2_axes(cfg):
    return {
        "in_proj": "embed inner", "conv_w": "conv_k inner", "conv_b": "inner",
        "A_log": "heads", "D": "heads", "dt_bias": "heads",
        "gn_w": "inner", "out_proj": "inner embed",
    }


def _mamba2_split(xz, cfg):
    """in_proj's output -> (z, x, B, C, dt_raw)."""
    di, ds = 2 * cfg.d_model, cfg.ssm_state
    return torch.split(xz, [di, di, ds, ds, cfg.ssm_heads], dim=-1)


def ssd_chunked(xh, bmat, cmat, dt, a_log, d_skip, s0):
    """Chunkwise SSD from state s0.  xh: [B, S, H, hd]; bmat, cmat:
    [B, S, ds]; dt: [B, S, H] float32 (after the softplus); a_log, d_skip:
    [H]; s0: [B, H, hd, ds] float32.  Returns (y [B, S, H, hd] in xh's
    dtype, sT float32): the kernel on the card, its plain version on the
    CPU."""
    return ops.ssd_op(xh.contiguous(), bmat.contiguous(), cmat.contiguous(),
                      dt.float().contiguous(), a_log.float().contiguous(),
                      d_skip.float().contiguous(), s0.contiguous())


def ssd_step(xh, bmat, cmat, dt, a_log, d_skip, state):
    """One-token SSD.  xh: [B, H, hd]; bmat, cmat: [B, ds]; dt: [B, H] ->
    (y [B, H, hd] float32, new state)."""
    xh, bmat, cmat, dt = xh.float(), bmat.float(), cmat.float(), dt.float()
    a = torch.exp(-torch.exp(a_log.float())[None] * dt)          # [B, H]
    new_state = state * a[..., None, None] \
        + torch.einsum("bh,bhd,bn->bhdn", dt, xh, bmat)
    y = torch.einsum("bhdn,bn->bhd", new_state, cmat)
    return y + d_skip.float()[None, :, None] * xh, new_state


def _softplus(x):
    """The reference's softplus, ``logaddexp(x, 0)``.  ``F.softplus`` is
    log1p(exp(x)) (and x past 20), which rounds otherwise; at zamba2-7b's
    test weights that moved the float32 gradient further from the float64
    oracle than the reference's (ROADMAP.md §3)."""
    return torch.logaddexp(x, x.new_zeros(()))


def mamba2_block(p, x, cfg, *, conv_state=None, ssm_state=None,
                 parallel=True):
    """The full Mamba-2 mixer.  Parallel: x [B, S, D]; step: x [B, D].
    Returns (out, (new conv state [B, 3, 2D], new ssm state))."""
    d = cfg.d_model
    di, ds, h = 2 * d, cfg.ssm_state, cfg.ssm_heads
    hd = di // h
    if parallel:
        b, s, _ = x.shape
        z, xr, bmat, cmat, dt_raw = _mamba2_split(x @ p["in_proj"], cfg)
        # causal depthwise conv (width 4) over xr
        prev = (torch.zeros((b, CONV_WIDTH - 1, di), dtype=xr.dtype,
                            device=x.device)
                if conv_state is None else conv_state)
        xr_pad = torch.cat([prev, xr], dim=1)
        xr_conv = sum(xr_pad[:, i:i + s] * p["conv_w"][i]
                      for i in range(CONV_WIDTH))
        xr_conv = F.silu(xr_conv + p["conv_b"])
        new_conv = xr_pad[:, s:s + CONV_WIDTH - 1]
        dt = _softplus(dt_raw.float() + p["dt_bias"])
        s0 = (torch.zeros((b, h, hd, ds), dtype=torch.float32,
                          device=x.device)
              if ssm_state is None else ssm_state)
        y, s_t = ssd_chunked(xr_conv.reshape(b, s, h, hd), bmat, cmat, dt,
                             p["A_log"], p["D"], s0)
        y = y.reshape(b, s, di).to(x.dtype)
    else:
        b, _ = x.shape
        z, xr, bmat, cmat, dt_raw = _mamba2_split(x @ p["in_proj"], cfg)
        conv_in = torch.cat([conv_state, xr[:, None]], dim=1)     # [B, 4, di]
        xr_conv = torch.einsum("bki,ki->bi", conv_in, p["conv_w"])
        xr_conv = F.silu(xr_conv + p["conv_b"])
        new_conv = conv_in[:, 1:]
        dt = _softplus(dt_raw.float() + p["dt_bias"])
        y, s_t = ssd_step(xr_conv.reshape(b, h, hd), bmat, cmat, dt,
                          p["A_log"], p["D"], ssm_state)
        y = y.reshape(b, di).to(x.dtype)
    y = rms_norm(y * F.silu(z), p["gn_w"], cfg.norm_eps)
    return y @ p["out_proj"], (new_conv, s_t)
