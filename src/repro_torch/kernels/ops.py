"""Dispatch on the tensor's device: the CUDA kernel, or its plain version.

A CUDA tensor goes to the hand-written kernel; a CPU tensor goes to the
plain PyTorch version; any other device raises.  There is no fallback: a
kernel that fails to build or launch raises instead of quietly running the
plain version.  Each op counts its kernel launches in a plain integer
(`launch_counts`), so a run can show that its main path went through the
kernels.

Gradients.  A kernel's output is a fresh tensor with no ``grad_fn``, so on
the card an op whose input requires grad (under grad mode) either has a
backward kernel or raises: ``flash_attention_op`` then runs through a
``torch.autograd.Function`` whose backward is ``flash_attention_bwd_op``
(the hand-written backward kernel); every other op raises, since no
backward kernel exists for it yet.  Without grad (the serving path) the
kernels are called directly, as before.  On the CPU the plain versions
differentiate through PyTorch's own autograd.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.auction_bid import (auction_bid_cuda,
                                             auction_bid_plain,
                                             auction_fused_cuda,
                                             auction_fused_plain,
                                             auction_solve_cuda,
                                             auction_solve_plain)
from repro_torch.kernels.decode_attention import (decode_attention_cuda,
                                                  decode_attention_plain)
from repro_torch.kernels.flash_attention import (flash_attention_bwd_cuda,
                                                 flash_attention_cuda,
                                                 flash_attention_plain)
from repro_torch.kernels.lcp_affinity import (lcp_affinity_cuda,
                                              lcp_affinity_plain,
                                              lcp_gather_cuda, lcp_gather_plain)
from repro_torch.kernels.routing_fused import (fused_phase1_cuda,
                                               fused_phase1_plain)
from repro_torch.kernels.ssd import ssd_cuda, ssd_plain
from repro_torch.kernels.wkv6 import wkv6_cuda, wkv6_plain

__all__ = ["auction_bid_op", "auction_fused_op", "auction_solve_op",
           "decode_attention_op", "flash_attention_bwd_op",
           "flash_attention_op", "fused_phase1_op", "lcp_affinity_op",
           "lcp_gather_op", "launch_counts", "reset_launch_counts", "ssd_op",
           "wkv6_op"]


_LAUNCHES = {"auction_bid": 0, "auction_solve": 0, "auction_fused": 0,
             "fused_phase1": 0, "lcp_affinity": 0, "lcp_gather": 0,
             "flash_attention": 0, "flash_attention_bwd": 0,
             "decode_attention": 0, "wkv6": 0, "ssd": 0}


def _route(t: torch.Tensor) -> str:
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no kernel or plain version for device {t.device}")
    return t.device.type


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in tensors)


def _cuda_forward_only(name: str, *tensors) -> str:
    """``_route`` of the first tensor, raising on CUDA when an input
    requires grad under grad mode: the kernel's output would carry no
    gradient, and no backward kernel exists for ``name`` yet."""
    route = _route(tensors[0])
    if route == "cuda" and _needs_grad(*tensors):
        raise NotImplementedError(
            f"{name}: no backward kernel exists yet on CUDA (ROADMAP.md, "
            "queue 1, item 5b), and an input requires grad under grad mode; "
            "call it under torch.no_grad(), or on the CPU, where its plain "
            "version differentiates")
    return route


def auction_bid_op(W, ask, ask2, active, eps):
    """One forward-bidding round of the column market: W [n, m], ask/ask2
    [m], active [n], eps -> (best [m], winner [m], wants [n]); see
    `kernels/auction_bid.py`."""
    if _cuda_forward_only("auction_bid", W, ask, ask2, active) == "cuda":
        out = auction_bid_cuda(W, ask, ask2, active, eps)
        _LAUNCHES["auction_bid"] += 1
        return out
    return auction_bid_plain(W, ask, ask2, active, eps)


def auction_solve_op(fbuf, ibuf, meta):
    """The staged ε-scaling solve of packed markets (`auction_bid.
    pack_markets`): fbuf float32, ibuf int32, meta the host layout table ->
    the packed int32 result (`auction_bid.unpack_solution`); see
    `kernels/auction_bid.py`."""
    if _cuda_forward_only("auction_solve", fbuf, ibuf) == "cuda":
        out = auction_solve_cuda(fbuf, ibuf, meta)
        _LAUNCHES["auction_solve"] += 1
        return out
    return auction_solve_plain(fbuf, ibuf, meta)


def fused_phase1_op(args, out, lay):
    """Phase 1 of the fused routing step over the padded (nb, mb) grid of
    ``args`` (`routing_fused.Phase1Args`) into the packed buffer ``out``
    of layout ``lay``; see `kernels/routing_fused.py`."""
    if _cuda_forward_only("fused_phase1", out) == "cuda":
        res = fused_phase1_cuda(args, out, lay)
        _LAUNCHES["fused_phase1"] += 1
        return res
    return fused_phase1_plain(args, out, lay)


def auction_fused_op(out, counts, p0, lay, **kw):
    """The fused mode of the staged solve: the market whose W and wmax sit
    in ``out`` (layout ``lay``), ε derived from wmax, the warm attempt and
    its cold fallback in one launch; keywords ``budget``, ``max_rounds``,
    ``warm``, ``theta``.  See `kernels/auction_bid.py`."""
    if _cuda_forward_only("auction_fused", out, counts, p0) == "cuda":
        res = auction_fused_cuda(out, counts, p0, lay, **kw)
        _LAUNCHES["auction_fused"] += 1
        return res
    return auction_fused_plain(out, counts, p0, lay, **kw)


def lcp_gather_op(prompts, arena, rows):
    """prompts [N, Lp] against arena rows ``arena[rows]`` (arena [S, La],
    rows [N, M]) -> lcp [N, M]; see `kernels/lcp_affinity.py`."""
    if _cuda_forward_only("lcp_gather", prompts, arena, rows) == "cuda":
        out = lcp_gather_cuda(prompts, arena, rows)
        _LAUNCHES["lcp_gather"] += 1
        return out
    return lcp_gather_plain(prompts, arena, rows)


def lcp_affinity_op(prompts, ledgers):
    """prompts [N, L], ledgers [N, M, L] -> lcp [N, M]; see
    `kernels/lcp_affinity.py`."""
    if _cuda_forward_only("lcp_affinity", prompts, ledgers) == "cuda":
        out = lcp_affinity_cuda(prompts, ledgers)
        _LAUNCHES["lcp_affinity"] += 1
        return out
    return lcp_affinity_plain(prompts, ledgers)


class _FlashAttention(torch.autograd.Function):
    """The flash kernel with its gradient: the forward saves q, k, v and
    o, the backward runs ``flash_attention_bwd_op`` (looked up when it
    runs, so a recorder that stands in for the op sees the call)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        o = flash_attention_cuda(q, k, v, causal=causal, window=window)
        _LAUNCHES["flash_attention"] += 1
        ctx.save_for_backward(q, k, v, o)
        ctx.mode = (causal, window)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o = ctx.saved_tensors
        causal, window = ctx.mode
        dq, dk, dv = flash_attention_bwd_op(q, k, v, o, do.contiguous(),
                                            causal=causal, window=window)
        return dq, dk, dv, None, None


def flash_attention_op(q, k, v, *, causal=True, window=0):
    """Causal / sliding-window GQA attention: q [B, Sq, H, d], k/v
    [B, Sk, Hkv, d] -> [B, Sq, H, d]; see `kernels/flash_attention.py`.
    On CUDA with an input that requires grad (under grad mode) it runs
    through `_FlashAttention`, so the backward kernel gives q, k and v
    their gradients; otherwise the kernel is called directly."""
    if _route(q) == "cuda":
        if _needs_grad(q, k, v):
            return _FlashAttention.apply(q, k, v, causal, window)
        out = flash_attention_cuda(q, k, v, causal=causal, window=window)
        _LAUNCHES["flash_attention"] += 1
        return out
    return flash_attention_plain(q, k, v, causal=causal, window=window)


def flash_attention_bwd_op(q, k, v, o, do, *, causal=True, window=0):
    """The flash attention's gradient on the card: q, o, dO [B, Sq, H, d],
    k/v [B, Sk, Hkv, d] -> (dQ, dK, dV); see `kernels/flash_attention.py`.
    Only ``_FlashAttention``'s backward calls it, and that Function runs
    only on CUDA (on the CPU the plain forward differentiates itself)."""
    out = flash_attention_bwd_cuda(q, k, v, o, do, causal=causal,
                                   window=window)
    _LAUNCHES["flash_attention_bwd"] += 1
    return out


def decode_attention_op(q, k_cache, v_cache, valid):
    """One-token attention: q [B, H, d] against caches [B, M, Hkv, d] under
    valid [B, M] -> [B, H, d]; see `kernels/decode_attention.py`."""
    if _cuda_forward_only("decode_attention", q, k_cache, v_cache,
                          valid) == "cuda":
        out = decode_attention_cuda(q, k_cache, v_cache, valid)
        _LAUNCHES["decode_attention"] += 1
        return out
    return decode_attention_plain(q, k_cache, v_cache, valid)


def wkv6_op(r, k, v, log_w, u, s0=None):
    """The RWKV-6 recurrence from state s0 (None: zeros): r, k, v, log_w
    [B, S, H, dk], u [H, dk] -> (o [B, S, H, dk], sT [B, H, dk, dk]); see
    `kernels/wkv6.py`."""
    if _cuda_forward_only("wkv6", r, k, v, log_w, u, s0) == "cuda":
        out = wkv6_cuda(r, k, v, log_w, u, s0)
        _LAUNCHES["wkv6"] += 1
        return out
    return wkv6_plain(r, k, v, log_w, u, s0)


def ssd_op(x, bmat, cmat, dt, a_log, d_skip, s0=None):
    """The Mamba-2 SSD scan from state s0 (None: zeros): x [B, S, H, hd],
    bmat/cmat [B, S, ds], dt [B, S, H], a_log/d_skip [H] -> (y [B, S, H,
    hd], sT [B, H, hd, ds]); see `kernels/ssd.py`."""
    if _cuda_forward_only("ssd", x, bmat, cmat, dt, a_log, d_skip,
                          s0) == "cuda":
        out = ssd_cuda(x, bmat, cmat, dt, a_log, d_skip, s0)
        _LAUNCHES["ssd"] += 1
        return out
    return ssd_plain(x, bmat, cmat, dt, a_log, d_skip, s0)


def launch_counts() -> dict[str, int]:
    """Kernel launches per op since the last reset."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    """Set every op's launch count to 0."""
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0
