"""Dispatch on the tensor's device: the CUDA kernel, or its plain version.

A CUDA tensor goes to the hand-written kernel; a CPU tensor goes to the
plain PyTorch version; any other device raises.  There is no fallback: a
kernel that fails to build or launch raises instead of quietly running the
plain version.  Each op counts its kernel launches in a plain integer
(`launch_counts`), so a run can show that its main path went through the
kernels.

Gradients.  A kernel's output is a fresh tensor with no ``grad_fn``, so on
the card an op whose input requires grad (under grad mode) either has a
backward kernel or raises.  The ops that training runs have one:
``flash_attention_op``, ``wkv6_op`` and ``ssd_op`` then run through a
``torch.autograd.Function`` whose backward is a hand-written kernel
(``flash_attention_bwd_op``, ``wkv6_bwd_op``, ``ssd_bwd_op``).  Decode
attention and the router's ops raise: training never calls them, so they
have no backward kernel.  Without grad (the serving path) the kernels are
called directly.  On the CPU the plain versions differentiate through
PyTorch's own autograd; the scans' under the reference's checkpointing
(every 16th chunk state kept, each segment run again in the backward), as
their kernels on the card keep only those states too.

Under ``kernel_probe`` (the dry run, `launch/traffic.py`) each CPU call of
an op that has a kernel on the card (attention, decode attention, the two
scans) goes to the probe with the plain version it would run, so the
trace can count the kernel's own bytes in its place.
"""
from __future__ import annotations

import contextlib

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
from repro_torch.kernels.ssd import (ssd_bwd_cuda, ssd_checkpointed,
                                    ssd_cuda, ssd_plain)
from repro_torch.kernels.wkv6 import (CHUNK, kept_stride, wkv6_bwd_cuda,
                                     wkv6_checkpointed, wkv6_cuda,
                                     wkv6_plain)

__all__ = ["auction_bid_op", "auction_fused_op", "auction_solve_op",
           "decode_attention_op", "flash_attention_bwd_op",
           "flash_attention_op", "fused_phase1_op", "kernel_probe",
           "lcp_affinity_op", "lcp_gather_op", "launch_counts",
           "reset_launch_counts", "ssd_bwd_op", "ssd_op", "wkv6_bwd_op",
           "wkv6_op"]


_LAUNCHES = {"auction_bid": 0, "auction_solve": 0, "auction_fused": 0,
             "fused_phase1": 0, "lcp_affinity": 0, "lcp_gather": 0,
             "flash_attention": 0, "flash_attention_bwd": 0,
             "decode_attention": 0, "wkv6": 0, "wkv6_bwd": 0, "ssd": 0,
             "ssd_bwd": 0}


_KERNEL_PROBE = None


@contextlib.contextmanager
def kernel_probe(probe):
    """Route each CPU call of ``flash_attention_op``,
    ``decode_attention_op``, ``wkv6_op`` and ``ssd_op`` to ``probe(name,
    plain, args, kwargs)``, which returns ``plain(*args, **kwargs)``."""
    global _KERNEL_PROBE
    prev = _KERNEL_PROBE
    _KERNEL_PROBE = probe
    try:
        yield
    finally:
        _KERNEL_PROBE = prev


def _plain(name: str, fn, args: tuple, kwargs: dict | None = None):
    """``fn(*args, **kwargs)``, the plain version of op ``name``, through
    the kernel probe when one is set."""
    if _KERNEL_PROBE is None:
        return fn(*args, **(kwargs or {}))
    return _KERNEL_PROBE(name, fn, args, kwargs or {})


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
    gradient, and ``name`` has no backward kernel (training never calls
    it)."""
    route = _route(tensors[0])
    if route == "cuda" and _needs_grad(*tensors):
        raise NotImplementedError(
            f"{name}: no backward kernel on CUDA (training does not call "
            "this op), and an input requires grad under grad mode; call it "
            "under torch.no_grad(), or on the CPU, where its plain version "
            "differentiates")
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
    """The flash kernel with its gradient: the forward asks the kernel for
    its rows' log-sum-exp and saves q, k, v, o and that LSE (a re-run
    forward under remat saves its own); the backward runs
    ``flash_attention_bwd_op`` (looked up when it runs, so a recorder that
    stands in for the op sees the call)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset):
        o, lse = flash_attention_cuda(q, k, v, causal=causal, window=window,
                                      q_offset=q_offset, return_lse=True)
        _LAUNCHES["flash_attention"] += 1
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.mode = (causal, window, q_offset)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        causal, window, q_offset = ctx.mode
        dq, dk, dv = flash_attention_bwd_op(q, k, v, o, do.contiguous(), lse,
                                            causal=causal, window=window,
                                            q_offset=q_offset)
        return dq, dk, dv, None, None, None


def flash_attention_op(q, k, v, *, causal=True, window=0, q_offset=0):
    """Causal / sliding-window GQA attention: q [B, Sq, H, d], k/v
    [B, Sk, Hkv, d] -> [B, Sq, H, d], query row i at key position
    i + ``q_offset``; see `kernels/flash_attention.py`.  On CUDA with an
    input that requires grad (under grad mode) it runs through
    `_FlashAttention`, so the backward kernel gives q, k and v their
    gradients; otherwise the kernel is called directly."""
    if _route(q) == "cuda":
        if _needs_grad(q, k, v):
            return _FlashAttention.apply(q, k, v, causal, window, q_offset)
        out = flash_attention_cuda(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset)
        _LAUNCHES["flash_attention"] += 1
        return out
    return _plain("flash_attention", flash_attention_plain, (q, k, v),
                  {"causal": causal, "window": window, "q_offset": q_offset})


def flash_attention_bwd_op(q, k, v, o, do, lse, *, causal=True, window=0,
                           q_offset=0):
    """The flash attention's gradient on the card: q, o, dO [B, Sq, H, d],
    k/v [B, Sk, Hkv, d] and the forward's lse [B, H, Sq] -> (dQ, dK, dV);
    see `kernels/flash_attention.py`.  Only ``_FlashAttention``'s backward
    calls it, and that Function runs only on CUDA (on the CPU the plain
    forward differentiates itself)."""
    out = flash_attention_bwd_cuda(q, k, v, o, do, lse, causal=causal,
                                   window=window, q_offset=q_offset)
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
    return _plain("decode_attention", decode_attention_plain,
                  (q, k_cache, v_cache, valid))


def _state_grad(dst):
    """The final state's gradient for a backward kernel: None (the state
    was not used, so no zeros are filled) or contiguous."""
    return None if dst is None else dst.contiguous()


def _kept(seq_len: int) -> int:
    """The stride of the states a training forward keeps (`wkv6.
    kept_stride`): every 16th chunk's where the reference's
    ``chunk_scan_checkpointed`` checkpoints, else every chunk's."""
    return kept_stride(-(-seq_len // CHUNK))


class _WKV6(torch.autograd.Function):
    """The WKV6 kernel with its gradient: the forward asks the kernel for
    the incoming state of every 16th chunk (every chunk's where the
    sequence has fewer than two whole segments of 16) and saves r, k, v,
    log_w, u and those states (a re-run forward under remat saves its
    own); the backward runs ``wkv6_bwd_op`` (looked up when it runs, so a
    recorder that stands in for the op sees the call), which recomputes
    each segment's states.  In training the final state is discarded, so
    its gradient arrives as None and reaches the kernel as a null
    pointer."""

    @staticmethod
    def forward(ctx, r, k, v, log_w, u, s0):
        o, s_t, states = wkv6_cuda(r, k, v, log_w, u, s0, return_states=True,
                                   keep_every=_kept(r.shape[1]))
        _LAUNCHES["wkv6"] += 1
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(r, k, v, log_w, u, states)
        return o, s_t

    @staticmethod
    def backward(ctx, do, dst):
        r, k, v, log_w, u, states = ctx.saved_tensors
        do = torch.zeros_like(r) if do is None else do.contiguous()
        grads = wkv6_bwd_op(r, k, v, log_w, u, states, do, _state_grad(dst),
                            want_ds0=ctx.needs_input_grad[5])
        return tuple(g if need else None
                     for g, need in zip(grads, ctx.needs_input_grad))


def wkv6_op(r, k, v, log_w, u, s0=None):
    """The RWKV-6 recurrence from state s0 (None: zeros): r, k, v, log_w
    [B, S, H, dk], u [H, dk] -> (o [B, S, H, dk], sT [B, H, dk, dk]); see
    `kernels/wkv6.py`.  On CUDA with an input that requires grad (under
    grad mode) it runs through `_WKV6`, so the backward kernel gives the
    inputs their gradients; otherwise the kernel is called directly.  On
    the CPU under grad it runs `wkv6.wkv6_checkpointed` (the plain chunk
    step, every 16th state kept, as the reference's scan), else the plain
    version."""
    if _route(r) == "cuda":
        if _needs_grad(r, k, v, log_w, u, s0):
            return _WKV6.apply(r, k, v, log_w, u, s0)
        out = wkv6_cuda(r, k, v, log_w, u, s0)
        _LAUNCHES["wkv6"] += 1
        return out
    plain = (wkv6_checkpointed if _needs_grad(r, k, v, log_w, u, s0)
             else wkv6_plain)
    return _plain("wkv6", plain, (r, k, v, log_w, u, s0))


def wkv6_bwd_op(r, k, v, log_w, u, states, do, dst=None, *,
                want_ds0=False):
    """WKV6's gradient on the card: the forward's inputs, its kept
    ``states`` (each chunk's, or every 16th's), the output's gradient and
    the final state's (None: zeros) -> (dr, dk, dv, dlog_w, du, ds0); see
    `kernels/wkv6.py`.  One count a call, the segments' recompute of the
    states included.  Only ``_WKV6``'s backward calls it, and that
    Function runs only on CUDA."""
    out = wkv6_bwd_cuda(r, k, v, log_w, u, states, do, dst,
                        want_ds0=want_ds0)
    _LAUNCHES["wkv6_bwd"] += 1
    return out


class _SSD(torch.autograd.Function):
    """The SSD kernel with its gradient, as `_WKV6`: the forward saves the
    inputs and every 16th chunk's incoming state (or every chunk's); the
    backward runs ``ssd_bwd_op``."""

    @staticmethod
    def forward(ctx, x, bmat, cmat, dt, a_log, d_skip, s0):
        y, s_t, states = ssd_cuda(x, bmat, cmat, dt, a_log, d_skip, s0,
                                  return_states=True,
                                  keep_every=_kept(x.shape[1]))
        _LAUNCHES["ssd"] += 1
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, bmat, cmat, dt, a_log, d_skip, states)
        return y, s_t

    @staticmethod
    def backward(ctx, dy, dst):
        x, bmat, cmat, dt, a_log, d_skip, states = ctx.saved_tensors
        dy = torch.zeros_like(x) if dy is None else dy.contiguous()
        grads = ssd_bwd_op(x, bmat, cmat, dt, a_log, d_skip, states, dy,
                           _state_grad(dst),
                           want_ds0=ctx.needs_input_grad[6])
        return tuple(g if need else None
                     for g, need in zip(grads, ctx.needs_input_grad))


def ssd_op(x, bmat, cmat, dt, a_log, d_skip, s0=None):
    """The Mamba-2 SSD scan from state s0 (None: zeros): x [B, S, H, hd],
    bmat/cmat [B, S, ds], dt [B, S, H], a_log/d_skip [H] -> (y [B, S, H,
    hd], sT [B, H, hd, ds]); see `kernels/ssd.py`.  Under grad it runs
    through `_SSD` on CUDA and `ssd.ssd_checkpointed` on the CPU, as
    `wkv6_op`."""
    if _route(x) == "cuda":
        if _needs_grad(x, bmat, cmat, dt, a_log, d_skip, s0):
            return _SSD.apply(x, bmat, cmat, dt, a_log, d_skip, s0)
        out = ssd_cuda(x, bmat, cmat, dt, a_log, d_skip, s0)
        _LAUNCHES["ssd"] += 1
        return out
    plain = (ssd_checkpointed if _needs_grad(x, bmat, cmat, dt, a_log,
                                             d_skip, s0) else ssd_plain)
    return _plain("ssd", plain, (x, bmat, cmat, dt, a_log, d_skip, s0))


def ssd_bwd_op(x, bmat, cmat, dt, a_log, d_skip, states, dy, dst=None, *,
               want_ds0=False):
    """SSD's gradient on the card: the forward's inputs, its kept
    ``states`` (each chunk's, or every 16th's), the output's gradient and
    the final state's (None: zeros) -> (dx, dB, dC, ddt, da_log, dD, ds0);
    see `kernels/ssd.py`.  One count a call, as `wkv6_bwd_op`.  Only
    ``_SSD``'s backward calls it, and that Function runs only on CUDA."""
    out = ssd_bwd_cuda(x, bmat, cmat, dt, a_log, d_skip, states, dy, dst,
                       want_ds0=want_ds0)
    _LAUNCHES["ssd_bwd"] += 1
    return out


def launch_counts() -> dict[str, int]:
    """Kernel launches per op since the last reset."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    """Set every op's launch count to 0."""
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0
