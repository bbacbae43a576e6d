"""Mamba-2 SSD scan in chunks of 16 tokens, from an initial state.

Every Mamba-2 layer of a fresh prefill runs this once
(`models/ssm.py::ssd_chunked`).  On the card it is the hand-written kernel
pair in ``csrc/ssd.cu``: a chunk-parallel pass (C·Bᵀ once per block of
heads, the decays, the intra-chunk term M·x + D·x on the tensor cores) into
a float32 scratch buffer, then a serial pass, a block per (batch·head,
64 state rows), that keeps the float32 state in registers and does only
the two products that need it; ``ssd_plain`` is the same function in plain
PyTorch, the chunked form of the reference's ``models/ssm.ssd_chunked``,
used for CPU tensors and as the kernel's oracle (itself held against the
stepwise `kernels/ref.py::ssd_ref`).  With a zero initial state both
compute what the TPU kernel ``repro/kernels/ssd.py::ssd`` computes.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import scan_vjp
from repro_torch.kernels.wkv6 import (CHUNK, SEGMENT, _pad_chunks,
                                     _stride_of, kept_stride, plan_rows)

__all__ = ["ssd_bwd_cuda", "ssd_bwd_plain", "ssd_checkpointed", "ssd_cuda",
           "ssd_plain"]

MAX_STATE = 64
_P = ctypes.c_void_p
_I = ctypes.c_int


def _ssd_scan(x, bmat, cmat, dt, a_log, d_skip, s0):
    """`ssd_plain`'s recurrence as a scan: (step, the float32 initial
    state, the per-chunk operands xs [n, ...] (x, dt, the log decays, B,
    C), n, finish), ``step(state, xs_c) -> (state, y)`` one chunk and
    ``finish`` the stacked chunk outputs [n, B, H, C, hd] to y [B, S, H,
    hd] in x's dtype, the skip D·x added."""
    b, s, h, hd = x.shape
    ds = bmat.shape[-1]
    c = CHUNK
    pad = (-s) % c
    n = (s + pad) // c
    xf = _pad_chunks(x.float(), pad)
    dtf = _pad_chunks(dt.float(), pad)
    la = -torch.exp(a_log.float())[None, None, :] * dtf          # [B, S', H]
    xs = (xf.reshape(b, n, c, h, hd).permute(1, 0, 3, 2, 4),     # [n,B,H,C,hd]
          dtf.reshape(b, n, c, h).permute(1, 0, 3, 2),           # [n,B,H,C]
          la.reshape(b, n, c, h).permute(1, 0, 3, 2),
          _pad_chunks(bmat.float(), pad).reshape(b, n, c, ds).transpose(0, 1),
          _pad_chunks(cmat.float(), pad).reshape(b, n, c, ds).transpose(0, 1))
    state = (torch.zeros((b, h, hd, ds), dtype=torch.float32,
                         device=x.device) if s0 is None else s0.float())
    tri = torch.tril(torch.ones((c, c), dtype=torch.bool, device=x.device))

    def step(state, chunk):
        xx, dtt, lat, bb, cm = chunk
        p = torch.cumsum(lat, dim=-1)                            # [B, H, C]
        cb = torch.einsum("btn,bsn->bts", cm, bb)                # [B, C, C]
        dec = torch.exp(torch.where(
            tri, p[:, :, :, None] - p[:, :, None, :], -torch.inf))
        m = cb[:, None] * dec * dtt[:, :, None, :]
        y = torch.einsum("bhts,bhsd->bhtd", m, xx)
        y = y + torch.einsum("bhdn,btn->bhtd", state, cm) \
            * torch.exp(p)[..., None]
        w = torch.exp(p[:, :, -1:] - p) * dtt                    # [B, H, C]
        state = state * torch.exp(p[:, :, -1])[..., None, None] \
            + torch.einsum("bhsd,bsn->bhdn", xx * w[..., None], bb)
        return state, y

    def finish(y):
        y = y.permute(1, 0, 3, 2, 4).reshape(b, n * c, h, hd)
        y = y + d_skip.float()[None, None, :, None] * xf
        return y[:, :s].to(x.dtype)

    return step, state, xs, n, finish


def ssd_plain(x, bmat, cmat, dt, a_log, d_skip, s0=None):
    """x: [B, S, H, hd] (float32 or bfloat16); bmat, cmat: [B, S, ds] of
    x's dtype, shared by the heads; dt: [B, S, H] float32 (after the
    softplus); a_log, d_skip: [H]; s0: [B, H, hd, ds] float32 or None
    (zeros) -> (y [B, S, H, hd] in x's dtype, sT [B, H, hd, ds] float32).

    Per chunk of 16 tokens, in float32 and in the reference's op order: the
    intra-chunk term (C·Bᵀ ∘ exp(p_t - p_s) ∘ dt_s)·x over s <= t (every
    exponent <= 0, masked pairs exactly 0), the inter-chunk term
    exp(p)·(C·Sᵀ), the state update, then the skip D·x.  The decay is per
    head: la = -exp(a_log)·dt.  A ragged last chunk is padded with dt = 0
    and zero x, B, C: the identity.
    """
    step, state, xs, n, finish = _ssd_scan(x, bmat, cmat, dt, a_log, d_skip,
                                           s0)
    outs = []
    for i in range(n):
        state, y = step(state, [t[i] for t in xs])
        outs.append(y)
    return finish(torch.stack(outs)), state


def ssd_checkpointed(x, bmat, cmat, dt, a_log, d_skip, s0=None):
    """`ssd_plain`'s function, its own chunk step run under
    `models/scan_config.chunk_scan_checkpointed` as the reference's
    ``ssd_chunked`` runs it (see `wkv6.wkv6_checkpointed`): the same bits
    as `ssd_plain`, gradients too; the CPU route of the op under grad."""
    from repro_torch.models.scan_config import chunk_scan_checkpointed

    step, state, xs, n, finish = _ssd_scan(x, bmat, cmat, dt, a_log, d_skip,
                                           s0)
    s_t, y = chunk_scan_checkpointed(step, state, xs, n, SEGMENT)
    return finish(y), s_t


def ssd_bwd_plain(x, bmat, cmat, dt, a_log, d_skip, s0, dy, dst=None):
    """The gradient of `ssd_plain` at (x, B, C, dt, a_log, D, s0) given the
    output's gradient ``dy`` [B, S, H, hd] and the final state's ``dst``
    [B, H, hd, ds] (None: zeros; s0 None: a zero state), by PyTorch's
    autograd through the plain chunked forward: the oracle of
    `ssd_bwd_cuda`, independent of its recipe.  Returns (dx, dB, dC, ddt,
    da_log, dD, ds0), dx/dB/dC in x's dtype, the rest float32."""
    b, _, h, hd = x.shape
    return scan_vjp(ssd_plain, (x, bmat, cmat, dt, a_log, d_skip), s0,
                    (b, h, hd, bmat.shape[-1]), dy, dst)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("ssd")
    fn = lib.ssd_launch
    fn.argtypes = [_P] * 7 + [_I] + [_P] * 4 + [_I] * 11 + [_P]
    fn.restype = ctypes.c_int
    lib.ssd_scratch_floats.argtypes = [_I] * 4
    lib.ssd_scratch_floats.restype = ctypes.c_longlong
    return lib


@functools.lru_cache(maxsize=64)
def _scratch_floats(*shape) -> int:
    """Floats of float32 scratch the two passes share, per (b, chunks of
    the run, h, hd)."""
    return _lib().ssd_scratch_floats(*shape)


def _check_inputs(name, x, bmat, cmat, dt, a_log, d_skip, s0):
    """Raise unless (x, B, C, dt, a_log, D, s0) is what the kernels take."""
    dev = x.device
    tensors = (x, bmat, cmat, dt, a_log, d_skip) + (() if s0 is None
                                                     else (s0,))
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"{name} takes CUDA tensors on one device")
    if x.dtype not in (torch.float32, torch.bfloat16) \
            or bmat.dtype != x.dtype or cmat.dtype != x.dtype:
        raise TypeError(f"{name} takes x, bmat, cmat all float32 or all "
                        "bfloat16")
    if any(t.dtype != torch.float32 for t in (dt, a_log, d_skip)) \
            or (s0 is not None and s0.dtype != torch.float32):
        raise TypeError(f"{name} takes dt, a_log, d_skip and s0 in float32")
    if x.dim() != 4:
        raise ValueError(f"x {tuple(x.shape)} is not [B, S, H, hd]")
    b, s, h, hd = x.shape
    ds = bmat.shape[-1] if bmat.dim() == 3 else -1
    if bmat.shape != cmat.shape or tuple(bmat.shape) != (b, s, ds) \
            or tuple(dt.shape) != (b, s, h) or tuple(a_log.shape) != (h,) \
            or tuple(d_skip.shape) != (h,):
        raise ValueError(f"shapes x {tuple(x.shape)}, B {tuple(bmat.shape)},"
                         f" C {tuple(cmat.shape)}, dt {tuple(dt.shape)}, "
                         f"a_log {tuple(a_log.shape)}, D "
                         f"{tuple(d_skip.shape)} do not fit")
    if not 0 < ds <= MAX_STATE or hd <= 0:
        raise ValueError(f"state size {ds} is not in 1..{MAX_STATE}")
    if s0 is not None and tuple(s0.shape) != (b, h, hd, ds):
        raise ValueError(f"s0 {tuple(s0.shape)} is not [B, H, hd, ds]")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} takes contiguous tensors")


def ssd_cuda(x, bmat, cmat, dt, a_log, d_skip, s0=None, *,
             return_states=False, keep_every=1):
    """The kernel: ``ssd_plain``'s function on contiguous CUDA tensors of
    one device (x, bmat, cmat all float32 or all bfloat16; dt, a_log,
    d_skip and s0 float32; ds <= 64), launched on the current stream as
    two kernels (no zero state is filled when s0 is None).  With
    ``return_states`` it also returns the incoming state of every
    ``keep_every``-th chunk from the first, float32 [B, H, n_chunks /
    keep_every, hd, ds] (what `ssd_bwd_cuda` reads): every chunk's (1) or,
    where `wkv6.kept_stride` checkpoints, every SEGMENT-th; y and sT are
    the same bits whatever is kept.  Raises on any other input and on a
    failed launch."""
    _check_inputs("ssd_cuda", x, bmat, cmat, dt, a_log, d_skip, s0)
    b, s, h, hd = x.shape
    ds = bmat.shape[-1]
    n = -(-s // CHUNK)
    if keep_every not in (1, kept_stride(n)):
        raise ValueError(f"ssd_cuda: keep_every {keep_every} for {n} "
                         f"chunks: 1, or {SEGMENT} where kept_stride is")
    dev = x.device
    f32 = dict(dtype=torch.float32, device=dev)
    bf16 = x.dtype == torch.bfloat16
    y = torch.empty_like(x)
    s_t = torch.empty((b, h, hd, ds), **f32)
    states = (torch.empty((b, h, n // keep_every, hd, ds), **f32)
              if return_states else None)
    scratch = torch.empty(_scratch_floats(b, n, h, hd), **f32)
    vec_x = bf16 and hd % 8 == 0 and x.data_ptr() % 16 == 0
    vec_bc = bf16 and ds % 8 == 0 and bmat.data_ptr() % 16 == 0 \
        and cmat.data_ptr() % 16 == 0
    err = _lib().ssd_launch(
        x.data_ptr(), bmat.data_ptr(), cmat.data_ptr(), dt.data_ptr(),
        a_log.data_ptr(), d_skip.data_ptr(),
        None if s0 is None else s0.data_ptr(), hd * ds, scratch.data_ptr(),
        y.data_ptr(), s_t.data_ptr(),
        None if states is None else states.data_ptr(), b, s, h, hd, ds,
        int(bf16), int(vec_x), int(vec_bc), 0, n, keep_every,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd kernel launch failed: CUDA error {err}")
    return (y, s_t, states) if return_states else (y, s_t)


MAX_BWD_HEAD = 256


@functools.cache
def _bwd_lib() -> ctypes.CDLL:
    lib = build.load("ssd_bwd")
    lib.ssd_bwd_launch.argtypes = [_P] * 17 + [_I] * 11 + [_P]
    lib.ssd_bwd_launch.restype = ctypes.c_int
    lib.ssd_bwd_sums_launch.argtypes = [_P] * 8 + [_I] * 5 + [_P]
    lib.ssd_bwd_sums_launch.restype = ctypes.c_int
    lib.ssd_bwd_groups.argtypes = [_I]
    lib.ssd_bwd_groups.restype = ctypes.c_int
    lib.ssd_bwd_ckpt_floats.argtypes = [_I] * 5
    lib.ssd_bwd_ckpt_floats.restype = ctypes.c_longlong
    lib.ssd_bwd_ckpt_launch.argtypes = [_P] * 18 + [_I] * 8 + [_P]
    lib.ssd_bwd_ckpt_launch.restype = ctypes.c_int
    return lib


def ssd_bwd_cuda(x, bmat, cmat, dt, a_log, d_skip, states, dy, dst=None,
                 want_ds0=False):
    """The gradient of `ssd_cuda` (``csrc/ssd_bwd.cu``): its inputs as it
    took them, its kept ``states`` (``return_states``: every chunk's
    incoming state, or the checkpoints of ``keep_every`` SEGMENT), the
    output's gradient ``dy`` (x's dtype and shape) and the final state's
    ``dst`` (None: zeros, no buffer filled) -> (dx, dB, dC, ddt, da_log,
    dD, ds0): dx/dB/dC in x's dtype, the rest float32, ds0 None unless
    ``want_ds0``.

    From every state: a reverse pass over the chunks and a chunk-parallel
    pass, both on the tensor cores, then two fixed-order sums, with
    float32 scratch: one hd x ds matrix per chunk and head (each chunk's
    outgoing state gradient) and the head groups' partial sums of dB and
    dC.  From the checkpoints, one C call (``ssd_bwd_ckpt_launch``)
    issues `wkv6.checkpoint_plan` as `wkv6.wkv6_bwd_cuda` does: per
    segment the state-only recompute beside the reverse pass, then the
    chunk pass, the sums once at the end, two segments' states and dS in
    one workspace; the same bits as from every state.  Takes hd <= 256.
    Launched from the current stream, which every launch follows and
    precedes its later work.  Raises on any input the forward would
    refuse, on states, dy or dst of another shape or type, and on a
    failed launch; nothing falls back to a plain version."""
    _check_inputs("ssd_bwd_cuda", x, bmat, cmat, dt, a_log, d_skip, None)
    b, s, h, hd = x.shape
    ds = bmat.shape[-1]
    if hd > MAX_BWD_HEAD:
        raise ValueError(f"head size {hd} is not in 1..{MAX_BWD_HEAD}")
    n = -(-s // CHUNK)
    dev = x.device
    every = _stride_of("ssd_bwd_cuda", states, n)
    shapes = {"states": (states, (b, h, n // every, hd, ds), torch.float32),
              "dy": (dy, tuple(x.shape), x.dtype)}
    if dst is not None:
        shapes["dst"] = (dst, (b, h, hd, ds), torch.float32)
    for name, (t, shape, dtype) in shapes.items():
        if tuple(t.shape) != shape or t.dtype != dtype or t.device != dev \
                or not t.is_contiguous():
            raise ValueError(f"ssd_bwd_cuda: {name} {tuple(t.shape)} "
                             f"{t.dtype} is not a contiguous {dtype} {shape} "
                             f"on {dev}")
    lib = _bwd_lib()
    f32 = dict(dtype=torch.float32, device=dev)
    dx, db, dc = (torch.empty_like(t) for t in (x, bmat, cmat))
    ddt, da_log, dd = (torch.empty_like(t) for t in (dt, a_log, d_skip))
    ds0 = torch.empty((b, h, hd, ds), **f32) if want_ds0 else None
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    bf16 = x.dtype == torch.bfloat16
    stream = torch.cuda.current_stream(dev).cuda_stream
    ins = [t.data_ptr() for t in (x, bmat, cmat, dt, a_log, d_skip, dy,
                                  states)]
    if every > 1:
        work = torch.empty(lib.ssd_bwd_ckpt_floats(b, s, h, hd, ds), **f32)
        plan, steps = plan_rows(n // every)
        err = lib.ssd_bwd_ckpt_launch(
            *ins, ptr(dst), *(t.data_ptr() for t in (dx, db, dc, ddt, da_log,
                                                     dd)),
            ptr(ds0), work.data_ptr(), plan, steps, b, s, h, hd, ds,
            int(bf16), dev.index, stream)
    else:
        groups = lib.ssd_bwd_groups(h)
        db_part, dc_part = (torch.empty((b, s, groups, ds), **f32)
                            for _ in range(2))
        dd_part, da_part = (torch.empty((b, n, h), **f32) for _ in range(2))
        dstates = torch.empty_like(states)
        vec_x = bf16 and hd % 8 == 0 and x.data_ptr() % 16 == 0 \
            and dy.data_ptr() % 16 == 0
        vec_bc = bf16 and ds % 8 == 0 and bmat.data_ptr() % 16 == 0 \
            and cmat.data_ptr() % 16 == 0
        vec_s = ds % 4 == 0 and states.data_ptr() % 16 == 0 \
            and dstates.data_ptr() % 16 == 0
        parts = [t.data_ptr() for t in (db_part, dc_part, dd_part, da_part)]
        err = lib.ssd_bwd_launch(
            *ins, ptr(dst), dstates.data_ptr(), *parts, dx.data_ptr(),
            ddt.data_ptr(), ptr(ds0), b, s, h, hd, ds, 0, n, int(bf16),
            int(vec_x), int(vec_bc), int(vec_s), stream) \
            or lib.ssd_bwd_sums_launch(
                *parts, db.data_ptr(), dc.data_ptr(), dd.data_ptr(),
                da_log.data_ptr(), b, s, h, ds, int(bf16), stream)
    if err != 0:
        raise RuntimeError(f"ssd_bwd kernel launch failed: CUDA error {err}")
    return dx, db, dc, ddt, da_log, dd, ds0
