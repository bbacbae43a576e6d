"""RWKV-6 (WKV6) recurrence in chunks of 16 tokens, from an initial state.

Every RWKV-6 layer of a fresh prefill or an extend runs this once
(`models/ssm.py::wkv6_chunked`).  On the card it is the hand-written kernel
pair in ``csrc/wkv6.cu``: a chunk-parallel pass (the per-channel decays,
the intra-chunk matrix A once per head, A·v on the tensor cores) into a
float32 scratch buffer, then a serial pass, a block per batch·head, that
keeps the float32 state in registers and does only the two products that
need it; ``wkv6_plain`` is the same function in plain
PyTorch, the chunked form of the reference's ``models/ssm.wkv6_chunked``,
used for CPU tensors and as the kernel's oracle (itself held against the
stepwise `kernels/ref.py::wkv6_ref`).  With a zero initial state both
compute what the TPU kernel ``repro/kernels/wkv6.py::wkv6`` computes; with
a stored state, what the reference's model runs for an extend.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from repro_torch.kernels import build
from repro_torch.kernels.ref import scan_vjp

__all__ = ["CHUNK", "SEGMENT", "checkpoint_plan", "kept_stride",
           "wkv6_bwd_cuda", "wkv6_bwd_plain", "wkv6_checkpointed",
           "wkv6_cuda", "wkv6_plain"]

CHUNK = 16
# chunks between two states a training forward keeps for its backward (the
# reference's `models/scan_config.chunk_scan_checkpointed`, super_size 16)
SEGMENT = 16
MAX_HEAD_DIM = 64
_P = ctypes.c_void_p
_I = ctypes.c_int


def kept_stride(n_chunks: int) -> int:
    """The stride of the incoming states a training forward of
    ``n_chunks`` chunks keeps for its backward: every SEGMENT-th where the
    reference's ``chunk_scan_checkpointed`` checkpoints (n >= 2 segments
    and a whole number of them), else every state."""
    if n_chunks >= 2 * SEGMENT and n_chunks % SEGMENT == 0:
        return SEGMENT
    return 1


def _pad_chunks(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Zero rows appended along dim 1 (the sequence)."""
    if not pad:
        return x
    return F.pad(x, (0, 0) * (x.dim() - 2) + (0, pad))


def _wkv6_scan(r, k, v, log_w, u, s0):
    """`wkv6_plain`'s recurrence as a scan: (step, the float32 initial
    state, the per-chunk operands xs [n, ...] (r, k, v, log_w and u, each
    chunk's own view of u), n, finish), ``step(state, x) -> (state, o)``
    one chunk and ``finish`` the stacked chunk outputs [n, B, H, C, dk] to
    o [B, S, H, dk] in r's dtype."""
    b, s, h, dk = r.shape
    c = CHUNK
    pad = (-s) % c
    n = (s + pad) // c

    def chunks(t):                                   # -> [n, B, H, C, dk]
        t = _pad_chunks(t.float(), pad)
        return t.reshape(b, n, c, h, dk).permute(1, 0, 3, 2, 4)

    xs = (chunks(r), chunks(k), chunks(v), chunks(log_w),
          u.float().expand(n, h, dk))
    state = (torch.zeros((b, h, dk, dk), dtype=torch.float32,
                         device=r.device) if s0 is None else s0.float())
    tri = torch.tril(torch.ones((c, c), dtype=torch.bool, device=r.device),
                     diagonal=-1)[:, :, None]       # s < t
    eye = torch.eye(c, dtype=torch.float32, device=r.device)

    def step(state, x):
        rr, kk, vv, lw, uf = x
        p = torch.cumsum(lw, dim=2)                  # inclusive
        p_shift = p - lw                             # exclusive
        o = torch.einsum("bhtd,bhdv->bhtv", rr * torch.exp(p_shift), state)
        dec = torch.exp(torch.where(
            tri, p_shift[:, :, :, None, :] - p[:, :, None, :, :],
            -torch.inf))                             # [B, H, C(t), C(s), dk]
        a = (rr[:, :, :, None, :] * kk[:, :, None, :, :] * dec).sum(-1)
        diag = (rr * uf[None, :, None, :] * kk).sum(-1)
        a = a + diag[..., None] * eye
        o = o + torch.einsum("bhts,bhsv->bhtv", a, vv)
        p_last = p[:, :, -1:, :]
        k_dec = kk * torch.exp(p_last - p)
        state = state * torch.exp(p_last[:, :, 0, :])[..., None] \
            + torch.einsum("bhsd,bhsv->bhdv", k_dec, vv)
        return state, o

    def finish(o):
        o = o.permute(1, 0, 3, 2, 4).reshape(b, n * c, h, dk)
        return o[:, :s].to(r.dtype)

    return step, state, xs, n, finish


def wkv6_plain(r, k, v, log_w, u, s0=None):
    """r, k, v: [B, S, H, dk] (float32 or bfloat16, dv == dk); log_w: [B, S,
    H, dk] float32 (log of the decay, <= 0); u: [H, dk]; s0: [B, H, dk, dk]
    float32 or None (zeros) -> (o [B, S, H, dk] in r's dtype, sT [B, H, dk,
    dk] float32).

    Per chunk of 16 tokens, in float32 and in the reference's op order: the
    inter-chunk term (r·exp(p_shift)) @ S, the intra-chunk decay matrix per
    channel (strict lower triangle, every exponent <= 0, masked pairs
    exactly 0), the bonus diagonal r·(u∘k), and the state update.  A ragged
    last chunk is padded with log_w = 0 and zero r, k, v: the identity.
    """
    step, state, xs, n, finish = _wkv6_scan(r, k, v, log_w, u, s0)
    outs = []
    for i in range(n):
        state, o = step(state, [x[i] for x in xs])
        outs.append(o)
    return finish(torch.stack(outs)), state


def wkv6_checkpointed(r, k, v, log_w, u, s0=None):
    """`wkv6_plain`'s function, its own chunk step run under
    `models/scan_config.chunk_scan_checkpointed` as the reference's
    ``wkv6_chunked`` runs it: under grad only every SEGMENT-th incoming
    state is kept for the backward (where `kept_stride` says so), each
    segment recomputed in it.  The same bits as `wkv6_plain`, gradients
    too; the CPU route of the op under grad."""
    from repro_torch.models.scan_config import chunk_scan_checkpointed

    step, state, xs, n, finish = _wkv6_scan(r, k, v, log_w, u, s0)
    s_t, o = chunk_scan_checkpointed(step, state, xs, n, SEGMENT)
    return finish(o), s_t


def wkv6_bwd_plain(r, k, v, log_w, u, s0, do, dst=None):
    """The gradient of `wkv6_plain` at (r, k, v, log_w, u, s0) given the
    output's gradient ``do`` [B, S, H, dk] and the final state's ``dst``
    [B, H, dk, dk] (None: zeros; s0 None: a zero state), by PyTorch's
    autograd through the plain chunked forward: the oracle of
    `wkv6_bwd_cuda`, independent of its recipe.  Returns (dr, dk, dv,
    dlog_w, du, ds0), dr/dk/dv in r's dtype, the rest float32."""
    b, _, h, dk = r.shape
    return scan_vjp(wkv6_plain, (r, k, v, log_w, u), s0, (b, h, dk, dk), do,
                    dst)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("wkv6")
    fn = lib.wkv6_launch
    fn.argtypes = [_P] * 6 + [_I] + [_P] * 4 + [_I] * 9 + [_P]
    fn.restype = ctypes.c_int
    lib.wkv6_scratch_floats.argtypes = [_I] * 5
    lib.wkv6_scratch_floats.restype = ctypes.c_longlong
    return lib


@functools.lru_cache(maxsize=64)
def _scratch_floats(*shape) -> int:
    """Floats of float32 scratch the two passes share, per (b, chunks of
    the run, h, dk, bf16)."""
    return _lib().wkv6_scratch_floats(*shape)


def _check_inputs(name, r, k, v, log_w, u, s0):
    """Raise unless (r, k, v, log_w, u, s0) is what the kernels take."""
    dev = r.device
    tensors = (r, k, v, log_w, u) + (() if s0 is None else (s0,))
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"{name} takes CUDA tensors on one device")
    if r.dtype not in (torch.float32, torch.bfloat16) \
            or k.dtype != r.dtype or v.dtype != r.dtype:
        raise TypeError(f"{name} takes r, k, v all float32 or all bfloat16")
    if log_w.dtype != torch.float32 or u.dtype != torch.float32 \
            or (s0 is not None and s0.dtype != torch.float32):
        raise TypeError(f"{name} takes log_w, u and s0 in float32")
    if r.dim() != 4 or k.shape != r.shape or v.shape != r.shape \
            or log_w.shape != r.shape:
        raise ValueError(f"r, k, v, log_w must share one [B, S, H, dk] "
                         f"shape, got {tuple(r.shape)} / {tuple(k.shape)} / "
                         f"{tuple(v.shape)} / {tuple(log_w.shape)}")
    b, _, h, dk = r.shape
    if not 0 < dk <= MAX_HEAD_DIM:
        raise ValueError(f"head size {dk} is not in 1..{MAX_HEAD_DIM}")
    if tuple(u.shape) != (h, dk):
        raise ValueError(f"u {tuple(u.shape)} is not [H, dk] = {(h, dk)}")
    if s0 is not None and tuple(s0.shape) != (b, h, dk, dk):
        raise ValueError(f"s0 {tuple(s0.shape)} is not [B, H, dk, dk]")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} takes contiguous tensors")


def _stride_of(name: str, states, n: int) -> int:
    """The stride of the kept ``states`` [B, H, n_kept, ...] of an n-chunk
    call: 1 for every state, SEGMENT for the checkpoints where
    `kept_stride` keeps them; raises on any other count."""
    kept = states.shape[2] if states.dim() == 5 else -1
    if kept == n:
        return 1
    every = kept_stride(n)
    if every > 1 and kept == n // every:
        return every
    raise ValueError(f"{name}: {kept} kept states of {n} chunks: every "
                     f"state ({n}) or, where the sequence has a whole number "
                     f"of at least two segments of {SEGMENT}, every "
                     f"{SEGMENT}-th ({n // SEGMENT})")


# The backward from the checkpoints as a plan: rows (op, segment, stream,
# event) that `csrc/scan_ckpt.cuh` issues in one C call
# (`wkv6_bwd_ckpt_launch`, `ssd.ssd_bwd_ckpt_launch`), records and waits
# of events between four streams, each pass of a segment on its stream.
RECORD, WAIT, RECOMPUTE, REVERSE, CHUNK_PASS, SUMS = range(6)
CALLER, RECOMPUTE_STREAM, REVERSE_STREAM, CHUNK_STREAM = range(4)
# events: the fork, each op's two buffers' "done" (segment g's is g % 2),
# the three joins
FORK, RECOMPUTED, REVERSED, CHUNKED, JOINED = 0, 1, 3, 5, 7


@functools.cache
def checkpoint_plan(n_seg: int) -> tuple[tuple[int, int, int, int], ...]:
    """The launches of a backward from the checkpoints of ``n_seg``
    segments, in issue order, as rows (op, segment, stream, event; -1
    where the row has none).  Each side stream first waits for the
    caller's stream.  Then per segment g from the last: its states'
    recompute (RECOMPUTE_STREAM) and its reverse pass (REVERSE_STREAM,
    carrying dS down from segment g + 1) run side by side into buffer g %
    2 of the states and of dS, once segment g + 2's chunk pass, which read
    that buffer, is done; its chunk pass waits for both, on the caller's
    stream for even g and CHUNK_STREAM for odd, so that segment g - 1's
    recompute and reverse pass run under it and two chunk passes may
    overlap.  Last the caller's stream waits for every side stream and
    runs the sums."""
    side = (RECOMPUTE_STREAM, REVERSE_STREAM, CHUNK_STREAM)
    rows = [(RECORD, 0, CALLER, FORK)]
    rows += [(WAIT, 0, s, FORK) for s in side]
    for g in reversed(range(n_seg)):
        buf = g % 2
        for op, stream, done in ((RECOMPUTE, RECOMPUTE_STREAM, RECOMPUTED),
                                 (REVERSE, REVERSE_STREAM, REVERSED)):
            if g + 2 < n_seg:
                rows.append((WAIT, g, stream, CHUNKED + buf))
            rows += [(op, g, stream, -1), (RECORD, g, stream, done + buf)]
        stream = CHUNK_STREAM if buf else CALLER
        rows += [(WAIT, g, stream, RECOMPUTED + buf),
                 (WAIT, g, stream, REVERSED + buf),
                 (CHUNK_PASS, g, stream, -1),
                 (RECORD, g, stream, CHUNKED + buf)]
    for i, s in enumerate(side):
        rows += [(RECORD, 0, s, JOINED + i), (WAIT, 0, CALLER, JOINED + i)]
    rows.append((SUMS, 0, CALLER, -1))
    return tuple(rows)


@functools.cache
def plan_rows(n_seg: int) -> tuple[ctypes.Array, int]:
    """`checkpoint_plan` as the C call takes it: int32 rows, their count."""
    rows = checkpoint_plan(n_seg)
    return (_I * (4 * len(rows)))(*(x for row in rows for x in row)), \
        len(rows)


def wkv6_cuda(r, k, v, log_w, u, s0=None, *, return_states=False,
              keep_every=1):
    """The kernel: ``wkv6_plain``'s function on contiguous CUDA tensors of
    one device (r, k, v all float32 or all bfloat16; log_w, u and s0
    float32; dk <= 64), launched on the current stream as two kernels (no
    zero state is filled when s0 is None).  With ``return_states`` it also
    returns the incoming state of every ``keep_every``-th chunk from the
    first, float32 [B, H, n_chunks / keep_every, dk, dk] (what
    `wkv6_bwd_cuda` reads): every chunk's (1) or, where `kept_stride`
    checkpoints, every SEGMENT-th; o and sT are the same bits whatever is
    kept.  Raises on any other input and on a failed launch."""
    _check_inputs("wkv6_cuda", r, k, v, log_w, u, s0)
    b, s, h, dk = r.shape
    n = -(-s // CHUNK)
    if keep_every not in (1, kept_stride(n)):
        raise ValueError(f"wkv6_cuda: keep_every {keep_every} for {n} "
                         f"chunks: 1, or {SEGMENT} where kept_stride is")
    dev = r.device
    f32 = dict(dtype=torch.float32, device=dev)
    bf16 = r.dtype == torch.bfloat16
    o = torch.empty_like(r)
    s_t = torch.empty((b, h, dk, dk), **f32)
    states = (torch.empty((b, h, n // keep_every, dk, dk), **f32)
              if return_states else None)
    scratch = torch.empty(_scratch_floats(b, n, h, dk, int(bf16)), **f32)
    vec = bf16 and dk % 8 == 0 and v.data_ptr() % 16 == 0
    err = _lib().wkv6_launch(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), log_w.data_ptr(),
        u.data_ptr(), None if s0 is None else s0.data_ptr(), dk * dk,
        scratch.data_ptr(), o.data_ptr(), s_t.data_ptr(),
        None if states is None else states.data_ptr(), b, s, h, dk,
        int(bf16), int(vec), 0, n, keep_every,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"wkv6 kernel launch failed: CUDA error {err}")
    return (o, s_t, states) if return_states else (o, s_t)


@functools.cache
def _bwd_lib() -> ctypes.CDLL:
    lib = build.load("wkv6_bwd")
    lib.wkv6_bwd_launch.argtypes = [_P] * 15 + [_I] * 9 + [_P]
    lib.wkv6_bwd_launch.restype = ctypes.c_int
    lib.wkv6_bwd_du_launch.argtypes = [_P] * 2 + [_I] * 2 + [_P]
    lib.wkv6_bwd_du_launch.restype = ctypes.c_int
    lib.wkv6_bwd_ckpt_floats.argtypes = [_I] * 5
    lib.wkv6_bwd_ckpt_floats.restype = ctypes.c_longlong
    lib.wkv6_bwd_ckpt_launch.argtypes = [_P] * 16 + [_I] * 7 + [_P]
    lib.wkv6_bwd_ckpt_launch.restype = ctypes.c_int
    return lib


def wkv6_bwd_cuda(r, k, v, log_w, u, states, do, dst=None, want_ds0=False):
    """The gradient of `wkv6_cuda` (``csrc/wkv6_bwd.cu``): its inputs r, k,
    v, log_w, u as it took them, its kept ``states`` (``return_states``:
    every chunk's incoming state, or the checkpoints of ``keep_every``
    SEGMENT), the output's gradient ``do`` (r's dtype and shape) and the
    final state's ``dst`` (None: zeros, no buffer filled) -> (dr, dk, dv,
    dlog_w, du, ds0): dr/dk/dv in r's dtype, the rest float32, ds0 None
    unless ``want_ds0``.

    From every state: a reverse pass over the chunks and a chunk-parallel
    pass, their products on the tensor cores, then u's fixed-order sum,
    with a float32 scratch of one dk x dk matrix per chunk and head (each
    chunk's outgoing state gradient).  From the checkpoints, one C call
    (``wkv6_bwd_ckpt_launch``) issues `checkpoint_plan`: per segment of
    SEGMENT chunks from the last, the state-only recompute of its
    incoming states from its checkpoint beside its reverse pass, then its
    chunk pass, under which the earlier segment's recompute and reverse
    pass run; the float32 state and dS scratch is two segments' of each,
    in one workspace, and the result the same bits as from every state.
    Launched from the current stream, which every launch follows and
    precedes its later work.  Raises on any input the forward would
    refuse, on states, do or dst of another shape or type, and on a
    failed launch; nothing falls back to a plain version."""
    _check_inputs("wkv6_bwd_cuda", r, k, v, log_w, u, None)
    b, s, h, dk = r.shape
    n = -(-s // CHUNK)
    dev = r.device
    every = _stride_of("wkv6_bwd_cuda", states, n)
    shapes = {"states": (states, (b, h, n // every, dk, dk), torch.float32),
              "do": (do, tuple(r.shape), r.dtype)}
    if dst is not None:
        shapes["dst"] = (dst, (b, h, dk, dk), torch.float32)
    for name, (t, shape, dtype) in shapes.items():
        if tuple(t.shape) != shape or t.dtype != dtype or t.device != dev \
                or not t.is_contiguous():
            raise ValueError(f"wkv6_bwd_cuda: {name} {tuple(t.shape)} "
                             f"{t.dtype} is not a contiguous {dtype} {shape} "
                             f"on {dev}")
    dr, dk_, dv = (torch.empty_like(t) for t in (r, k, v))
    dlog_w = torch.empty_like(log_w)
    du = torch.empty_like(u)
    f32 = dict(dtype=torch.float32, device=dev)
    ds0 = torch.empty((b, h, dk, dk), **f32) if want_ds0 else None
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    bf16 = r.dtype == torch.bfloat16
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib = _bwd_lib()
    ins = [t.data_ptr() for t in (r, k, v, log_w, u, do, states)]
    outs = [t.data_ptr() for t in (dr, dk_, dv, dlog_w)]
    if every > 1:
        work = torch.empty(lib.wkv6_bwd_ckpt_floats(b, h, dk, n, int(bf16)),
                           **f32)
        plan, steps = plan_rows(n // every)
        err = lib.wkv6_bwd_ckpt_launch(
            *ins, ptr(dst), *outs, du.data_ptr(), ptr(ds0), work.data_ptr(),
            plan, steps, b, s, h, dk, int(bf16), dev.index, stream)
    else:
        dstates = torch.empty_like(states)
        du_part = torch.empty((b, n, h, dk), **f32)
        vec = bf16 and dk % 8 == 0 and all(
            t.data_ptr() % 16 == 0 for t in (r, k, v, do, log_w))
        vec_s = dk % 4 == 0 and states.data_ptr() % 16 == 0 \
            and dstates.data_ptr() % 16 == 0
        err = lib.wkv6_bwd_launch(
            *ins, ptr(dst), dstates.data_ptr(), du_part.data_ptr(), *outs,
            ptr(ds0), b, s, h, dk, 0, n, int(bf16), int(vec), int(vec_s),
            stream) or lib.wkv6_bwd_du_launch(
                du_part.data_ptr(), du.data_ptr(), b * n, h * dk, stream)
    if err != 0:
        raise RuntimeError(f"wkv6_bwd kernel launch failed: CUDA error {err}")
    return dr, dk_, dv, dlog_w, du, ds0
