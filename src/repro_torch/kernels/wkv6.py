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

__all__ = ["CHUNK", "wkv6_bwd_cuda", "wkv6_bwd_plain", "wkv6_cuda",
           "wkv6_plain"]

CHUNK = 16
MAX_HEAD_DIM = 64
_P = ctypes.c_void_p
_I = ctypes.c_int


def _pad_chunks(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Zero rows appended along dim 1 (the sequence)."""
    if not pad:
        return x
    return F.pad(x, (0, 0) * (x.dim() - 2) + (0, pad))


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
    b, s, h, dk = r.shape
    c = CHUNK
    pad = (-s) % c
    n = (s + pad) // c

    def chunks(t):                                   # -> [n, B, H, C, dk]
        t = _pad_chunks(t.float(), pad)
        return t.reshape(b, n, c, h, dk).permute(1, 0, 3, 2, 4)

    rc, kc, vc, lwc = chunks(r), chunks(k), chunks(v), chunks(log_w)
    uf = u.float()
    state = (torch.zeros((b, h, dk, dk), dtype=torch.float32,
                         device=r.device) if s0 is None else s0.float())
    tri = torch.tril(torch.ones((c, c), dtype=torch.bool, device=r.device),
                     diagonal=-1)[:, :, None]       # s < t
    eye = torch.eye(c, dtype=torch.float32, device=r.device)
    outs = []
    for i in range(n):
        rr, kk, vv, lw = rc[i], kc[i], vc[i], lwc[i]
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
        outs.append(o)
    o = torch.stack(outs).permute(1, 0, 3, 2, 4).reshape(b, n * c, h, dk)
    return o[:, :s].to(r.dtype), state


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
    fn.argtypes = [_P] * 10 + [_I] * 6 + [_P]
    fn.restype = ctypes.c_int
    lib.wkv6_scratch_floats.argtypes = [_I] * 5
    lib.wkv6_scratch_floats.restype = ctypes.c_longlong
    return lib


@functools.lru_cache(maxsize=64)
def _scratch_floats(*shape) -> int:
    """Floats of float32 scratch the two passes share, per call shape."""
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


def wkv6_cuda(r, k, v, log_w, u, s0=None, *, return_states=False):
    """The kernel: ``wkv6_plain``'s function on contiguous CUDA tensors of
    one device (r, k, v all float32 or all bfloat16; log_w, u and s0
    float32; dk <= 64), launched on the current stream as two kernels (no
    zero state is filled when s0 is None).  With ``return_states`` it also
    returns each chunk's incoming state, float32 [B, H, n_chunks, dk, dk]
    (what `wkv6_bwd_cuda` reads), with o and sT the same bits as without.
    Raises on any other input and on a failed launch."""
    _check_inputs("wkv6_cuda", r, k, v, log_w, u, s0)
    dev = r.device
    b, s, h, dk = r.shape
    lib = _lib()
    o = torch.empty_like(r)
    s_t = torch.empty((b, h, dk, dk), dtype=torch.float32, device=dev)
    states = (torch.empty((b, h, -(-s // CHUNK), dk, dk), dtype=torch.float32,
                          device=dev) if return_states else None)
    bf16 = r.dtype == torch.bfloat16
    scratch = torch.empty(_scratch_floats(b, s, h, dk, int(bf16)),
                          dtype=torch.float32, device=dev)
    vec = bf16 and dk % 8 == 0 and v.data_ptr() % 16 == 0
    err = lib.wkv6_launch(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), log_w.data_ptr(),
        u.data_ptr(), None if s0 is None else s0.data_ptr(),
        scratch.data_ptr(), o.data_ptr(), s_t.data_ptr(),
        None if states is None else states.data_ptr(), b, s, h, dk,
        int(bf16), int(vec), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"wkv6 kernel launch failed: CUDA error {err}")
    return (o, s_t, states) if return_states else (o, s_t)


@functools.cache
def _bwd_lib() -> ctypes.CDLL:
    lib = build.load("wkv6_bwd")
    lib.wkv6_bwd_launch.argtypes = [_P] * 16 + [_I] * 7 + [_P]
    lib.wkv6_bwd_launch.restype = ctypes.c_int
    return lib


def wkv6_bwd_cuda(r, k, v, log_w, u, states, s_t, do, dst=None,
                  want_ds0=False):
    """The gradient of `wkv6_cuda` (``csrc/wkv6_bwd.cu``): its inputs r, k,
    v, log_w, u as it took them, its ``states`` (``return_states=True``)
    and final state ``s_t`` (checked; the kernel forms Σ S_out∘dS_out from
    each chunk's incoming state instead of reading the next one), the
    output's gradient ``do`` (r's dtype and shape) and the final state's
    ``dst`` (None: zeros, no buffer filled) -> (dr, dk, dv, dlog_w, du,
    ds0): dr/dk/dv in r's dtype, the rest float32, ds0 None unless
    ``want_ds0``.  Launched on the current stream as three kernels (a
    reverse pass over the chunks and a chunk-parallel pass, their products
    on the tensor cores, then u's fixed-order sum), with a float32 scratch
    of one dk x dk matrix per chunk and head (each chunk's outgoing state
    gradient).  Raises on any input the forward would refuse, on states,
    s_t, do or dst of another shape or type, and on a failed launch."""
    _check_inputs("wkv6_bwd_cuda", r, k, v, log_w, u, None)
    b, s, h, dk = r.shape
    n = -(-s // CHUNK)
    dev = r.device
    shapes = {"states": (states, (b, h, n, dk, dk), torch.float32),
              "s_t": (s_t, (b, h, dk, dk), torch.float32),
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
    ds0 = (torch.empty((b, h, dk, dk), dtype=torch.float32, device=dev)
           if want_ds0 else None)
    dstates = torch.empty_like(states)
    du_part = torch.empty((b, n, h, dk), dtype=torch.float32, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    bf16 = r.dtype == torch.bfloat16
    vec = bf16 and dk % 8 == 0 and all(
        t.data_ptr() % 16 == 0 for t in (r, k, v, do, log_w))
    vec_s = dk % 4 == 0 and states.data_ptr() % 16 == 0 \
        and dstates.data_ptr() % 16 == 0
    err = _bwd_lib().wkv6_bwd_launch(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), log_w.data_ptr(),
        u.data_ptr(), do.data_ptr(), states.data_ptr(), ptr(dst),
        dstates.data_ptr(), du_part.data_ptr(), dr.data_ptr(),
        dk_.data_ptr(), dv.data_ptr(), dlog_w.data_ptr(), du.data_ptr(),
        ptr(ds0), b, s, h, dk, int(bf16), int(vec), int(vec_s),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"wkv6_bwd kernel launch failed: CUDA error {err}")
    return dr, dk_, dv, dlog_w, du, ds0
