"""Causal / sliding-window GQA flash attention (prefill).

Every fresh prefill of the serving engine runs this once per layer
(`models/attention.py::attend_parallel`).  On the card it is the
hand-written ``csrc/flash_attention.cu``: bf16 inputs run on the tensor
cores (`mma.sync` over 64 x 64 tiles fed by a `cp.async` ring, float32
online softmax, P rounded to bf16 for P·V), float32 inputs on the CUDA
cores (float32 throughout); tiles above the diagonal or behind the window
are skipped.  ``flash_attention_plain`` is
the same function in plain PyTorch (`kernels/ref.py::attention_ref`), used
for CPU tensors and as the kernel's oracle.  Like the TPU kernel it masks
only keys at or past ``Sk`` (with the causal and window masks): a caller
with right-padded sequences relies on the causal mask to keep padding out
of the valid rows.

On request (``return_lse=True``, the training path) the forward also
returns each row's log-sum-exp, [B, H, Sq] float32 in natural-log units;
its output is the same bits either way.  ``attention_lse_ref`` is the
plain LSE, computed independently of the kernel.

Its gradient (training on the card) is ``csrc/flash_attention_bwd.cu``:
given q, k, v, the forward's o and LSE and the output's gradient dO, three
launches compute D = rowsum(dO ∘ O), then dK and dV per block of keys
(summed over the group's query heads) and dQ per block of queries, with no
atomics (two runs give the same bits): bf16 on the tensor cores (`mma.sync`
for all five pair products, P and dS rounded to bf16 as operands), float32
on the CUDA cores.  ``flash_attention_bwd_plain`` writes out the same
softmax-backward formulas in plain PyTorch, with its own softmax: the CPU's
version and the kernel's oracle.  `kernels/ops.py` puts the pair behind a
``torch.autograd.Function``.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import NEG_INF, attention_lse_ref, attention_mask
from repro_torch.kernels.ref import attention_ref as flash_attention_plain

__all__ = ["attention_lse_ref", "flash_attention_bwd_cuda",
           "flash_attention_bwd_plain", "flash_attention_cuda",
           "flash_attention_plain"]

_P = ctypes.c_void_p
_I = ctypes.c_int
MAX_HEAD_DIM = 128


def _lib() -> ctypes.CDLL:
    lib = build.load("flash_attention")
    fn = lib.flash_attention_launch
    fn.argtypes = [_P] * 5 + [_I] * 6 + [ctypes.c_float, _I, _I, _I, _P]
    fn.restype = ctypes.c_int
    return lib


def _check(name: str, q, k, v, window: int, *like_q) -> None:
    """The inputs both kernels take: q [B, Sq, H, d], k/v [B, Sk, Hkv, d]
    and ``like_q`` tensors of q's shape, contiguous CUDA tensors on one
    device, all float32 or all bfloat16; H a multiple of Hkv; d a multiple
    of 4 up to 128; with a window, Sq at most Sk.  Raises otherwise."""
    dev = q.device
    rest = (k, v, *like_q)
    if dev.type != "cuda" or any(t.device != dev for t in rest):
        raise ValueError(f"{name} takes CUDA tensors on one device")
    if q.dtype not in (torch.float32, torch.bfloat16) \
            or any(t.dtype != q.dtype for t in rest):
        raise TypeError(f"{name} takes inputs all float32 or all bfloat16")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape \
            or any(t.shape != q.shape for t in like_q):
        raise ValueError(f"shapes {tuple(q.shape)} / {tuple(k.shape)} / "
                         f"{tuple(v.shape)} are not [B, Sq, H, d] / "
                         "[B, Sk, Hkv, d] twice (o, dO as q)")
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != d or hkv == 0 or h % hkv:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q "
                         f"{tuple(q.shape)}")
    if d % 4 or not 0 < d <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} is not a multiple of 4 in "
                         f"4..{MAX_HEAD_DIM}")
    if window and sq > sk:
        raise ValueError("a sliding window needs Sq <= Sk")
    if not all(t.is_contiguous() for t in (q, *rest)):
        raise ValueError(f"{name} takes contiguous tensors")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int = 0,
                         return_lse: bool = False):
    """q [B, Sq, H, d], k/v [B, Sk, Hkv, d] (contiguous CUDA tensors on one
    device, all float32 or all bfloat16; H a multiple of Hkv; d a multiple
    of 4 up to 128) -> [B, Sq, H, d] of q's dtype, launched on the current
    stream; with ``return_lse``, (output, lse) where lse [B, H, Sq] float32
    holds each row's natural-log log-sum-exp of its scaled, unmasked scores
    (the output is the same bits either way).  With a window, Sq may not
    exceed Sk (a row with no valid key is not defined).  Raises on any
    other input and on a failed launch."""
    _check("flash_attention_cuda", q, k, v, window)
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    if q.dtype == torch.bfloat16:     # the tensor-core kernel's 16-byte copies
        q, k, v = (t if t.data_ptr() % 16 == 0 else t.clone()
                   for t in (q, k, v))
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device) \
        if return_lse else None
    err = _lib().flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr() if return_lse else None, b, sq, sk, h, hkv, d,
        1.0 / math.sqrt(d), int(causal), int(window),
        int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    return (out, lse) if return_lse else out


def _bwd_lib() -> ctypes.CDLL:
    lib = build.load("flash_attention_bwd")
    fn = lib.flash_attention_bwd_launch
    fn.argtypes = [_P] * 10 + [_I] * 6 + [ctypes.c_float, _I, _I, _I, _P]
    fn.restype = ctypes.c_int
    return lib


def flash_attention_bwd_cuda(q, k, v, o, do, lse, *, causal: bool = True,
                             window: int = 0):
    """The gradient of `flash_attention_cuda`: q, o, dO [B, Sq, H, d], k/v
    [B, Sk, Hkv, d], taken as the forward takes them, and the forward's
    ``lse`` ([B, H, Sq] float32, from ``return_lse=True``) -> (dQ, dK, dV)
    in the inputs' dtype, launched on the current stream (three kernels;
    one float32 scratch value per query row and head).  Raises on any
    input the forward would refuse, on an lse of another shape or type, and
    on a failed launch."""
    _check("flash_attention_bwd_cuda", q, k, v, window, o, do)
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    if b * h > 65535:
        raise ValueError(f"B·H = {b * h} exceeds the kernel's grid (65535)")
    if lse.shape != (b, h, sq) or lse.dtype != torch.float32 \
            or lse.device != q.device or not lse.is_contiguous():
        raise ValueError(f"lse {tuple(lse.shape)} {lse.dtype} is not the "
                         f"forward's contiguous float32 [{b}, {h}, {sq}]")
    if q.numel() == 0 or k.numel() == 0:
        return tuple(torch.zeros_like(t) for t in (q, k, v))
    q, k, v, o, do = (t if t.data_ptr() % 16 == 0 else t.clone()
                      for t in (q, k, v, o, do))     # 16-byte loads
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    err = _bwd_lib().flash_attention_bwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), b, sq, sk, h, hkv, d,
        1.0 / math.sqrt(d), int(causal), int(window),
        int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd kernel launch failed: CUDA "
                           f"error {err}")
    return dq, dk, dv


def flash_attention_bwd_plain(q, k, v, o, do, lse=None, *,
                              causal: bool = True, window: int = 0):
    """The gradient of `flash_attention_plain` at (q, k, v) given its output
    o and the output's gradient dO, in float32, as the kernel computes it:
    P from the masked scores (a masked pair is -1e30, so its P is 0),
    D = rowsum(dO ∘ O), dS = P ∘ (dO·Vᵀ − D), dQ = scale·dS·K,
    dK = scale·dSᵀ·Q and dV = Pᵀ·dO, summed over each KV head's group.
    ``lse``, the forward kernel's, is taken for the kernel's signature and
    not read: this oracle computes its own softmax.  Returns (dQ, dK, dV)
    in the inputs' dtype."""
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    scale = 1.0 / math.sqrt(d)
    qg, og, dog = (t.reshape(b, sq, hkv, g, d).float() for t in (q, o, do))
    kf, vf = k.float(), v.float()
    mask = attention_mask(sq, sk, causal=causal, window=window,
                          device=q.device)
    s = torch.einsum("bskgd,btkd->bkgst", qg, kf) * scale
    p = torch.softmax(torch.where(mask, s, NEG_INF), dim=-1)
    dp = torch.einsum("bskgd,btkd->bkgst", dog, vf)
    delta = (dog * og).sum(-1).permute(0, 2, 3, 1)[..., None]  # [B,Kv,G,Sq,1]
    ds = p * (dp - delta)
    dq = torch.einsum("bkgst,btkd->bskgd", ds, kf) * scale
    dk = torch.einsum("bkgst,bskgd->btkd", ds, qg) * scale
    dv = torch.einsum("bkgst,bskgd->btkd", p, dog)
    return (dq.reshape(b, sq, h, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))
