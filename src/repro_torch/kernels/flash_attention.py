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
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import attention_ref as flash_attention_plain

__all__ = ["flash_attention_cuda", "flash_attention_plain"]

_P = ctypes.c_void_p
_I = ctypes.c_int
MAX_HEAD_DIM = 128


def _lib() -> ctypes.CDLL:
    lib = build.load("flash_attention")
    fn = lib.flash_attention_launch
    fn.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, ctypes.c_float,
                   _I, _I, _I, _P]
    fn.restype = ctypes.c_int
    return lib


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True,
                         window: int = 0) -> torch.Tensor:
    """q [B, Sq, H, d], k/v [B, Sk, Hkv, d] (contiguous CUDA tensors on one
    device, all float32 or all bfloat16; H a multiple of Hkv; d a multiple
    of 4 up to 128) -> [B, Sq, H, d] of q's dtype, launched on the current
    stream.  With a window, Sq may not exceed Sk (a row with no valid key
    is not defined).  Raises on any other input and on a failed launch."""
    dev = q.device
    if dev.type != "cuda" or k.device != dev or v.device != dev:
        raise ValueError("flash_attention_cuda takes CUDA tensors on one "
                         "device")
    if q.dtype not in (torch.float32, torch.bfloat16) \
            or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash_attention_cuda takes q, k, v all float32 or "
                        "all bfloat16")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"shapes {tuple(q.shape)} / {tuple(k.shape)} / "
                         f"{tuple(v.shape)} are not [B, Sq, H, d] / "
                         "[B, Sk, Hkv, d] twice")
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
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention_cuda takes contiguous tensors")
    if q.dtype == torch.bfloat16:     # the tensor-core kernel's 16-byte copies
        q, k, v = (t if t.data_ptr() % 16 == 0 else t.clone()
                   for t in (q, k, v))
    out = torch.empty_like(q)
    err = _lib().flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, sq, sk,
        h, hkv, d, 1.0 / math.sqrt(d), int(causal), int(window),
        int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    return out
