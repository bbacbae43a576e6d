"""One-token GQA attention against a contiguous KV cache (decode).

Every decode step of the serving engine runs this once per layer
(`models/attention.py::attend_decode`), with the validity mask built from
the cache's ``slot_pos`` on the device.  On the card it is the two
hand-written kernels in ``csrc/decode_attention.cu``: per-piece float32
(max, sum-exp, weighted V) partials over 64-slot pieces of the cache, then
a log-sum-exp combine.  ``decode_attention_plain`` is the same function in
plain PyTorch (`kernels/ref.py::decode_attention_ref`), used for CPU
tensors and as the kernels' oracle.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import \
    decode_attention_ref as decode_attention_plain

__all__ = ["decode_attention_cuda", "decode_attention_plain"]

_P = ctypes.c_void_p
_I = ctypes.c_int
MAX_HEAD_DIM = 128
MAX_GROUP = 16


def _lib() -> ctypes.CDLL:
    lib = build.load("decode_attention")
    fn = lib.decode_attention_launch
    fn.argtypes = [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                   ctypes.c_float, _I, _P]
    fn.restype = ctypes.c_int
    lib.decode_attention_piece.argtypes = []
    lib.decode_attention_piece.restype = ctypes.c_int
    return lib


def decode_attention_cuda(q: torch.Tensor, k_cache: torch.Tensor,
                          v_cache: torch.Tensor,
                          valid: torch.Tensor) -> torch.Tensor:
    """q [B, H, d], k/v caches [B, M, Hkv, d] (all float32 or all bfloat16),
    valid [B, M] bool, contiguous CUDA tensors on one device (H a multiple
    of Hkv with H / Hkv <= 16, d <= 128, M >= 1) -> [B, H, d] of q's dtype,
    launched on the current stream.  Raises on any other input and on a
    failed launch."""
    dev = q.device
    if dev.type != "cuda" or any(t.device != dev
                                 for t in (k_cache, v_cache, valid)):
        raise ValueError("decode_attention_cuda takes CUDA tensors on one "
                         "device")
    if q.dtype not in (torch.float32, torch.bfloat16) \
            or k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        raise TypeError("decode_attention_cuda takes q and caches all "
                        "float32 or all bfloat16")
    if valid.dtype != torch.bool:
        raise TypeError("decode_attention_cuda takes a bool validity mask")
    if q.dim() != 3 or k_cache.dim() != 4 or v_cache.shape != k_cache.shape:
        raise ValueError(f"shapes {tuple(q.shape)} / {tuple(k_cache.shape)}"
                         f" / {tuple(v_cache.shape)} are not [B, H, d] / "
                         "[B, M, Hkv, d] twice")
    b, h, d = q.shape
    m, hkv = k_cache.shape[1], k_cache.shape[2]
    if k_cache.shape[0] != b or k_cache.shape[3] != d or hkv == 0 \
            or h % hkv or h // hkv > MAX_GROUP:
        raise ValueError(f"caches {tuple(k_cache.shape)} do not fit q "
                         f"{tuple(q.shape)} (H / Hkv <= {MAX_GROUP})")
    if not 0 < d <= MAX_HEAD_DIM or m == 0:
        raise ValueError(f"head dim {d} not in 1..{MAX_HEAD_DIM}, or an "
                         "empty cache")
    if valid.shape != (b, m):
        raise ValueError(f"valid {tuple(valid.shape)} is not [B, M] = "
                         f"{(b, m)}")
    if not all(t.is_contiguous() for t in (q, k_cache, v_cache, valid)):
        raise ValueError("decode_attention_cuda takes contiguous tensors")
    lib = _lib()
    pieces = -(-m // lib.decode_attention_piece())
    g = h // hkv
    m_part = torch.empty((b * hkv, pieces, g), dtype=torch.float32,
                         device=dev)
    l_part = torch.empty_like(m_part)
    acc_part = torch.empty((b * hkv, pieces, g, d), dtype=torch.float32,
                           device=dev)
    out = torch.empty_like(q)
    err = lib.decode_attention_launch(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        valid.data_ptr(), m_part.data_ptr(), l_part.data_ptr(),
        acc_part.data_ptr(), out.data_ptr(), b, h, hkv, m, d,
        1.0 / math.sqrt(d), int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: CUDA "
                           f"error {err}")
    return out
