"""One-token GQA attention against a contiguous KV cache (decode).

Every decode step of the serving engine runs this once per layer
(`models/attention.py::attend_decode`), with the validity mask built from
the cache's ``slot_pos`` on the device.  On the card it is the two
hand-written kernels in ``csrc/decode_attention.cu``: float32 (max,
sum-exp, weighted V) partials over contiguous slot ranges of the cache
(`split_plan`: about one wave of blocks), skipping ranges that hold no
valid slot, then a log-sum-exp combine.  ``decode_attention_plain`` is the
same function in plain PyTorch (`kernels/ref.py::decode_attention_ref`),
used for CPU tensors and as the kernels' oracle.
"""
from __future__ import annotations

import ctypes
import functools
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
TILE = 32            # slots per staged tile: a split is whole tiles
H100_SMS = 132


@functools.lru_cache(maxsize=None)
def split_plan(m: int, bhkv: int, sms: int = H100_SMS) -> tuple[int, int]:
    """(slots per split, splits) for a cache of ``m`` slots read by
    ``bhkv`` (batch, KV head) pairs on a card of ``sms`` SMs: split ``i``
    covers slots [i·chunk, min((i + 1)·chunk, m)), whole tiles of TILE
    slots, and bhkv·splits blocks make about one wave (at most ``sms``,
    unless bhkv alone exceeds it)."""
    tiles = -(-m // TILE)
    want = max(1, min(sms // bhkv, tiles))
    chunk = -(-tiles // want) * TILE
    return chunk, -(-m // chunk)


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _lib() -> ctypes.CDLL:
    lib = build.load("decode_attention")
    fn = lib.decode_attention_launch
    fn.argtypes = [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                   ctypes.c_float, _I, _P]
    fn.restype = ctypes.c_int
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
    chunk, splits = split_plan(m, b * hkv, _sms(dev.index))
    # one scratch tensor: m_part and l_part [b·hkv, splits, G], then
    # acc_part [b·hkv, splits, G, d], all float32
    n_part = b * hkv * splits * (h // hkv)
    scratch = torch.empty(n_part * (2 + d), dtype=torch.float32, device=dev)
    ptr = scratch.data_ptr()
    out = torch.empty_like(q)
    err = _lib().decode_attention_launch(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        valid.data_ptr(), ptr, ptr + 4 * n_part, ptr + 8 * n_part,
        out.data_ptr(), b, h, hkv, m, d, chunk, 1.0 / math.sqrt(d),
        int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: CUDA "
                           f"error {err}")
    return out
