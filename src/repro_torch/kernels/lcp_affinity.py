"""Batched longest-common-prefix (the router's Eq.-4 affinity hot loop).

The router computes an N x M LCP matrix per micro-batch: every request
against its session's prefix-ledger row at every agent.  Two forms, each a
hand-written kernel in ``csrc/lcp_affinity.cu`` (one warp per pair,
stopping at the first mismatch) beside its plain PyTorch version
(`kernels/ref.py`, used for CPU tensors and as the kernel's oracle):

* ``lcp_affinity``: the JAX kernel's dense ``[N, M, L]`` ledger tile;
* ``lcp_gather``: the ledger rows gathered by index from an arena
  ``[S, La]`` that stays on the device (the router's main path; row 0 is
  the all-pad sentinel), the prompt staged once per request.

Padding is -1 in prompts and -2 in ledgers, so it never matches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import lcp_gather_ref as lcp_gather_plain
from repro_torch.kernels.ref import lcp_ref as lcp_affinity_plain

__all__ = ["lcp_affinity_cuda", "lcp_affinity_plain", "lcp_gather_cuda",
           "lcp_gather_plain"]

_P = ctypes.c_void_p


def _lib() -> ctypes.CDLL:
    lib = build.load("lcp_affinity")
    fn = lib.lcp_affinity_launch
    fn.argtypes = [_P, _P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_int, _P]
    fn.restype = ctypes.c_int
    fn = lib.lcp_gather_launch
    fn.argtypes = [_P, _P, _P, _P] + [ctypes.c_int] * 4 + [_P]
    fn.restype = ctypes.c_int
    return lib


def lcp_affinity_cuda(prompts: torch.Tensor,
                      ledgers: torch.Tensor) -> torch.Tensor:
    """prompts [N, L] int32, ledgers [N, M, L] int32 (both contiguous CUDA
    tensors on one device) -> lcp [N, M] int32, launched on the current
    stream.  Raises on any other input and on a failed launch."""
    if prompts.device.type != "cuda" or ledgers.device != prompts.device:
        raise ValueError("lcp_affinity_cuda takes CUDA tensors on one device")
    if prompts.dtype != torch.int32 or ledgers.dtype != torch.int32:
        raise TypeError("lcp_affinity_cuda takes int32 tokens")
    if prompts.dim() != 2 or ledgers.dim() != 3 \
            or ledgers.shape[0] != prompts.shape[0] \
            or ledgers.shape[2] != prompts.shape[1]:
        raise ValueError(f"shapes {tuple(prompts.shape)} / "
                         f"{tuple(ledgers.shape)} are not [N, L] / [N, M, L]")
    if not (prompts.is_contiguous() and ledgers.is_contiguous()):
        raise ValueError("lcp_affinity_cuda takes contiguous tensors")
    n, length = prompts.shape
    m = ledgers.shape[1]
    out = torch.empty((n, m), dtype=torch.int32, device=prompts.device)
    err = _lib().lcp_affinity_launch(
        prompts.data_ptr(), ledgers.data_ptr(), out.data_ptr(), n, m, length,
        torch.cuda.current_stream(prompts.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"lcp_affinity kernel launch failed: CUDA error "
                           f"{err}")
    return out


def lcp_gather_cuda(prompts: torch.Tensor, arena: torch.Tensor,
                    rows: torch.Tensor) -> torch.Tensor:
    """prompts [N, Lp] int32, arena [S, La] int32, rows [N, M] int32 (row
    indices into the arena; contiguous CUDA tensors on one device) -> lcp
    [N, M] int32, launched on the current stream.  Raises on any other
    input and on a failed launch."""
    dev = prompts.device
    if dev.type != "cuda" or arena.device != dev or rows.device != dev:
        raise ValueError("lcp_gather_cuda takes CUDA tensors on one device")
    if any(t.dtype != torch.int32 for t in (prompts, arena, rows)):
        raise TypeError("lcp_gather_cuda takes int32 tokens and rows")
    if prompts.dim() != 2 or arena.dim() != 2 or rows.dim() != 2 \
            or rows.shape[0] != prompts.shape[0]:
        raise ValueError(f"shapes {tuple(prompts.shape)} / "
                         f"{tuple(arena.shape)} / {tuple(rows.shape)} are "
                         "not [N, Lp] / [S, La] / [N, M]")
    if not all(t.is_contiguous() for t in (prompts, arena, rows)):
        raise ValueError("lcp_gather_cuda takes contiguous tensors")
    n, lp = prompts.shape
    m = rows.shape[1]
    out = torch.empty((n, m), dtype=torch.int32, device=dev)
    err = _lib().lcp_gather_launch(
        prompts.data_ptr(), arena.data_ptr(), rows.data_ptr(), out.data_ptr(),
        n, m, lp, arena.shape[1], torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"lcp_gather kernel launch failed: CUDA error "
                           f"{err}")
    return out
