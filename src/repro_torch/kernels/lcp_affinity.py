"""Batched longest-common-prefix (the router's Eq.-4 affinity hot loop).

The router computes an N x M LCP matrix per micro-batch: every request
against its session's prefix-ledger row at every agent.  On the card this is
the hand-written kernel in ``csrc/lcp_affinity.cu`` (one warp per pair,
stopping at the first mismatch); ``lcp_affinity_plain`` is the same function
in plain PyTorch (`kernels/ref.py`), used for CPU tensors and as the
kernel's oracle.  The signature keeps the JAX kernel's dense ``[N, M, L]``
ledger layout, padded with -1 (prompts) and -2 (ledgers) so padding never
matches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import lcp_ref as lcp_affinity_plain

__all__ = ["lcp_affinity_cuda", "lcp_affinity_plain"]

_P = ctypes.c_void_p


def _lib() -> ctypes.CDLL:
    lib = build.load("lcp_affinity")
    fn = lib.lcp_affinity_launch
    fn.argtypes = [_P, _P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_int, _P]
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
