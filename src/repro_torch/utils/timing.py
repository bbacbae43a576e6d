"""Timing helpers: the profiler-scope idiom shared by the router and the
auction layer, a lap timer and a median wall-clock timer of one call."""
from __future__ import annotations

import time
from contextlib import nullcontext

import torch


def phase_scope(profiler, name: str):
    """``profiler.phase(name)`` or a no-op context when no profiler is set.

    The one shared implementation of the serving-layer profiling idiom:
    the router and the auction layer call this instead of re-deriving the
    nullcontext dispatch (the profiler itself is duck-typed: anything with a
    ``phase(name)`` context manager).
    """
    return profiler.phase(name) if profiler is not None else nullcontext()


class Timer:
    def __init__(self):
        self.t0 = time.perf_counter()

    def lap(self) -> float:
        t = time.perf_counter()
        dt = t - self.t0
        self.t0 = t
        return dt


def _block_until_ready(out) -> None:
    """Wait for the CUDA streams of every tensor in ``out`` (a tensor or a
    nested tuple, list or dict of them); CPU tensors are ready already."""
    if isinstance(out, torch.Tensor):
        if out.is_cuda:
            torch.cuda.current_stream(out.device).synchronize()
    elif isinstance(out, dict):
        for v in out.values():
            _block_until_ready(v)
    elif isinstance(out, (list, tuple)):
        for v in out:
            _block_until_ready(v)


def bench_call(fn, *args, warmup: int = 2, iters: int = 5,
               block: bool = True) -> float:
    """Median wall-clock microseconds per call; with ``block`` each call
    ends when the CUDA stream of its result is done (the reference's
    ``jax.block_until_ready``)."""
    for _ in range(warmup):
        out = fn(*args)
        if block:
            _block_until_ready(out)
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        out = fn(*args)
        if block:
            _block_until_ready(out)
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2] * 1e6
