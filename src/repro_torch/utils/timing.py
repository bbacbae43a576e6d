"""The profiler-scope idiom shared by the router and the auction layer."""
from __future__ import annotations

from contextlib import nullcontext


def phase_scope(profiler, name: str):
    """``profiler.phase(name)`` or a no-op context when no profiler is set.

    The one shared implementation of the serving-layer profiling idiom:
    the router and the auction layer call this instead of re-deriving the
    nullcontext dispatch (the profiler itself is duck-typed: anything with a
    ``phase(name)`` context manager).
    """
    return profiler.phase(name) if profiler is not None else nullcontext()
