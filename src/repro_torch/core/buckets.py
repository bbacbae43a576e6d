"""Power-of-two shape buckets.

The prefix-ledger arena (`core/affinity.PaddedLedgerStore`) and the
Hoeffding forests grow their array dimensions by power-of-two doubling, so
the shapes that reach device code change O(log) times over a run instead of
per batch.  Kept stdlib-only.
"""
from __future__ import annotations


def pow2_bucket(x: int, floor: int = 8) -> int:
    """Smallest power of two >= max(x, floor)."""
    return 1 << (max(int(x), floor) - 1).bit_length()
