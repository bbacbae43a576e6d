"""Token-level cost accounting (Eq. 6) and cost prediction helpers.

    C_ij_obs = pi_miss * (n_prompt - n_hit) + pi_hit * n_hit + pi_out * n_gen

The serving engine reports exact (n_prompt, n_hit, n_gen) per request
(ground truth for the cost predictor); the router predicts n_hit from the
ledger affinity and n_gen from history.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class TokenPrices:
    """Per-token prices: uncached prompt (miss), cached (hit), generated."""

    miss: float
    hit: float
    out: float


def observed_cost(prices: TokenPrices, n_prompt: int, n_hit: int,
                  n_gen: int) -> float:
    """Exact Eq.-6 cost from the engine-reported token counts."""
    n_hit = min(n_hit, n_prompt)
    return (prices.miss * (n_prompt - n_hit)
            + prices.hit * n_hit
            + prices.out * n_gen)


def predicted_cost(prices: TokenPrices, n_prompt: int, affinity: float,
                   expected_gen: float) -> float:
    """Structural cost prior from the affinity score (used to seed the
    Hoeffding cost predictor and as its cold-start fallback)."""
    n_hit = affinity * n_prompt
    return (prices.miss * (n_prompt - n_hit)
            + prices.hit * n_hit
            + prices.out * expected_gen)
