"""Client valuation (Eq. 1) and welfare weights.

    v_j = delta * P_j(T_j, S_i, K_i) - (1 - delta) * L_j(T_j, S_i, o_ij)

P is the predicted quality in [0, 1]; L is the predicted latency normalized
by ``latency_scale`` so both terms live in comparable units, then scaled to
currency by ``value_scale`` (the client's willingness to pay for a perfect,
instant answer).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class ValuationConfig:
    """Eq.-1 knobs: quality/latency trade-off and currency scaling."""

    delta: float = 0.7          # quality-vs-latency preference
    latency_scale: float = 1.0  # seconds at which latency penalty ~ 1
    value_scale: float = 10.0   # currency per unit of valuation


def client_value(pred_quality, pred_latency, cfg: ValuationConfig):
    """Vectorized Eq. 1. Inputs broadcast; returns same-shape valuations."""
    p = np.clip(np.asarray(pred_quality, dtype=np.float64), 0.0, 1.0)
    l_norm = np.asarray(pred_latency, dtype=np.float64) / cfg.latency_scale
    v = cfg.delta * p - (1.0 - cfg.delta) * l_norm
    return cfg.value_scale * v


def welfare_weights(values: np.ndarray, costs: np.ndarray) -> np.ndarray:
    """w_ij = v_ij - c_ij, pruned at 0 (Algorithm 1 line 11)."""
    w = np.asarray(values, dtype=np.float64) - np.asarray(costs, dtype=np.float64)
    return np.where(w > 0, w, 0.0)
