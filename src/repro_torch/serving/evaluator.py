"""Response-quality evaluation (ground truth for the performance predictor).

Two evaluators, mirroring Appendix C.2.5:
  * TokenSpanEvaluator — deterministic: does the gold token span appear as a
    contiguous subsequence of the output? (exact reproduction of the paper's
    TokenSpanCoqaEvaluator at token level).
  * SimulatedSkillEvaluator — the reduced models (random weights) generate
    noise, so the quality signal is drawn from a (domain x agent-scale)
    skill matrix modulated by request difficulty. This preserves the
    statistical structure the predictor must learn.

A copy of the reference's `repro.serving.evaluator`: the generator is drawn
in the same order, so a cluster seeded alike scores every request alike.
"""
from __future__ import annotations

import numpy as np


class TokenSpanEvaluator:
    """Deterministic span-match evaluator (paper's TokenSpanCoqaEvaluator)."""

    def score(self, output_tokens, gold_tokens) -> float:
        """1.0 iff the gold span occurs contiguously in the output."""
        o = np.asarray(output_tokens)
        g = np.asarray(gold_tokens)
        if len(g) == 0 or len(o) < len(g):
            return 0.0
        for s in range(len(o) - len(g) + 1):
            if np.array_equal(o[s : s + len(g)], g):
                return 1.0
        return 0.0


class SimulatedSkillEvaluator:
    """P(correct) = sigmoid(a*scale + b*domain_match - c*difficulty)."""

    def __init__(self, seed: int = 0, a=0.18, b=1.2, c=2.2, bias=0.2):
        self.rng = np.random.default_rng(seed)
        self.a, self.b, self.c, self.bias = a, b, c, bias

    def prob_correct(self, agent_scale: float, domain_match: bool,
                     difficulty: float) -> float:
        """Correctness probability from the (scale, domain, difficulty) skill model."""
        z = (self.a * agent_scale + self.b * float(domain_match)
             - self.c * difficulty + self.bias)
        return float(1.0 / (1.0 + np.exp(-z)))

    def score(self, agent_scale: float, domain_match: bool,
              difficulty: float) -> float:
        """One Bernoulli quality draw at ``prob_correct``."""
        return float(self.rng.random()
                     < self.prob_correct(agent_scale, domain_match, difficulty))
