"""Analytic (virtual-time) serving engine for 100+-agent scale runs.

`AnalyticEngine` keeps the *semantics* the mechanism consumes from a real
engine — exact per-dialogue prefix-cache accounting (identical / extend /
fresh modes, LRU eviction over ``cache_slots`` sessions) — while service
times come from a roofline model instead of executing the matmuls:

    ttft          = (F0·layers + miss_tokens · f/R_prefill) / speed
    decode/token  = (D0 + f/R_decode) / speed

with ``f`` the per-token forward FLOPs of the agent's model class.  The
constants are the reference engine's (`repro.serving.analytic`), so both
packages produce the same completion feedback for the same requests.

Determinism: times are pure functions of (prompt, cache state, speed) and
generated tokens are a hash of (dialogue, prompt length, position) — an
analytic cluster replays bit-identically under a fixed seed regardless of
wall-clock, which is what the simulator's event-ordering determinism suite
relies on.
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass

import numpy as np

from repro_torch.configs.iemas_cluster import MODEL_CLASSES
from repro_torch.core.affinity import lcp_length

# model constants (see module docstring): per-layer fixed prefill cost,
# per-step decode dispatch cost, effective prefill / decode FLOP rates
F0_PER_LAYER = 1.5e-3     # s of fixed prefill cost per layer
D0_DECODE = 2.0e-3        # s of fixed cost per decode step
R_PREFILL = 17.0e9        # FLOP/s during batched prefill
R_DECODE = 0.24e9         # FLOP/s during single-token decode


def class_flops_per_token(model_class: str) -> float:
    """Per-token forward FLOPs of one reduced model class (attn + MLP)."""
    n_layers, d_model, _n_heads, d_ff, _scale = MODEL_CLASSES[model_class]
    return float(n_layers * (8 * d_model**2 + 4 * d_model * d_ff))


@dataclass
class ServeResult:
    """Outcome of one request: tokens, timings, cache accounting."""

    output_tokens: np.ndarray
    ttft: float               # seconds (scaled by agent speed)
    total_time: float
    n_prompt: int
    n_hit: int
    n_gen: int


@dataclass
class _Session:
    """Cached conversation state: the token sequence the cache encodes."""

    prompt: np.ndarray
    last_used: float = 0.0


class AnalyticEngine:
    """Serving engine with modeled (virtual) service times.

    Public surface: ``serve`` / ``warmup`` / ``drop_session`` / ``sessions``
    / ``cache_slots`` / ``recurrent``, as the reference's real engine.
    """

    def __init__(self, model_class: str, *, vocab: int = 255, seed: int = 0,
                 speed: float = 1.0, cache_slots: int = 12,
                 max_new_tokens: int = 8):
        self.model_class = model_class
        self.vocab = vocab
        self.seed = seed
        self.speed = speed
        self.cache_slots = cache_slots
        self.max_new = max_new_tokens
        self.recurrent = False        # all scale-config classes are attention
        self.sessions: dict[str, _Session] = {}
        self.evictions = 0
        n_layers = MODEL_CLASSES[model_class][0]
        self._f = class_flops_per_token(model_class)
        self._t_fixed = F0_PER_LAYER * n_layers
        self._t_prefill_tok = self._f / R_PREFILL
        self._t_decode_tok = D0_DECODE + self._f / R_DECODE

    def warmup(self, *args, **kwargs) -> None:
        """No-op: the analytic engine has nothing to pre-compile."""

    def _evict_lru(self, now: float) -> None:
        while len(self.sessions) > self.cache_slots:
            victim = min(self.sessions, key=lambda k: self.sessions[k].last_used)
            del self.sessions[victim]
            self.evictions += 1

    def _gen_token(self, dialogue_id: str, n_prompt: int, k: int) -> int:
        """Deterministic pseudo-token: hash of (dialogue, prompt len, pos)."""
        h = zlib.crc32(f"{self.seed}:{dialogue_id}:{n_prompt}:{k}".encode())
        return int(h % self.vocab) + 1

    def serve(self, dialogue_id: str, prompt: np.ndarray, now: float = 0.0,
              max_new_tokens: int | None = None,
              parents: tuple = ()) -> ServeResult:
        """Modeled serve: real cache accounting, roofline service times.
        ``parents`` names DAG parent-step session keys whose cached prefix
        may be forked, mirroring the real engine's handoff path."""
        prompt = np.asarray(prompt, dtype=np.int32)
        n_prompt = len(prompt)
        max_new = max_new_tokens or self.max_new
        sess = self.sessions.get(dialogue_id)
        if parents:
            # fork the warmest candidate (attention: longest common prefix)
            best = lcp_length(prompt, sess.prompt) if sess is not None else 0
            for pid in parents:
                ps = self.sessions.get(pid)
                if ps is not None and lcp_length(prompt, ps.prompt) > best:
                    best, sess = lcp_length(prompt, ps.prompt), ps

        # cache semantics — identical to AgentEngine's attention path
        n_hit = 0
        if sess is not None:
            l = lcp_length(prompt, sess.prompt)
            if l == n_prompt and l == len(sess.prompt):
                n_hit = l                      # identical: nothing to prefill
            elif l > 0:
                n_hit = l                      # extend past the common prefix

        miss = n_prompt - n_hit
        if miss > 0:
            ttft = self._t_fixed + miss * self._t_prefill_tok
        else:
            ttft = self._t_decode_tok          # one probe step, like the oracle
        total = ttft + max_new * self._t_decode_tok

        gen = np.array([self._gen_token(dialogue_id, n_prompt, k)
                        for k in range(max_new)], dtype=np.int32)
        full = np.concatenate([prompt, gen])
        self.sessions[dialogue_id] = _Session(full, last_used=now)
        self._evict_lru(now)
        return ServeResult(gen, ttft / self.speed, total / self.speed,
                           n_prompt, min(n_hit, n_prompt), len(gen))

    def drop_session(self, dialogue_id: str) -> None:
        """Forget one dialogue's cached state (mirror of the real engine)."""
        self.sessions.pop(dialogue_id, None)
