"""Per-agent inference engine: real prefill / extend / decode with KV reuse.

The port of the reference's `repro.serving.engine`.  An engine runs one
model of the port (`repro_torch.models`: the attention decoder, dense or
MoE, GQA or MLA; RWKV-6, zamba2 or the encoder-decoder) on its
``device`` (default ``"cuda"``: the hand-written kernels; ``"cpu"``:
their plain versions), keeps per-dialogue caches (LRU over
``cache_slots`` sessions, the paper's constrained-memory regime) and
measures:

  * TTFT    — host seconds of the prefill / extend path, ending in a
              ``torch.cuda.synchronize()`` on a card, scaled by the agent's
              hardware ``speed``;
  * n_hit   — exactly how many prompt tokens were served from cache
              (whole-prefix reuse truncated to the LCP for attention;
              exact extension of the stored prompt for the recurrent
              families, whose state cannot be truncated);
  * n_gen   — generated tokens (greedy).

Routing with affinity -> more cached tokens -> less prefill -> lower TTFT
and cost: the paper's causal chain, physically.  Attention prompt lengths
are bucketed to powers of two, as in the reference (there to bound jit
retraces; here they fix the kernels' shapes); a recurrent state cannot
mask padding, so recurrent prompts and extends run at their exact length.

As in the reference, an encoder-decoder's fresh prefill gets zero
frames, and a patch-input model is served on its text alone; an
encoder-decoder turn that needs ``extend`` raises, as the reference's
engine does (ROADMAP §3).

Caches are never written in place: the model's functions return new cache
tensors (`models/attention.py`), truncation builds a new dict, so forking
a DAG parent's session and the no-op decode of the all-cached path leave
every stored session exactly as it was.
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.affinity import lcp_length
from repro_torch.models import build_model
from repro_torch.utils.device import resolve_device


def _bucket(n: int, lo: int = 16) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


@dataclass
class SessionCache:
    """One dialogue's cached model state + the prompt it encodes."""

    cache: dict               # model cache (B = 1)
    prompt: np.ndarray        # tokens whose state the cache encodes
    last_used: float = 0.0


@dataclass
class ServeResult:
    """Measured outcome of one request: tokens, timings, cache accounting."""

    output_tokens: np.ndarray
    ttft: float               # seconds (scaled by agent speed)
    total_time: float
    n_prompt: int
    n_hit: int
    n_gen: int


class AgentEngine:
    """One agent's inference engine (see module docstring).

    Weights: ``params`` (a `ParamTree`, for example carried from the
    reference by `repro_torch.models.carry`) moved to ``device``, or else
    drawn on ``device`` from a ``torch.Generator`` seeded with ``seed``.
    The two inits give different numbers for the same seed: the port's
    generator is not the reference's ``jax.random`` key.
    """

    def __init__(self, cfg: ModelConfig, *, seed: int = 0, speed: float = 1.0,
                 cache_slots: int = 6, max_len: int = 1024,
                 max_new_tokens: int = 8, device="cuda", params=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = build_model(cfg)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = self.model.init(gen)
        self.params = params.to(self.device)
        self.speed = speed
        self.cache_slots = cache_slots
        self.max_len = max_len
        self.max_new = max_new_tokens
        self.sessions: dict[str, SessionCache] = {}
        self.recurrent = self.model.family in ("rwkv", "zamba")
        self.evictions = 0

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _tokens(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)) \
            .to(self.device)

    def warmup(self, prefill_buckets=(32, 64, 128, 256, 512),
               extend_buckets=(16, 32, 64)) -> None:
        """Serve each shape bucket once, so that TTFT excludes first-call
        costs (kernel builds, allocator growth)."""
        for b in prefill_buckets:
            if b > self.max_len:
                continue
            self.serve("__warm__", np.arange(1, b + 1, dtype=np.int32) %
                       (self.cfg.vocab_size - 1) + 1, max_new_tokens=1)
        for b in extend_buckets:
            ext = np.arange(1, b, dtype=np.int32) % (self.cfg.vocab_size - 1) + 1
            prev = self.sessions.get("__warm__")
            if prev is None:
                continue
            self.serve("__warm__", np.concatenate([prev.prompt, ext]),
                       max_new_tokens=1)
        self.drop_session("__warm__")

    # ---------------- cache management ----------------
    def _evict_lru(self, now: float):
        while len(self.sessions) > self.cache_slots:
            victim = min(self.sessions,
                         key=lambda k: self.sessions[k].last_used)
            del self.sessions[victim]
            self.evictions += 1

    def _truncate(self, cache: dict, keep: int) -> dict:
        """The cache to extend from: for attention a new cache dict with
        positions >= keep invalidated (the stored one is left as it was); a
        recurrent state as it is (its hit is always the whole stored
        prompt)."""
        if self.recurrent:
            return cache
        new = dict(cache)
        sp = cache["slot_pos"]
        new["slot_pos"] = torch.where(sp < keep, sp, -1)
        new["pos"] = torch.full_like(cache["pos"], keep)
        return new

    def _session_hit(self, prompt: np.ndarray, sess: SessionCache) -> int:
        """Cached prompt tokens this session would grant: attention reuses
        any common prefix; a recurrent state only an exact extension of the
        session's full prompt."""
        l = lcp_length(prompt, sess.prompt)
        if self.recurrent:
            return l if l == len(sess.prompt) else 0
        return l

    def _pick_session(self, dialogue_id: str, prompt: np.ndarray, parents):
        """Best cache candidate among the session's own entry and its DAG
        parent-step sessions (handoff fork: a child step's prompt starts
        with its parents' contexts, so a parent's cache is a warm prefix).
        Forking is safe: no cache is written in place, so the parent's
        entry is never changed."""
        sess = self.sessions.get(dialogue_id)
        if not parents:
            return sess
        best = self._session_hit(prompt, sess) if sess is not None else 0
        for pid in parents:
            ps = self.sessions.get(pid)
            if ps is not None and self._session_hit(prompt, ps) > best:
                best, sess = self._session_hit(prompt, ps), ps
        return sess

    # ---------------- serving ----------------
    @torch.no_grad()
    def serve(self, dialogue_id: str, prompt: np.ndarray, now: float = 0.0,
              max_new_tokens: int | None = None,
              parents: tuple = ()) -> ServeResult:
        """Serve one request: cache-aware prefill/extend + greedy decode,
        measuring TTFT/total wall-clock (scaled by agent speed) and exact
        cached-token counts.  ``parents`` names sibling session keys whose
        cached state may be forked (DAG handoffs); the result is stored
        under ``dialogue_id`` regardless."""
        prompt = np.asarray(prompt, dtype=np.int32)
        n_prompt = len(prompt)
        max_new = max_new_tokens or self.max_new
        sess = self._pick_session(dialogue_id, prompt, parents)

        n_hit = 0
        mode = "fresh"
        if sess is not None:
            l = lcp_length(prompt, sess.prompt)
            if self.recurrent:
                # an exact extension, or a repeat of the whole stored
                # prompt (n_hit == n_prompt: the no-op decode below)
                if l == len(sess.prompt):
                    n_hit, mode = l, "extend"
            elif l == n_prompt and l == len(sess.prompt):
                n_hit, mode = l, "identical"
            elif l > 0:
                n_hit, mode = l, "extend"

        self._sync()
        t0 = time.perf_counter()
        if mode == "identical":
            # nothing to prefill; logits from one uncommitted decode step
            cache = sess.cache
            logits, _ = self._decode_noop(cache)
        elif mode == "extend" and n_hit < n_prompt:
            suffix = prompt[n_hit:]
            pad = self._pad(suffix)
            cache = self._truncate(sess.cache, n_hit)
            logits, cache = self.model.extend(
                self.params, cache, self._tokens(pad[None]),
                self._tokens(np.array([len(suffix)])))
        elif mode == "extend":
            cache = self._truncate(sess.cache, n_hit)
            logits, _ = self._decode_noop(cache)
        else:
            pad = self._pad(prompt)
            batch = {"tokens": self._tokens(pad[None]),
                     "lens": self._tokens(np.array([n_prompt])),
                     "max_len": self.max_len}
            if self.cfg.is_encdec:
                # the reference engine's stand-in source: zero frames
                batch["frames"] = torch.zeros(
                    (1, self.cfg.src_len, self.cfg.d_model),
                    dtype=torch.float32, device=self.device)
            logits, cache = self.model.prefill(self.params, batch)
            n_hit = 0
        self._sync()
        t_first = time.perf_counter()

        # greedy decode
        out = []
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        for _ in range(max_new):
            out.append(int(tok[0]))
            logits, cache = self.model.decode_step(self.params, cache, tok)
            tok = torch.argmax(logits, dim=-1).to(torch.int32)
        self._sync()
        t_end = time.perf_counter()

        gen = np.array(out, dtype=np.int32)
        # store the state covering prompt + generated answer (the next turn
        # extends past it, as vLLM prefix caching does)
        full = np.concatenate([prompt, gen])
        self.sessions[dialogue_id] = SessionCache(cache, full, last_used=now)
        self._evict_lru(now)

        ttft = (t_first - t0) / self.speed
        total = (t_end - t0) / self.speed
        return ServeResult(gen, ttft, total, n_prompt, min(n_hit, n_prompt),
                           len(gen))

    def _pad(self, tokens: np.ndarray) -> np.ndarray:
        """Right-padded to a power-of-two bucket for attention; exact
        length for a recurrent state, which cannot mask padding."""
        if self.recurrent:
            return tokens
        pad = np.zeros(_bucket(len(tokens)), np.int32)
        pad[: len(tokens)] = tokens
        return pad

    def _decode_noop(self, cache):
        """Logits for the 'everything cached' path: one decode step on the
        cache whose new cache is thrown away (the one given is unchanged)."""
        tok = torch.zeros((cache["pos"].shape[0],), dtype=torch.int32,
                          device=self.device)
        return self.model.decode_step(self.params, cache, tok)

    def drop_session(self, dialogue_id: str) -> None:
        """Forget one dialogue's cached state."""
        self.sessions.pop(dialogue_id, None)
