"""Deterministic synthetic LM data pipeline (the reference's
`repro.training.data`, NumPy only, so its batches are the reference's bit
for bit).

``SyntheticLM`` draws token streams from a fixed random bigram transition
table with epsilon-noise — learnable structure (a small model's loss drops
well below the unigram entropy) while being fully reproducible from (seed,
step) with no files. Batches are produced per step index, so fault-tolerant
resume re-generates the exact same stream.
"""
from __future__ import annotations

import numpy as np


class SyntheticLM:
    def __init__(self, vocab_size: int, seq_len: int, global_batch: int,
                 *, seed: int = 0, noise: float = 0.1):
        self.vocab = vocab_size
        self.seq = seq_len
        self.batch = global_batch
        self.seed = seed
        self.noise = noise
        rng = np.random.default_rng(seed)
        self.table = rng.integers(0, vocab_size, size=vocab_size)  # bigram map

    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng((self.seed + 1) * 1_000_003 + step)
        toks = np.empty((self.batch, self.seq), np.int32)
        cur = rng.integers(0, self.vocab, size=self.batch)
        for t in range(self.seq):
            toks[:, t] = cur
            nxt = self.table[cur]
            flip = rng.random(self.batch) < self.noise
            nxt = np.where(flip, rng.integers(0, self.vocab, self.batch), nxt)
            cur = nxt
        return {"tokens": toks}
