"""Deterministic synthetic token pipeline (``repro/data/synthetic.py``).

A seeded, stateless stream: batch ``i`` is a pure function of (seed, i), so
any worker can regenerate any batch, which is what the burst checkpointing
protocol needs for exact resume (re-reading a batch after a crash yields
identical data; see ``checkpoint/burst_ckpt.py``). numpy throughout, so a
batch is bitwise ``repro``'s for any (seed, index).

The "task" is learnable structure, not noise: a periodic Markov-ish sequence
with an arch-sized vocabulary, so a model visibly reduces its loss within a
few hundred steps.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np

__all__ = ["SyntheticConfig", "SyntheticData"]


@dataclasses.dataclass(frozen=True)
class SyntheticConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0


class SyntheticData:
    def __init__(self, cfg: SyntheticConfig):
        self.cfg = cfg
        rng = np.random.RandomState(cfg.seed)
        # fixed random transition table: next ≈ f(prev) + small noise
        self._next = rng.randint(0, cfg.vocab, size=cfg.vocab).astype(np.int32)

    def batch(self, index: int) -> Dict[str, np.ndarray]:
        """Batch ``index``: {"tokens", "labels"} int32 [global_batch, seq_len],
        labels the tokens shifted by one; a pure function of (seed, index)."""
        c = self.cfg
        rng = np.random.RandomState((c.seed * 1_000_003 + index) % (2**31 - 1))
        start = rng.randint(0, c.vocab, size=(c.global_batch, 1)).astype(np.int32)
        toks = np.empty((c.global_batch, c.seq_len + 1), np.int32)
        toks[:, 0] = start[:, 0]
        noise = rng.rand(c.global_batch, c.seq_len) < 0.05
        rand_tok = rng.randint(0, c.vocab, size=(c.global_batch, c.seq_len))
        for t in range(c.seq_len):
            nxt = self._next[toks[:, t]]
            toks[:, t + 1] = np.where(noise[:, t], rand_tok[:, t], nxt)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        i = 0
        while True:
            yield self.batch(i)
            i += 1
