"""Synthetic LM data pipeline — the port's own copy of the reference's
numpy-only ``data/pipeline.py`` (WikiText-103 is not available offline);
its batches equal the reference's bit for bit.

A Zipf-Markov corpus: next-token = affine map of the previous token with
probability ``p_markov`` (learnable structure -> loss actually decreases, so
softmax-vs-consmax convergence comparisons are meaningful), otherwise a
Zipfian unigram draw. Generation is **stateless per (step, shard)** — batch i
of shard s is a pure function of (seed, step, shard), so any worker can
resume / re-generate any step deterministically after preemption or elastic
rescale, with no data-state in checkpoints beyond the step counter.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    p_markov: float = 0.8
    zipf_a: float = 1.2


class SyntheticCorpus:
    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        v = cfg.vocab_size
        # fixed affine bigram map (the hidden structure to learn)
        self.mult = int(rng.integers(1, v - 1)) | 1
        self.add = int(rng.integers(0, v))
        # zipf unigram over vocab
        ranks = np.arange(1, v + 1, dtype=np.float64)
        probs = ranks ** (-cfg.zipf_a)
        self.unigram = probs / probs.sum()

    def _gen(self, rng: np.random.Generator, batch: int) -> np.ndarray:
        c = self.cfg
        v = c.vocab_size
        toks = np.empty((batch, c.seq_len + 1), dtype=np.int32)
        toks[:, 0] = rng.choice(v, size=batch, p=self.unigram)
        markov = rng.random((batch, c.seq_len)) < c.p_markov
        noise = rng.choice(v, size=(batch, c.seq_len), p=self.unigram)
        for t in range(c.seq_len):
            nxt = (toks[:, t] * self.mult + self.add) % v
            toks[:, t + 1] = np.where(markov[:, t], nxt, noise[:, t])
        return toks

    def batch(self, step: int, *, shard: int = 0, num_shards: int = 1):
        """Deterministic (tokens, labels) for a global step; shardable."""
        c = self.cfg
        assert c.global_batch % num_shards == 0
        local = c.global_batch // num_shards
        rng = np.random.default_rng(
            np.random.SeedSequence([c.seed, step, shard]))
        toks = self._gen(rng, local)
        return toks[:, :-1], toks[:, 1:]

    def global_batch_arrays(self, step: int):
        tokens, labels = self.batch(step)
        return {"tokens": tokens, "labels": labels}
