"""Deterministic, elastic-safe synthetic token pipeline (mirrors
``repro.data.tokens``; its batches are byte-equal to the reference's).

Every sample is generated from a counter-based RNG keyed by
``(seed, step, global_sample_index)`` — so:

- **resume** after restart is exact: replaying step s yields identical data;
- **elastic resharding** is exact: the global batch content is independent
  of how many hosts/shards consume it — shard i of n reads global rows
  ``[i*B/n, (i+1)*B/n)``;
- no filesystem or network dependency, while keeping the interface of a
  production loader (``batch(step) -> (local_B, S)``).

The token *distribution* is a Zipfian unigram mix with Markov bigram
structure so cross-entropy actually decreases during training (uniform
noise would pin the loss at log V).  Batches are numpy; the trainer moves
them to its device.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class TokenPipeline:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    num_shards: int = 1
    shard_id: int = 0

    @property
    def local_batch(self) -> int:
        if self.global_batch % self.num_shards != 0:
            raise ValueError(f"global batch {self.global_batch} does not "
                             f"split into {self.num_shards} shards")
        return self.global_batch // self.num_shards

    def _rows(self, step: int) -> range:
        lb = self.local_batch
        return range(self.shard_id * lb, (self.shard_id + 1) * lb)

    def _sample(self, step: int, row: int) -> np.ndarray:
        rng = np.random.Generator(np.random.Philox(
            key=self.seed, counter=[0, 0, step, row]))
        v = self.vocab_size
        # zipf unigram table (static given vocab)
        ranks = np.arange(1, v + 1, dtype=np.float64)
        p = 1.0 / ranks
        p /= p.sum()
        toks = rng.choice(v, size=self.seq_len, p=p)
        # overlay bigram structure: with prob .5, next = f(prev)
        follow = rng.random(self.seq_len) < 0.5
        mapped = (toks * 31 + 7) % v
        toks[1:] = np.where(follow[1:], mapped[:-1], toks[1:])
        return toks.astype(np.int32)

    def batch(self, step: int) -> np.ndarray:
        return np.stack([self._sample(step, r) for r in self._rows(step)])

    def reshard(self, num_shards: int, shard_id: int) -> "TokenPipeline":
        """Elastic resize: same stream, different consumer topology."""
        return TokenPipeline(self.vocab_size, self.seq_len, self.global_batch,
                             self.seed, num_shards, shard_id)
