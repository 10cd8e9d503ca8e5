"""Synthetic data pipeline: deterministic, seekable token streams.

Generates Zipf-distributed token sequences with short-range structure
(a copy/induction pattern) so small models actually learn something the
loss curve can show.  The iterator is stateless-resumable (step index ->
batch), which is what checkpoint-resume requires.

The port's copy of the JAX package's ``training/data.py`` (numpy only);
``tests/test_torch_training.py`` holds its batches equal to the original's.
"""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np


class SyntheticLM:
    def __init__(self, vocab_size: int, seq_len: int, global_batch: int,
                 seed: int = 0):
        self.vocab = vocab_size
        self.seq = seq_len
        self.batch = global_batch
        self.seed = seed
        # Zipf weights over the vocab
        ranks = np.arange(1, vocab_size + 1)
        self._p = (1.0 / ranks) / np.sum(1.0 / ranks)

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, step))
        toks = rng.choice(self.vocab, size=(self.batch, self.seq + 1),
                          p=self._p)
        # induction pattern: second half repeats the first half shifted
        half = self.seq // 2
        toks[:, half:half * 2] = toks[:, :half]
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class SyntheticEmbeds:
    """For embedding-input (VLM/audio) models: frame/patch embeddings."""

    def __init__(self, d_model: int, vocab_size: int, seq_len: int,
                 global_batch: int, seed: int = 0):
        self.d = d_model
        self.vocab = vocab_size
        self.seq = seq_len
        self.batch = global_batch
        self.seed = seed

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, step, 1))
        emb = rng.standard_normal(
            (self.batch, self.seq, self.d)).astype(np.float32) * 0.02
        labels = rng.integers(0, self.vocab, (self.batch, self.seq))
        return {"embeds": emb, "labels": labels.astype(np.int32)}
