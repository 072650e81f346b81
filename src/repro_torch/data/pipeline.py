"""Synthetic data (a numpy copy of the JAX package's ``data/pipeline.py``
classes ``SyntheticLMDataset`` and ``SyntheticClassificationDataset``).

The same seeds give the same arrays as the JAX package's classes, so the
card and the CPU tests see the same batches.  The straggler-tolerant loader
comes with the train driver.
"""
from __future__ import annotations

from typing import Iterator

import numpy as np


class SyntheticLMDataset:
    """Deterministic synthetic token stream with learnable structure:
    tokens follow a noisy Markov chain (x_{t+1} = (a*x_t + b) % V, replaced
    by a random token with probability ``noise``), so cross-entropy is
    reducible.  ``batch_at(step)`` is a pure function of (seed, step,
    shard_id)."""

    def __init__(self, vocab_size: int, seq_len: int, global_batch: int,
                 seed: int = 0, shard_id: int = 0, num_shards: int = 1,
                 noise: float = 0.1):
        assert global_batch % num_shards == 0
        self.vocab = vocab_size
        self.seq = seq_len
        self.local_batch = global_batch // num_shards
        self.seed = seed
        self.shard = shard_id
        self.noise = noise
        self.a = 31
        self.b = 17

    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * 65_537 + self.shard)
        x0 = rng.integers(0, self.vocab, size=(self.local_batch, 1))
        toks = [x0]
        for _ in range(self.seq):
            nxt = (toks[-1] * self.a + self.b) % self.vocab
            flip = rng.random((self.local_batch, 1)) < self.noise
            rand = rng.integers(0, self.vocab, size=(self.local_batch, 1))
            toks.append(np.where(flip, rand, nxt))
        seq = np.concatenate(toks, axis=1).astype(np.int32)
        return {"tokens": seq[:, :-1], "labels": seq[:, 1:]}


class SyntheticClassificationDataset:
    """Deterministic image-like classification set (the paper's MNIST/SVHN
    stand-in): class templates + Gaussian noise, fixed train/test split."""

    def __init__(self, input_dim: int = 784, num_classes: int = 10,
                 n_train: int = 4096, n_test: int = 1024, seed: int = 0,
                 noise: float = 0.35):
        rng = np.random.default_rng(seed)
        self.templates = rng.standard_normal((num_classes, input_dim)) \
            .astype(np.float32)
        self.num_classes = num_classes

        def make(n, salt):
            r = np.random.default_rng(seed + salt)
            y = r.integers(0, num_classes, size=n)
            x = self.templates[y] + noise * r.standard_normal(
                (n, input_dim)).astype(np.float32)
            return x.astype(np.float32), y.astype(np.int32)

        self.train = make(n_train, 1)
        self.test = make(n_test, 2)

    def train_batches(self, batch: int, steps: int, seed: int = 0
                      ) -> Iterator[tuple]:
        x, y = self.train
        rng = np.random.default_rng(seed)
        for _ in range(steps):
            idx = rng.integers(0, len(y), size=batch)
            yield x[idx], y[idx]
