"""Synthetic classification data (a numpy copy of the JAX package's
``data/pipeline.py::SyntheticClassificationDataset``).

The same seeds give the same arrays as the JAX package's class, so the card
and the CPU tests see the same batches.  The LM token stream and the
straggler-tolerant loader come with the train driver.
"""
from __future__ import annotations

from typing import Iterator

import numpy as np


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
