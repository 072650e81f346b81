"""Deterministic, step-indexed data with straggler tolerance (a numpy copy
of the JAX package's ``data/pipeline.py``, which has no JAX in it).

``batch_at(step)`` is a pure function of (seed, step, shard_id), so a
resumed run replays the exact batch stream, and the same seeds give the
same arrays as the JAX package's classes.

``StragglerTolerantLoader`` wraps a (possibly slow) producer with a bounded
prefetch queue and a per-step deadline: when a fetch exceeds the deadline
the loader substitutes the previous batch and records a skip, so the
step-time tail is bounded by the deadline instead of the slowest fetch.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Iterator, Optional

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


class DataProducerError(RuntimeError):
    """The background fetch raised; re-surfaced on the consumer thread."""

    def __init__(self, step: int, cause: BaseException):
        super().__init__(f"data producer failed at step {step}: {cause!r}")
        self.step = step
        self.cause = cause


class StragglerTolerantLoader:
    """Bounded-queue prefetch with a per-step deadline and step-tagged
    delivery.

    fetch_fn(step) -> batch runs in a background thread; ``get(step)``
    returns within ~deadline_s even if the producer stalls, substituting
    the last good batch and counting a skip.

    Correctness contracts (each drilled in tests/test_torch_ft.py):

      * queue entries are tagged with the step they were fetched FOR and
        ``get(step)`` only delivers a matching tag — after a deadline skip
        the late batch eventually lands with a stale tag and is DISCARDED
        (counted in ``stale_drops``), never delivered for the wrong step;
      * a producer exception is propagated to the consumer as
        ``DataProducerError`` on the next ``get`` (and every one after) —
        the alternative is a dead producer and an infinite tail of
        deadline waits silently substituting stale data;
      * ``start_step`` makes the producer fetch from the RESUME point, so
        a restarted run's ``get(start_step)`` is the same batch the
        uninterrupted run saw (the step-indexed dataset makes that exact).
    """

    def __init__(self, fetch_fn: Callable[[int], dict], deadline_s: float = 1.0,
                 prefetch: int = 2, start_step: int = 0):
        self.fetch_fn = fetch_fn
        self.deadline = deadline_s
        self.q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self.skips = 0
        self.served = 0
        self.stale_drops = 0
        self._last: Optional[dict] = None
        self._error: Optional[DataProducerError] = None
        self._held: Optional[tuple] = None  # (tag, batch) with tag > request
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._producer,
                                        args=(start_step,), daemon=True)
        self._thread.start()

    def _producer(self, step: int):
        while not self._stop.is_set():
            try:
                batch = self.fetch_fn(step)
            except BaseException as e:  # noqa: BLE001 - handed to consumer
                item = ("error", step, DataProducerError(step, e))
                while not self._stop.is_set():
                    try:
                        self.q.put(item, timeout=0.1)
                        return
                    except queue.Full:
                        continue
                return
            item = ("batch", step, batch)
            while not self._stop.is_set():
                try:
                    self.q.put(item, timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def _take(self, timeout: Optional[float]):
        """One queue pop; raises queue.Empty on timeout, DataProducerError
        on a producer failure (latched: every later get re-raises)."""
        kind, tag, payload = self.q.get(timeout=timeout)
        if kind == "error":
            self._error = payload
            raise payload
        return tag, payload

    def get(self, step: int) -> dict:
        self.served += 1
        if self._error is not None:
            raise self._error
        if self._held is not None and self._held[0] < step:
            self._held = None  # a re-requested range moved past it
        t0 = time.monotonic()
        while True:
            if self._held is not None:
                tag, batch = self._held
                self._held = None
            else:
                remaining = self.deadline - (time.monotonic() - t0)
                try:
                    tag, batch = self._take(timeout=max(remaining, 0.0))
                except queue.Empty:
                    break  # deadline: substitute
            if tag == step:
                self._last = batch
                return batch
            if tag < step:
                # late batch for a step already served (or skipped):
                # reconcile by discarding — delivering it here would feed
                # step N the data of step N-k
                self.stale_drops += 1
                continue
            self._held = (tag, batch)  # future tag: keep for later
            break
        self.skips += 1
        if self._last is None:
            # first batch: must block until the REQUESTED step arrives
            while True:
                tag, batch = self._take(timeout=None)
                if tag == step:
                    self._last = batch
                    return batch
                if tag < step:
                    self.stale_drops += 1
                else:
                    raise RuntimeError(
                        f"get({step}) requested a step before the producer "
                        f"stream (next tag {tag}); check start_step")
        return self._last

    def close(self):
        self._stop.set()
