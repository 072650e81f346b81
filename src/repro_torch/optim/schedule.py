"""Learning-rate schedules (host side: the lr fed to ``Hyper``; a copy of
the JAX package's ``optim/schedule.py``, which has no JAX in it)."""
from __future__ import annotations

import math


def constant_schedule(lr: float):
    def f(step: int) -> float:
        return lr
    return f


def cosine_schedule(peak_lr: float, warmup: int, total: int,
                    floor_frac: float = 0.1):
    floor = peak_lr * floor_frac

    def f(step: int) -> float:
        if step < warmup:
            return peak_lr * (step + 1) / max(warmup, 1)
        frac = min(1.0, (step - warmup) / max(total - warmup, 1))
        return floor + 0.5 * (peak_lr - floor) * (1 + math.cos(math.pi * frac))
    return f
