"""Deterministic fault injection for recovery drills (a copy of the JAX
package's ``ft/faults.py``, which is numpy only).

TaxoNN's target environment — retraining on embedded devices in the field —
treats power loss, preemption and flaky storage as the NORMAL case, so the
training loop's recovery story has to be provable, not aspirational.  This
module supplies the reproducible half of that proof: a seeded ``FaultPlan``
describing exactly which faults fire at exactly which steps, so a CI drill
that kills a run mid-step and restarts it replays the same failure every
time.

A plan is parsed from a compact spec string (the ``--fault-plan`` train
flag, or the ``REPRO_FAULT_PLAN`` env knob so subprocess drills need no
argv plumbing).  Events are ``;``-separated:

    crash@12            hard-kill the process when the loop reaches step 12
                        (os._exit — no atexit flush, no daemon join: the
                        closest a test can get to SIGKILL semantics)
    crash@rand:8-20     seeded-random kill step in [8, 20) — drawn from the
                        plan seed, so the drill is random ACROSS seeds but
                        reproducible for one
    io@8x2              the checkpoint save at data step 8 fails its first
                        2 leaf-write attempts with OSError (transient —
                        the save-retry loop must absorb it)
    fsync@8x2           same, but the failure fires at fsync time
    rename@8            the tmp->final rename fails once at step 8
    flip@10             after the step-10 checkpoint lands, flip one bit of
                        one array file in it (which file/bit is drawn from
                        the plan seed) — the restore path must detect the
                        checksum mismatch and fall back
    stall@5:0.6         the data fetch for step 5 stalls 0.6 s (straggler;
                        the loader's deadline must bound it)
    seed=7              plan seed (default 0)

The plan object is pure policy; mechanism lives at three hook points:

  * ``ckpt_fault(event, step)`` is passed to ``ckpt.save_checkpoint`` /
    ``AsyncCheckpointer`` as their ``fault=`` callable and raises OSError
    when an io/fsync/rename event fires,
  * ``wrap_fetch(fetch_fn)`` wraps the data pipeline's fetch with the
    stall events,
  * ``check_crash(step)`` / ``corrupt_checkpoint(dir, step)`` are called
    by the train loop directly.

Everything is keyed by the DATA step (the step index the training loop
sees), never wall-clock, so a drill is bitwise-reproducible.
"""
from __future__ import annotations

import dataclasses
import os
import pathlib
import re
import sys
from typing import Callable, Dict, List, Optional

import numpy as np

# distinct from any python/pytest/XLA failure code so drills can assert the
# crash they injected is the crash that happened
FAULT_EXIT_CODE = 41

ENV_KNOB = "REPRO_FAULT_PLAN"

_EVENT_RE = re.compile(
    r"^(?P<kind>crash|io|fsync|rename|flip|stall)@"
    r"(?P<at>rand:\d+-\d+|\d+)"
    r"(?:x(?P<count>\d+))?"
    r"(?::(?P<seconds>\d+(?:\.\d+)?))?$")


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    kind: str            # crash | io | fsync | rename | flip | stall
    step: int            # resolved data step the event fires at
    count: int = 1       # consecutive failures for io/fsync/rename
    seconds: float = 0.0  # stall duration


class FaultPlan:
    """A resolved, seeded schedule of injected faults.

    Stateful only in the transient-failure counters (an ``io@8x2`` event
    must fail exactly twice and then let the retry succeed), which is why
    one plan instance must be shared by every hook point of one run.
    """

    def __init__(self, events: List[FaultEvent], seed: int = 0,
                 spec: str = ""):
        self.events = list(events)
        self.seed = int(seed)
        self.spec = spec
        # (kind, step) -> remaining failures; mutated as faults fire
        self._budget: Dict[tuple, int] = {
            (e.kind, e.step): e.count for e in self.events
            if e.kind in ("io", "fsync", "rename")}
        self.fired: List[tuple] = []   # (kind, step) log for tests/logs

    # -- construction -------------------------------------------------------

    @classmethod
    def parse(cls, spec: str) -> "FaultPlan":
        spec = (spec or "").strip()
        if not spec:
            return cls([], 0, spec)
        seed = 0
        raw = []
        for token in filter(None, (t.strip() for t in spec.split(";"))):
            if token.startswith("seed="):
                seed = int(token[5:])
                continue
            m = _EVENT_RE.match(token)
            if not m:
                raise ValueError(
                    f"bad fault-plan token {token!r} (grammar: kind@step, "
                    f"crash@rand:lo-hi, io@step xN, stall@step:seconds, "
                    f"seed=N)")
            raw.append(m)
        rng = np.random.default_rng(seed)
        events = []
        for m in raw:
            at = m.group("at")
            if at.startswith("rand:"):
                lo, hi = (int(x) for x in at[5:].split("-"))
                if hi <= lo:
                    raise ValueError(f"empty rand range in {m.group(0)!r}")
                step = int(rng.integers(lo, hi))
            else:
                step = int(at)
            events.append(FaultEvent(
                kind=m.group("kind"), step=step,
                count=int(m.group("count") or 1),
                seconds=float(m.group("seconds") or 0.0)))
        return cls(events, seed, spec)

    @classmethod
    def from_env(cls, flag_value: Optional[str] = None) -> Optional["FaultPlan"]:
        """Flag wins over env; empty/absent spec -> no plan (None)."""
        spec = flag_value if flag_value else os.environ.get(ENV_KNOB, "")
        plan = cls.parse(spec)
        return plan if plan.events else None

    # -- introspection ------------------------------------------------------

    def describe(self) -> str:
        if not self.events:
            return "no faults"
        parts = []
        for e in sorted(self.events, key=lambda e: (e.step, e.kind)):
            p = f"{e.kind}@{e.step}"
            if e.count > 1:
                p += f"x{e.count}"
            if e.seconds:
                p += f":{e.seconds:g}s"
            parts.append(p)
        return f"seed={self.seed} " + " ".join(parts)

    def crash_step(self) -> Optional[int]:
        steps = [e.step for e in self.events if e.kind == "crash"]
        return min(steps) if steps else None

    def _events_of(self, kind: str, step: int) -> List[FaultEvent]:
        return [e for e in self.events if e.kind == kind and e.step == step]

    # -- hook points --------------------------------------------------------

    def check_crash(self, step: int) -> None:
        """Hard-kill the process if a crash event fires at ``step``.

        ``os._exit`` skips atexit handlers, finally blocks and daemon-thread
        joins — the point of the drill is proving recovery from a kill that
        flushed NOTHING."""
        if any(e.step == step for e in self.events if e.kind == "crash"):
            print(f"[fault] injected crash at step {step} "
                  f"(exit {FAULT_EXIT_CODE})", file=sys.stderr, flush=True)
            sys.stderr.flush()
            sys.stdout.flush()
            os._exit(FAULT_EXIT_CODE)

    def ckpt_fault(self, event: str, step: int) -> None:
        """Checkpoint-layer hook: raise OSError while the (kind, step)
        failure budget lasts.  ``event`` is "io" | "fsync" | "rename"."""
        remaining = self._budget.get((event, step), 0)
        if remaining > 0:
            self._budget[(event, step)] = remaining - 1
            self.fired.append((event, step))
            raise OSError(
                f"injected {event} failure at step {step} "
                f"({remaining - 1} more to come)")

    def wrap_fetch(self, fetch_fn: Callable[[int], dict]
                   ) -> Callable[[int], dict]:
        """Wrap a data-pipeline fetch with the plan's stall events."""
        stalls = {e.step: e.seconds for e in self.events if e.kind == "stall"}
        if not stalls:
            return fetch_fn

        def fetch(step: int) -> dict:
            secs = stalls.get(step, 0.0)
            if secs:
                self.fired.append(("stall", step))
                import time
                time.sleep(secs)
            return fetch_fn(step)
        return fetch

    def flip_steps(self) -> List[int]:
        return sorted(e.step for e in self.events if e.kind == "flip")

    def corrupt_checkpoint(self, directory, step: int) -> Optional[str]:
        """Flip one bit of one array file in ``<dir>/step_<step>`` (drawn
        from the plan seed).  Returns the corrupted file name, or None if
        the checkpoint does not exist.  The manifest keeps the ORIGINAL
        checksum, so the restore path must detect the mismatch."""
        if not self._events_of("flip", step):
            return None
        return flip_one_bit(directory, step,
                            seed=(self.seed * 1_000_003 + step))


def flip_one_bit(directory, step: int, *, seed: int = 0) -> Optional[str]:
    """Seeded single-bit corruption of one ``arr_*.npy`` in a checkpoint —
    shared by FaultPlan and the drill tests (which corrupt directly)."""
    cdir = pathlib.Path(directory) / f"step_{step:08d}"
    if not cdir.is_dir():
        return None
    arrs = sorted(p for p in cdir.iterdir() if p.name.startswith("arr_"))
    if not arrs:
        return None
    rng = np.random.default_rng(seed)
    target = arrs[int(rng.integers(len(arrs)))]
    data = bytearray(target.read_bytes())
    # skip the .npy header so the flip corrupts PAYLOAD bytes (a header
    # flip would fail np.load outright, which is the easy case)
    off = 128 if len(data) > 136 else max(0, len(data) - 1)
    pos = int(rng.integers(off, len(data)))
    data[pos] ^= 1 << int(rng.integers(8))
    target.write_bytes(bytes(data))
    print(f"[fault] flipped bit {pos} of {target.name} in {cdir.name}",
          file=sys.stderr, flush=True)
    return target.name
