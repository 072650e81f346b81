"""Progressive bitwidth annealing: step-indexed F-bit ramps for QAT (port of
``search/anneal.py``).

Grammar
-------
A schedule is a comma-separated list of ``step:value`` milestones::

    "0:off,100:16,400:12"

* ``step`` — global training step the milestone takes effect (ascending,
  the first milestone must be step 0).
* ``value`` — either ``off`` (quantization disabled until the next
  milestone) or an integer F-bit **floor**: every layer's fractional
  bits become ``max(schedule_F, value)`` for all three tensor classes.

So the example trains full-precision for 100 steps, then quantized with
at least 16 fractional bits, and from step 400 on at the underlying
per-layer schedule (floored at 12).

``apply`` is arithmetic on the ``BitSchedule`` tensors and the step: the
bits stay runtime data, so one step object serves the whole ramp, and a
resume from a checkpoint at step N continues the ramp bitwise, since the
effective bits are a function of the (restored) step alone.  The step may
be a Python int (the milestone is looked up on the host) or a 0-d tensor,
read on its device with no host sync.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch.quant.fixed_point import BitSchedule

# Fractional-bit floors above this would push I+F past the exact-pow2
# range of the fixed-point emulation (see quant.fixed_point._pow2_int).
_MAX_F_FLOOR = 24

_OFF = -1  # milestone value meaning "quantization disabled"


@dataclasses.dataclass(frozen=True)
class AnnealSchedule:
    """Parsed, validated annealing schedule (hashable)."""

    milestones: Tuple[Tuple[int, int], ...]  # (step, f_floor) with -1 = off

    @classmethod
    def parse(cls, spec: str) -> "AnnealSchedule":
        if isinstance(spec, AnnealSchedule):
            return spec
        if not isinstance(spec, str) or not spec.strip():
            raise ValueError(f"empty anneal spec: {spec!r}")
        milestones = []
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            try:
                step_s, val_s = part.split(":")
                step = int(step_s)
            except ValueError:
                raise ValueError(
                    f"bad anneal milestone {part!r} (want 'STEP:FBITS' or "
                    f"'STEP:off') in spec {spec!r}") from None
            val_s = val_s.strip().lower()
            if val_s == "off":
                val = _OFF
            else:
                try:
                    val = int(val_s)
                except ValueError:
                    raise ValueError(
                        f"bad anneal value {val_s!r} in spec {spec!r}") from None
                if not 0 <= val <= _MAX_F_FLOOR:
                    raise ValueError(
                        f"anneal F floor {val} out of range [0, {_MAX_F_FLOOR}]"
                        f" in spec {spec!r}")
            if step < 0:
                raise ValueError(f"negative milestone step in spec {spec!r}")
            milestones.append((step, val))
        if not milestones:
            raise ValueError(f"no milestones in anneal spec {spec!r}")
        if milestones[0][0] != 0:
            raise ValueError(
                f"first anneal milestone must be step 0, got "
                f"{milestones[0][0]} in spec {spec!r}")
        steps = [m[0] for m in milestones]
        if steps != sorted(set(steps)):
            raise ValueError(f"anneal milestones must strictly ascend: {spec!r}")
        return cls(milestones=tuple(milestones))

    @property
    def spec(self) -> str:
        """Canonical spec string (round-trips through ``parse``)."""
        return ",".join(
            f"{s}:{'off' if v == _OFF else v}" for s, v in self.milestones)

    @property
    def final_step(self) -> int:
        return self.milestones[-1][0]

    def f_floor_at(self, step: int) -> int:
        """Static (Python int) lookup — for logging / tests."""
        val = self.milestones[0][1]
        for s, v in self.milestones:
            if step >= s:
                val = v
        return val

    def _floor_and_on(self, step, device):
        """(F floor, enabled multiplier) at ``step``: Python numbers for an
        int step; for a tensor step, 0-d tensors on ``device`` from the
        milestone index ``clip(sum(step >= steps) - 1, 0, n - 1)``, built
        from Python constants (no table is copied to the device)."""
        if not isinstance(step, torch.Tensor):
            val = self.f_floor_at(int(step))
            return max(val, 0), 0.0 if val == _OFF else 1.0
        s = step.to(device=device, dtype=torch.int32)
        hits = sum((s >= m[0]).to(torch.int32) for m in self.milestones)
        idx = torch.clamp(hits - 1, 0, len(self.milestones) - 1)
        floor = torch.zeros((), dtype=torch.int32, device=device)
        on = torch.zeros((), dtype=torch.float32, device=device)
        for k, (_, v) in enumerate(self.milestones):
            at = idx == k
            floor = floor + at.to(torch.int32) * max(v, 0)
            on = on + at.to(torch.float32) * (0.0 if v == _OFF else 1.0)
        return floor, on

    def apply(self, bits: BitSchedule, step) -> BitSchedule:
        """Annealed view of ``bits`` at ``step`` (a new schedule; ``bits``
        is left as it was).  A tensor step is moved to the bits' device."""
        floor, on = self._floor_and_on(step, bits.w_f.device)
        lift = (torch.maximum if isinstance(floor, torch.Tensor)
                else torch.clamp_min)
        return dataclasses.replace(
            bits, w_f=lift(bits.w_f, floor), a_f=lift(bits.a_f, floor),
            g_f=lift(bits.g_f, floor), enabled=bits.enabled * on)

    def apply_tree(self, bits, step):
        """Apply to a dict of schedules (the ``bits`` arg of a train step)."""
        if isinstance(bits, BitSchedule):
            return self.apply(bits, step)
        return {k: self.apply(v, step) for k, v in bits.items()}

    def describe(self) -> str:
        return f"anneal[{self.spec}]"
