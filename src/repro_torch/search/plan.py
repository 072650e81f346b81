"""BitPlan: the persisted artifact of a bitwidth sensitivity sweep (port of
``search/plan.py``).

A plan assigns one (I, F) fixed-point format to each contiguous
layer-group of the stack, together with the probe evidence that led to
the choice (per-group probe loss, the f32 baseline, and whether the
loss-delta target was met).  Plans serialize to JSON so a searched
configuration can be committed, diffed, and loaded back into a
``BitSchedule`` for training or exported to the serving int8 path
(``repro_torch.search.export``).  The JSON is the JAX package's, byte for
byte: a plan written by either package loads in the other.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Sequence, Tuple

from repro_torch.quant.fixed_point import BitSchedule, schedule_from_formats

PLAN_SCHEMA = 1


def layer_groups(num_layers: int, num_groups: int) -> Tuple[Tuple[int, ...], ...]:
    """Partition ``range(num_layers)`` into ``num_groups`` contiguous groups.

    ``num_groups <= 0`` means one group per layer.  Remainder layers go to
    the later groups (the paper widens formats toward the output side, so
    the tail groups being slightly larger is the conservative split).
    """
    if num_layers <= 0:
        raise ValueError("num_layers must be positive")
    if num_groups <= 0 or num_groups > num_layers:
        num_groups = num_layers
    base, rem = divmod(num_layers, num_groups)
    groups, start = [], 0
    for g in range(num_groups):
        size = base + (1 if g >= num_groups - rem else 0)
        groups.append(tuple(range(start, start + size)))
        start += size
    return tuple(groups)


@dataclasses.dataclass(frozen=True)
class GroupChoice:
    """The selected format for one contiguous layer-group."""

    group: int
    layers: Tuple[int, ...]
    i_bits: int
    f_bits: int
    probe_loss: float
    met_target: bool

    @property
    def bitwidth(self) -> int:
        return self.i_bits + self.f_bits + 1


@dataclasses.dataclass(frozen=True)
class BitPlan:
    """Per-layer-group (I,F) selection with its probe evidence.

    ``groups`` partitions ``range(num_layers)``; ``grid`` is the candidate
    ladder the sweep searched (ascending bitwidth); ``final_loss`` is the
    probe loss of the assembled plan (all groups at their chosen format at
    once), which is the number the acceptance target is judged against.
    """

    num_layers: int
    groups: Tuple[GroupChoice, ...]
    baseline_loss: float
    final_loss: float
    target: float
    seed: int
    grid: Tuple[Tuple[int, int], ...]
    probe_steps: int
    probes: int = 0  # number of probe trainings the sweep ran

    def __post_init__(self):
        covered = sorted(l for g in self.groups for l in g.layers)
        if covered != list(range(self.num_layers)):
            raise ValueError(
                f"plan groups {covered} do not partition "
                f"range({self.num_layers})")

    @property
    def met_target(self) -> bool:
        return self.final_loss <= self.baseline_loss + self.target

    def formats(self) -> Tuple[Tuple[int, int], ...]:
        """Per-layer (I, F), expanded from the group choices."""
        fmt = [None] * self.num_layers
        for g in self.groups:
            for layer in g.layers:
                fmt[layer] = (g.i_bits, g.f_bits)
        return tuple(fmt)

    def to_bit_schedule(self, *, enabled: bool = True) -> BitSchedule:
        return schedule_from_formats(self.formats(), enabled=enabled)

    def describe(self) -> str:
        parts = ", ".join(
            f"L{g.layers[0]}-{g.layers[-1]}:({g.i_bits},{g.f_bits})"
            for g in self.groups)
        return (f"{parts} | baseline {self.baseline_loss:.4f} "
                f"final {self.final_loss:.4f} target +{self.target:.3f} "
                f"met={self.met_target}")

    # -- JSON round-trip ----------------------------------------------------

    def to_json(self) -> dict:
        return {
            "schema": PLAN_SCHEMA,
            "num_layers": self.num_layers,
            "baseline_loss": self.baseline_loss,
            "final_loss": self.final_loss,
            "target": self.target,
            "seed": self.seed,
            "grid": [list(p) for p in self.grid],
            "probe_steps": self.probe_steps,
            "probes": self.probes,
            "met_target": self.met_target,
            "groups": [
                {
                    "group": g.group,
                    "layers": list(g.layers),
                    "i_bits": g.i_bits,
                    "f_bits": g.f_bits,
                    "probe_loss": g.probe_loss,
                    "met_target": g.met_target,
                }
                for g in self.groups
            ],
        }

    @classmethod
    def from_json(cls, obj: dict) -> "BitPlan":
        schema = obj.get("schema", 1)
        if schema != PLAN_SCHEMA:
            raise ValueError(f"unknown BitPlan schema {schema}")
        groups = tuple(
            GroupChoice(
                group=int(g["group"]),
                layers=tuple(int(x) for x in g["layers"]),
                i_bits=int(g["i_bits"]),
                f_bits=int(g["f_bits"]),
                probe_loss=float(g["probe_loss"]),
                met_target=bool(g["met_target"]),
            )
            for g in obj["groups"]
        )
        return cls(
            num_layers=int(obj["num_layers"]),
            groups=groups,
            baseline_loss=float(obj["baseline_loss"]),
            final_loss=float(obj["final_loss"]),
            target=float(obj["target"]),
            seed=int(obj["seed"]),
            grid=tuple((int(p[0]), int(p[1])) for p in obj["grid"]),
            probe_steps=int(obj["probe_steps"]),
            probes=int(obj.get("probes", 0)),
        )

    def save(self, path: str) -> None:
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=2, sort_keys=True)
            f.write("\n")

    @classmethod
    def load(cls, path: str) -> "BitPlan":
        with open(path) as f:
            return cls.from_json(json.load(f))


def plan_from_formats(
    formats: Sequence[Tuple[int, int]],
    *,
    baseline_loss: float = 0.0,
    final_loss: float = 0.0,
    target: float = 0.0,
    seed: int = 0,
    probe_steps: int = 0,
) -> BitPlan:
    """Wrap an explicit per-layer format list as a (one-layer-per-group)
    plan — handy for exporting hand-picked schedules like Table I."""
    groups = tuple(
        GroupChoice(group=k, layers=(k,), i_bits=int(i), f_bits=int(f),
                    probe_loss=final_loss, met_target=True)
        for k, (i, f) in enumerate(formats)
    )
    return BitPlan(
        num_layers=len(groups), groups=groups, baseline_loss=baseline_loss,
        final_loss=final_loss, target=target, seed=seed,
        grid=tuple((int(i), int(f)) for i, f in formats),
        probe_steps=probe_steps,
    )
