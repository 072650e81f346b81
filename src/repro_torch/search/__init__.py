"""Bitwidth search (port of ``search/``): per-layer (I,F) sensitivity
sweeps, QAT annealing schedules, and the train -> serve int8 export path.

The subsystem has four parts:

* ``plan``        — ``BitPlan``: the per-layer-group (I,F) artifact a
                    sweep produces (the JAX package's JSON, loadable back
                    into a ``BitSchedule``).
* ``sensitivity`` — short seeded training probes per layer-group over a
                    candidate (I,F) grid; picks the minimal format per
                    group meeting a loss-delta target.
* ``anneal``      — step-indexed F-bit ramps (``"0:16,200:12,400:10"``)
                    threaded through ``StepOptions``/``QuantPolicy`` as
                    runtime data, so one step object serves the whole ramp
                    and checkpoint resume is bitwise exact.
* ``export``      — converts a trained plan into the serving engine's
                    int8 configuration and proves train-time quant
                    matches the serving KV/prologue numerics bit for bit.

``sensitivity`` and ``export`` pull in the training/serving stacks, so
they are loaded lazily — importing ``repro_torch.search`` alone stays
cheap (and keeps ``core.steps`` -> ``search.anneal`` import-cycle free).
"""
from repro_torch.search.anneal import AnnealSchedule
from repro_torch.search.plan import BitPlan, GroupChoice, layer_groups

__all__ = [
    "AnnealSchedule",
    "BitPlan",
    "GroupChoice",
    "layer_groups",
    "sensitivity",
    "export",
]

_LAZY_SUBMODULES = ("sensitivity", "export")


def __getattr__(name: str):
    if name in _LAZY_SUBMODULES:
        import importlib

        return importlib.import_module(f"repro_torch.search.{name}")
    raise AttributeError(
        f"module 'repro_torch.search' has no attribute {name!r}")
