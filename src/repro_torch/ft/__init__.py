"""Fault injection for recovery drills (port of ``ft/``)."""
from repro_torch.ft.faults import (
    ENV_KNOB,
    FAULT_EXIT_CODE,
    FaultEvent,
    FaultPlan,
    flip_one_bit,
)

__all__ = ["ENV_KNOB", "FAULT_EXIT_CODE", "FaultEvent", "FaultPlan",
           "flip_one_bit"]
