"""Optimizers and learning-rate schedules (port of ``optim/``)."""
from repro_torch.optim.sgd import (
    Hyper,
    OptimizerConfig,
    apply_update,
    init_opt_state,
)
from repro_torch.optim.schedule import constant_schedule, cosine_schedule

__all__ = [
    "OptimizerConfig", "init_opt_state", "apply_update", "Hyper",
    "cosine_schedule", "constant_schedule",
]
