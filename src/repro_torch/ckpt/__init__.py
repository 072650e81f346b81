"""Checkpointing (port of ``ckpt/``): the JAX package's on-disk format."""
from repro_torch.ckpt.checkpoint import (
    AsyncCheckpointer,
    latest_step,
    latest_valid_step,
    list_steps,
    restore_checkpoint,
    save_checkpoint,
    verify_checkpoint,
)

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step",
           "latest_valid_step", "list_steps", "verify_checkpoint",
           "AsyncCheckpointer"]
