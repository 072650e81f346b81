"""Mesh builders (port of ``launch/mesh.py``).

The mesh is a ``torch.distributed`` ``DeviceMesh`` with the JAX package's
axis names and order: "pod" and "data" are batch axes (the gradient
reduction spans both), "model" the tensor/expert-parallel axis, "pipe"
the pipeline axis.  Building one needs the process group first
(``torch.distributed.init_process_group`` with its address, world size and
rank), whose world size is the mesh's size; the device type follows the
group's backend (NCCL: cuda, else cpu).  The functions touch no device
state when the module is imported.

``make_production_mesh`` (the 256- and 512-chip pods of the dry-run) comes
with the dry-run itself (ROADMAP A12).
"""
from __future__ import annotations

from typing import Optional

import torch.distributed as dist


def _check_pipe(pipe: int, chips: int, per_pipe_model: int) -> int:
    if pipe < 1:
        raise ValueError(f"pipe axis size must be >= 1, got {pipe}")
    if chips % (pipe * per_pipe_model):
        raise ValueError(
            f"pipe={pipe} does not divide the pod: need pipe * {per_pipe_model}"
            f" to divide {chips} chips")
    return chips // (pipe * per_pipe_model)


def make_mesh(shape: tuple, axes: tuple, device_type: Optional[str] = None):
    """A ``DeviceMesh`` of ``shape`` over the initialised process group,
    its dimensions named ``axes``."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("a mesh needs the process group: call "
                           "torch.distributed.init_process_group (its "
                           "address, world size and rank) first")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_debug_mesh(n_data: int = 2, n_model: int = 2, *, pod: int = 0,
                    pipe: int = 0, device_type: Optional[str] = None):
    """Small mesh for tests and one-card runs."""
    shape, axes = (n_data, n_model), ("data", "model")
    if pipe:
        shape, axes = (pipe,) + shape, ("pipe",) + axes
    if pod:
        shape, axes = (pod,) + shape, ("pod",) + axes
    return make_mesh(shape, axes, device_type)


def _axis_sizes(mesh) -> dict:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def batch_axes(mesh) -> tuple:
    return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))


def model_axis_size(mesh) -> int:
    return _axis_sizes(mesh).get("model", 1)


def pipe_axis_size(mesh) -> int:
    """Number of pipeline-stage devices (1 when the mesh has no pipe axis)."""
    if mesh is None:
        return 1
    return _axis_sizes(mesh).get("pipe", 1)
