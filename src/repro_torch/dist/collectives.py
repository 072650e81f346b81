"""Cross-replica gradient reduction: dense and int8-compressed all-reduce
(port of ``dist/collectives.py``).

``dense_psum_tree`` is the f32 all-reduce: ``torch.distributed.all_reduce``
over the process group of the named mesh dimensions.
``compressed_psum_tree`` moves fewer bytes, as TaxoNN's low-bitwidth MACs
move fewer bits: each replica block-scales its gradient to int8
(``quant.compression``), the payload and the scales travel (an
``all_gather`` of each), and every replica decompresses each replica's
part and sums them in replica order.  1 byte an element plus 4/BLOCK of
scales, against 4 dense.

Both treat their input as each replica's own values and return the
elementwise sum over the named dimensions, equal on every replica (the
compressed sum is computed from the same gathered bytes in the same order
on each; the dense one is the backend's all-reduce).  The compressed
error is at most one quantization step a replica: |err| <= n_replicas *
absmax_block / 127 / 2 an element.

The JAX package names mesh axes inside a ``shard_map``, where they are
bound.  Here the mesh is a ``torch.distributed`` ``DeviceMesh``
(``launch.mesh``), passed in or installed around a step with
``mesh_ctx``; a call that names axes with no mesh or no process group
raises, and does not skip the reduction.  A CUDA tensor reduces over an
NCCL group only (no fallback to gloo or host copies).
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Iterable, Optional

import torch
import torch.distributed as dist

from repro_torch.quant.compression import compress_int8, decompress_int8
from repro_torch.util.tree import tree_map

_MESH: contextvars.ContextVar = contextvars.ContextVar("mesh", default=None)
# (ranks of the mesh, its dimension names, the axes) -> process group of
# this rank, for reductions over more than one dimension
_GROUPS: dict = {}


@contextlib.contextmanager
def mesh_ctx(mesh):
    """Install ``mesh`` as the ambient mesh of the enclosed calls (the
    engine's dW reduction names axes of it, ``QuantPolicy.dw_psum_axes``),
    as a ``shard_map`` body binds the JAX package's axis names."""
    token = _MESH.set(mesh)
    try:
        yield mesh
    finally:
        _MESH.reset(token)


def current_mesh():
    return _MESH.get()


def _axis_sizes(mesh) -> dict:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _reduce_size(mesh, axes) -> int:
    shape = _axis_sizes(mesh)
    n = 1
    for a in axes:
        n *= shape[a]
    return n


def _group(axes: tuple, mesh, x: torch.Tensor):
    """The process group over the mesh dimensions ``axes`` that holds this
    rank; raises where no mesh or process group is there to reduce over,
    or where a CUDA tensor would reduce over a group that is not NCCL."""
    mesh = mesh if mesh is not None else _MESH.get()
    if mesh is None or not dist.is_initialized():
        raise RuntimeError(
            f"a reduction over the mesh axes {axes} needs a process group "
            f"(torch.distributed.init_process_group) and a mesh "
            f"(launch.mesh, passed in or installed with dist.mesh_ctx); "
            f"without them it would be skipped")
    names = tuple(mesh.mesh_dim_names)
    missing = [a for a in axes if a not in names]
    if missing:
        raise ValueError(f"no mesh axes {missing}; the mesh has {names}")
    if len(axes) == 1:
        group = mesh.get_group(axes[0])
    else:
        ranks = mesh.mesh
        key = (tuple(ranks.flatten().tolist()), names, axes)
        if key not in _GROUPS:
            # the reduced dimensions last, one row a group; every rank
            # creates every group, in the same order
            keep = [i for i, a in enumerate(names) if a not in axes]
            red = [names.index(a) for a in axes]
            rows = ranks.permute(*keep, *red).reshape(
                -1, _reduce_size(mesh, axes)).tolist()
            _GROUPS[key], _ = dist.new_subgroups_by_enumeration(rows)
        group = _GROUPS[key]
    if x.is_cuda and dist.get_backend(group) != "nccl":
        raise RuntimeError(f"a CUDA tensor reduces over NCCL, not over "
                           f"{dist.get_backend(group)}")
    return group


def dense_psum(x: torch.Tensor, axes: Iterable[str] = (), *,
               mesh=None) -> torch.Tensor:
    """One tensor's f32 all-reduce over the mesh axes ``axes`` (the JAX
    package's ``lax.psum``); with no axes, ``x`` itself."""
    axes = tuple(axes)
    if not axes:
        return x
    group = _group(axes, mesh, x)
    y = x.clone()
    dist.all_reduce(y, group=group)
    return y


def dense_pmax(x: torch.Tensor, axes: Iterable[str] = (), *,
               mesh=None) -> torch.Tensor:
    """One tensor's elementwise max over the mesh axes ``axes`` (the JAX
    package's ``lax.pmax``); with no axes, ``x`` itself."""
    axes = tuple(axes)
    if not axes:
        return x
    group = _group(axes, mesh, x)
    y = x.clone()
    dist.all_reduce(y, op=dist.ReduceOp.MAX, group=group)
    return y


def dense_psum_tree(grads, mesh, axes: Iterable[str]):
    """Elementwise sum of ``grads`` across the mesh axes ``axes``."""
    axes = tuple(axes)
    return tree_map(lambda x: dense_psum(x, axes, mesh=mesh), grads)


def compressed_psum(x: torch.Tensor, axes: Iterable[str] = (),
                    num_replicas: Optional[int] = None, *,
                    mesh=None) -> torch.Tensor:
    """One-tensor int8 block-scaled all-reduce (the dW wire format).

    The engine's backward loop calls it a leaf at a time
    (``QuantPolicy.compress_dw``).  With ``axes`` naming mesh axes it
    gathers every replica's payload and scales and sums their
    decompressions in replica order; with ``num_replicas`` 1 it is the
    codec round trip.  With no axes it is the codec round trip and honours
    ``num_replicas`` as the simulated reduction size: ``n`` replicas of a
    replicated value sum to ``n * decompress(compress(x))``.
    """
    axes = tuple(axes)
    group = _group(axes, mesh, x) if axes else None
    payload, scales = compress_int8(x)
    if not axes or num_replicas == 1:
        dec = decompress_int8(payload, scales, x.shape, x.dtype)
        if not axes and num_replicas is not None and num_replicas > 1:
            dec = (dec.to(torch.float32) * num_replicas).to(x.dtype)
        return dec
    return _gather_sum(x, payload, scales, group)


def _gather_sum(x: torch.Tensor, payload: torch.Tensor, scales: torch.Tensor,
                group) -> torch.Tensor:
    """Gather every replica's compressed ``x`` over ``group`` and sum the
    decompressions in replica order."""
    n = dist.get_world_size(group)
    pg = [torch.empty_like(payload) for _ in range(n)]
    sg = [torch.empty_like(scales) for _ in range(n)]
    dist.all_gather(pg, payload, group=group)
    dist.all_gather(sg, scales, group=group)
    out = decompress_int8(pg[0], sg[0], x.shape, torch.float32)
    for p, s in zip(pg[1:], sg[1:]):
        out = out + decompress_int8(p, s, x.shape, torch.float32)
    return out.to(x.dtype)


def compressed_psum_tree(grads, mesh, axes: Iterable[str]):
    """int8 block-scaled all-reduce of a tree: compress locally, move the
    compressed bytes, decompress and sum on every replica."""
    axes = tuple(axes)
    n = _reduce_size(mesh, axes)
    return tree_map(
        lambda x: compressed_psum(x, axes, num_replicas=n, mesh=mesh), grads)
