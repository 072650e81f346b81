"""Partition specs for parameters, optimizer state, batches and decode
state, and the shards they cut (port of ``dist/sharding.py``).

Policy (megatron-style 2D: data axes x "model"):

  * embedding [V, D]          -> vocab-sharded over "model" (the CE head is
                                 vocab-parallel; the lookup psums)
  * attention q/k/v [D, H, h] -> head-sharded over "model"
  * attention out  [H, h, D]  -> head-sharded (row-parallel: one psum)
  * MLP up/gate [D, F]        -> column-parallel; down [F, D] row-parallel
  * MoE expert stacks [E,D,F] -> expert-parallel when E divides the model
                                 axis, else F-sharded
  * vectors / norms / biases  -> replicated
  * anything unrecognized     -> replicated

Every rule is divisibility-guarded: a dim that the model size does not
divide stays replicated.  Stacked parameters carry a leading layer axis;
rules address dims from the END, so they apply to stacked and unstacked
leaves alike.

A spec is a ``P``: a tuple of entries, each None, an axis name or a tuple
of names, equal entry for entry to the JAX package's ``PartitionSpec``.
The port places tensors itself: ``shard_tree`` cuts a tree to this rank's
slices at its "model" coordinate (what ``jax.device_put`` with
``to_named``'s shardings leaves on a device), ``gather_tree`` puts the
logical tree back together (for checkpoints and tests), and ``to_named``
and ``replicated`` give the placement records (``Placement``) of a spec
tree.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.distributed as dist


class P(tuple):
    """A partition spec: one entry a dimension (None, an axis name, or a
    tuple of axis names), as ``jax.sharding.PartitionSpec(*entries)``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return "P" + super().__repr__()


class Placement(NamedTuple):
    """A spec on a mesh: the port's counterpart of ``NamedSharding``."""
    mesh: object
    spec: P


def _is_pspec(x) -> bool:
    return isinstance(x, P)


def _map(fn, tree, *rest, leaf=None):
    """``fn`` over the leaves of a tree of dicts, lists and tuples (and the
    matching leaves of ``rest``); ``leaf(x)`` marks more leaf types."""
    if leaf is not None and leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(r[k] for r in rest), leaf=leaf)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not _is_pspec(tree):
        return type(tree)(_map(fn, v, *(r[i] for r in rest), leaf=leaf)
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def _map_with_path(fn, tree, path=()):
    """``fn(path names, leaf)`` over a tree of dicts, lists and tuples; a
    list index names itself as ``"[i]"``, as the JAX package's path keys
    print."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, path + (f"[{i}]",))
                          for i, v in enumerate(tree))
    return fn(list(path), tree)


def mesh_axis_sizes(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh`` (``mesh_dim_names``, a shape
    tuple) or of a JAX-style mesh record (``axis_names``, a shape dict)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    shape = mesh.shape
    if isinstance(shape, dict):
        return {a: shape[a] for a in mesh.axis_names}
    return dict(zip(mesh.axis_names, shape))


def to_named(pspecs, mesh):
    """Spec tree -> ``Placement`` tree on ``mesh``."""
    return _map(lambda s: Placement(mesh, s), pspecs, leaf=_is_pspec)


def replicated(specs, mesh):
    """Fully-replicated ``Placement`` tree matching ``specs``' structure."""
    return _map(lambda _: Placement(mesh, P()), specs, leaf=_is_pspec)


def _model_size(mesh) -> int:
    return mesh_axis_sizes(mesh).get("model", 1)


def _batch_axes(mesh) -> tuple:
    return tuple(a for a in mesh_axis_sizes(mesh) if a in ("pod", "data"))


def _axes_size(mesh, axes) -> int:
    shape = mesh_axis_sizes(mesh)
    n = 1
    for a in axes:
        n *= shape[a]
    return n


def _spec(ndim: int, dim_from_end: int, axis: str) -> P:
    """P with ``axis`` at position ndim-dim_from_end, None elsewhere."""
    entries = [None] * ndim
    entries[ndim - dim_from_end] = axis
    return P(*entries)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def _param_spec(path_names, leaf_name: str, shape, m: int) -> P:
    nd = len(shape)

    def ok(dim_from_end: int) -> bool:
        return nd >= dim_from_end and shape[nd - dim_from_end] % m == 0

    if m <= 1 or nd == 0:
        return P()

    in_moe = "moe" in path_names and "shared" not in path_names

    if leaf_name == "embed" and nd == 2:
        return _spec(nd, 2, "model") if ok(2) else P()
    if leaf_name == "lm_head" and nd == 2:
        return _spec(nd, 1, "model") if ok(1) else P()

    if leaf_name in ("wq", "wk", "wv") and nd >= 3:
        return _spec(nd, 2, "model") if ok(2) else P()     # [.., D, H, hd]
    if leaf_name in ("bq", "bk", "bv") and nd >= 2:
        return _spec(nd, 2, "model") if ok(2) else P()     # [.., H, hd]
    if leaf_name == "wo" and nd >= 3:
        return _spec(nd, 3, "model") if ok(3) else P()     # [.., H, hd, D]

    # MLA projections
    if leaf_name in ("w_uk", "w_uv") and nd >= 3:
        return _spec(nd, 2, "model") if ok(2) else P()     # [.., r, H, hd]

    if in_moe:
        if leaf_name in ("w_gate", "w_up") and nd >= 3:    # [.., E, D, F]
            if ok(3):
                return _spec(nd, 3, "model")
            return _spec(nd, 1, "model") if ok(1) else P()
        if leaf_name == "w_down" and nd >= 3:              # [.., E, F, D]
            if ok(3):
                return _spec(nd, 3, "model")
            return _spec(nd, 2, "model") if ok(2) else P()
        if leaf_name == "router":
            return P()
    else:
        if leaf_name in ("w_gate", "w_up") and nd >= 2:    # [.., D, F]
            return _spec(nd, 1, "model") if ok(1) else P()
        if leaf_name == "w_down" and nd >= 2:              # [.., F, D]
            return _spec(nd, 2, "model") if ok(2) else P()

    # Mamba projections: shard the d_inner columns
    if leaf_name in ("w_z", "w_x") and nd >= 2:
        return _spec(nd, 1, "model") if ok(1) else P()
    if leaf_name == "out_proj" and nd >= 2:
        return _spec(nd, 2, "model") if ok(2) else P()

    return P()


def param_pspecs(cfg, params, mesh):
    """Spec tree mirroring ``params`` (tensors, meta tensors or anything
    with a ``shape``)."""
    m = _model_size(mesh)
    return _map_with_path(
        lambda names, leaf: _param_spec(names, names[-1] if names else "",
                                        tuple(leaf.shape), m), params)


# ---------------------------------------------------------------------------
# Optimizer state
# ---------------------------------------------------------------------------

def opt_pspecs(cfg, opt_specs, p_pspecs, mesh):
    """Specs for the train state: moment buffers inherit their parameter's
    spec; ``m_s`` (rowwise int8-momentum scales) drops the last dim."""
    def drop_last(s: P) -> P:
        return P(*tuple(s)[:-1]) if len(tuple(s)) else P()

    out = {}
    for key, state in opt_specs.items():
        pspec = p_pspecs[key]
        fields = {}
        for fname in state:
            if fname == "m_s":
                fields[fname] = _map(drop_last, pspec, leaf=_is_pspec)
            else:
                fields[fname] = pspec
        out[key] = fields
    return out


# ---------------------------------------------------------------------------
# Batches
# ---------------------------------------------------------------------------

def batch_pspecs(specs, mesh):
    """Shard dim 0 of every batch leaf over the data axes (divisibility-
    guarded); scalars and non-divisible leaves replicate."""
    baxes = _batch_axes(mesh)
    n = _axes_size(mesh, baxes)

    def spec(leaf):
        shape = tuple(leaf.shape)
        if not baxes or not shape or shape[0] % n != 0:
            return P()
        entry = baxes[0] if len(baxes) == 1 else baxes
        return P(entry, *([None] * (len(shape) - 1)))

    return _map(spec, specs)


# ---------------------------------------------------------------------------
# Decode state
# ---------------------------------------------------------------------------

def decode_state_pspecs(cfg, state_specs, mesh):
    """Serving-state specs: caches shard their batch dim over the data axes.

    Plain families stack per-layer caches as [L, B, ...]; hybrid attention
    caches are [G, B, ...] and hybrid mamba caches [G, K, B, ...].
    ``pos`` is a replicated scalar.
    """
    baxes = _batch_axes(mesh)
    n = _axes_size(mesh, baxes)
    entry = None if not baxes else (baxes[0] if len(baxes) == 1 else baxes)

    def spec(names, leaf):
        shape = tuple(leaf.shape)
        if entry is None or "pos" in names or len(shape) < 2:
            return P()
        bdim = 2 if "mamba" in names else 1
        if len(shape) <= bdim or shape[bdim] % n != 0:
            return P()
        entries = [None] * len(shape)
        entries[bdim] = entry
        return P(*entries)

    return _map_with_path(spec, state_specs)


# ---------------------------------------------------------------------------
# The shards: this rank's slices, and the logical tree back
# ---------------------------------------------------------------------------

# the mesh axes of the model group (the collectives' ``axes``)
MODEL = ("model",)


def model_dim(spec) -> Optional[int]:
    """The dimension a spec places over "model", or None (also for no
    spec)."""
    for d, e in enumerate(tuple(spec or ())):
        if e == "model" or (isinstance(e, tuple) and "model" in e):
            return d
    return None


def shard_leaf(x: torch.Tensor, spec, m: int, index: int) -> torch.Tensor:
    """Slice ``index`` of ``m`` of ``x`` along its "model" dimension (a
    contiguous copy), or ``x`` itself where ``spec`` replicates it."""
    d = model_dim(spec)
    if d is None or m <= 1:
        return x
    size = x.shape[d] // m
    return x.narrow(d, index * size, size).contiguous()


def shard_tree(tree, pspecs, mesh, *, index: Optional[int] = None):
    """This rank's local slices of ``tree``: each leaf cut along the
    dimension its spec places over "model", at the rank's coordinate on
    the mesh's "model" axis (``index`` names another coordinate, e.g. to
    lay out every rank's share on one device)."""
    m = _model_size(mesh)
    if index is None:
        index = (int(mesh.get_local_rank("model"))
                 if "model" in mesh_axis_sizes(mesh) else 0)
    return _map(lambda x, s: shard_leaf(x, s, m, index), tree, pspecs)


def gather_tree(shards, pspecs, mesh):
    """The logical tree from every rank's ``shards``: each sharded leaf
    all-gathered over the mesh's "model" group and concatenated along its
    dimension in coordinate order; replicated leaves as they are."""
    m = _model_size(mesh)
    if m <= 1:
        return shards
    group = mesh.get_group("model")

    def gather(x, s):
        d = model_dim(s)
        if d is None:
            return x
        parts = [torch.empty_like(x) for _ in range(m)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=d)

    return _map(gather, shards, pspecs)
