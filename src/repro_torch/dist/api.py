"""Activation-sharding rules, perf options, and the ``constrain`` primitive
(port of ``dist/api.py``).

The model code never names mesh axes directly.  It tags intermediate
activations with a *logical layout string*, one lowercase letter per
dimension:

    b  batch                  (the data axes: ("pod",) "data")
    t  sequence / tokens      (over "model" only under seq_parallel)
    d  d_model / feature      (replicated: the residual stream)
    v  vocab                  (over "model": the vocab-parallel CE head)
    e  experts                (left to the partitioner)
    c  expert capacity        (left to the partitioner)

``make_default_rules(batch_axes, seq_parallel=...)`` builds the table of
letters to mesh axes, ``activation_sharding_ctx(rules)`` installs it, and
``_spec_for`` turns a tag into the spec (``dist.sharding.P``) that the JAX
package's ``constrain`` hands its partitioner, entry for entry.

``constrain(x, tag)`` returns ``x`` itself, inside a mesh and rules too.
The JAX package leaves the layout of an activation to XLA's partitioner
and constrains it; the port runs tensor parallelism explicitly: each rank
holds its shards (``dist.sharding.shard_tree``), and the parallel units
(``models.layers``, ``models.lm``) call the "model" group's collectives
themselves, so every activation already is in the layout its tag names
(the residual stream ``"btd"`` replicated over "model", the CE head's
``"btv"`` logits vocab-local).  Nothing is left to move.  The call sites
stay where the JAX package has them, so that a reader finds each
counterpart.

Perf options (``perf_options_ctx`` / ``perf_opt``) are feature flags
(seq_parallel, moe_rowcombine, ce_bf16, flash_attn, pad_heads) read when a
step runs.  ``seq_parallel`` is accepted and leaves the residual stream
replicated, so it computes the same function (the sequence-sharded layout,
a reduce-scatter and all-gather pair, is a parked speed item).
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Iterable, Optional

# the ambient mesh, installed with ``dist.mesh_ctx``, or None
from repro_torch.dist.collectives import current_mesh
from repro_torch.dist.sharding import P, mesh_axis_sizes


class _Unconstrained:
    """Sentinel for "leave this dimension to the partitioner" (the JAX
    package's ``PartitionSpec.UNCONSTRAINED``)."""

    def __repr__(self) -> str:
        return "UNCONSTRAINED"


UNCONSTRAINED = _Unconstrained()

_RULES: contextvars.ContextVar[Optional[dict]] = contextvars.ContextVar(
    "activation_sharding_rules", default=None)
_PERF: contextvars.ContextVar[frozenset] = contextvars.ContextVar(
    "perf_options", default=frozenset())


# ---------------------------------------------------------------------------
# Perf options
# ---------------------------------------------------------------------------

KNOWN_PERF_OPTS = frozenset({
    "seq_parallel", "pad_heads", "moe_rowcombine", "ce_bf16", "flash_attn",
})


@contextlib.contextmanager
def perf_options_ctx(opts: Iterable[str]):
    """Enable a set of §Perf options for the enclosed calls."""
    opts = frozenset(opts)
    unknown = opts - KNOWN_PERF_OPTS
    if unknown:
        raise ValueError(f"unknown perf options: {sorted(unknown)}")
    token = _PERF.set(_PERF.get() | opts)
    try:
        yield
    finally:
        _PERF.reset(token)


def perf_opt(name: str) -> bool:
    """Is the named perf option active?"""
    return name in _PERF.get()


# ---------------------------------------------------------------------------
# Sharding rules
# ---------------------------------------------------------------------------

def make_default_rules(batch_axes: Iterable[str],
                       seq_parallel: bool = False) -> dict:
    """Letter -> mesh-axis assignment table (see module docstring).

    ``batch_axes`` are the data-parallel mesh axes, e.g. ``("data",)`` or
    ``("pod", "data")``; the batch dimension shards over all of them.
    ``seq_parallel`` also names "model" for the sequence dimension (the
    JAX package's Megatron sequence parallelism).
    """
    batch_axes = tuple(batch_axes)
    return {
        "b": batch_axes,
        "t": "model" if seq_parallel else None,
        "d": None,
        "v": "model",
        "e": UNCONSTRAINED,
        "c": UNCONSTRAINED,
        # the paged-KV pool [L, N_blocks, block, kv_heads, head_dim] tagged
        # "lnshd": blocks over the data axes, KV heads over "model"
        "l": None,
        "n": batch_axes,
        "s": None,
        "h": "model",
    }


@contextlib.contextmanager
def activation_sharding_ctx(rules: Optional[dict]):
    """Install a rules table for ``constrain`` inside the block."""
    token = _RULES.set(rules)
    try:
        yield
    finally:
        _RULES.reset(token)


def current_rules() -> Optional[dict]:
    return _RULES.get()


# ---------------------------------------------------------------------------
# Mesh context
# ---------------------------------------------------------------------------

def model_axis_size_ctx() -> int:
    """Size of the tensor-parallel "model" axis of the ambient mesh (1 if
    no mesh is set or the mesh has no model axis)."""
    mesh = current_mesh()
    if mesh is None:
        return 1
    return mesh_axis_sizes(mesh).get("model", 1)


def model_axis_index_ctx() -> int:
    """This rank's coordinate on the ambient mesh's "model" axis (0 with
    no mesh or no model axis)."""
    mesh = current_mesh()
    if mesh is None or "model" not in mesh_axis_sizes(mesh):
        return 0
    return int(mesh.get_local_rank("model"))


# ---------------------------------------------------------------------------
# constrain
# ---------------------------------------------------------------------------

def _axis_size(mesh_shape: dict, entry) -> int:
    if isinstance(entry, str):
        return mesh_shape[entry]
    n = 1
    for a in entry:
        n *= mesh_shape[a]
    return n


# When two letters in one tag claim the same mesh axis (e.g. "btv" under
# seq_parallel: 't' and 'v' both want "model"), the lower number wins and
# the loser replicates.  Vocab beats sequence: the CE head's masked-target
# reduction needs V sharded (see lm.ce_from_weight).
_AXIS_PRIORITY = {"b": 0, "n": 0, "v": 1, "h": 1, "e": 2, "c": 2, "d": 3,
                  "t": 4, "l": 5, "s": 5}


def _spec_for(logical: str, ndim: int, rules: dict, mesh,
              shape) -> Optional[P]:
    """The spec of ``logical`` against ``mesh``, entry for entry the JAX
    package's.

    Rank adaptation: when the array has fewer dims than the tag (e.g. a
    [B, V] last-token logits tensor tagged "btv"), the first letter maps to
    dim 0 and the trailing letters to the trailing dims.  Axes missing from
    the mesh, already-used axes, and non-divisible dims degrade to None
    (replicated) rather than erroring.
    """
    if ndim < len(logical):
        logical = logical[0] + logical[len(logical) - (ndim - 1):] \
            if ndim >= 2 else logical[-1]
    elif ndim > len(logical):
        return None  # the tag can't describe this array

    mesh_shape = mesh_axis_sizes(mesh)
    mesh_axes = set(mesh_shape)
    used: set = set()
    entries = [None] * len(logical)
    order = sorted(range(len(logical)),
                   key=lambda i: _AXIS_PRIORITY.get(logical[i], 5))
    for dim in order:
        entry = rules.get(logical[dim], UNCONSTRAINED)
        if entry is UNCONSTRAINED:
            entries[dim] = UNCONSTRAINED
            continue
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        axes = tuple(a for a in axes if a in mesh_axes and a not in used)
        if not axes:
            continue
        if shape[dim] % _axis_size(mesh_shape, axes) != 0:
            continue  # uneven shard: leave replicated
        used.update(axes)
        entries[dim] = axes[0] if len(axes) == 1 else axes
    return P(*entries)


def constrain(x, logical: str):
    """``x`` itself: outside a mesh and rules, as in the JAX package; inside
    them because the explicit collectives of the parallel units already
    leave ``x`` in the layout that ``logical`` names (module docstring)."""
    return x
