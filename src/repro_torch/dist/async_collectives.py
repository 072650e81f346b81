"""Bucketed ring all-reduce with start/wait handles, and the transport
autotuner (port of ``dist/async_collectives.py``).

The communication-overlapped backward loop (``core.taxonn.backward_stack``
with ``QuantPolicy.overlap="on"``) is built from two pieces:

  * a **ring all-reduce** of g-1 reduce-scatter hops and g-1 all-gather
    hops between the ranks of a process group (CATERPILLAR's interleaved
    ring reduction, Li & Pedram 2017).  Each hop is one
    ``torch.distributed.batch_isend_irecv``: this rank sends to group rank
    ``(r+1) % g`` and receives from ``(r-1) % g``, as the JAX package's
    ``lax.ppermute`` over the perm ``i -> i+1``.  The segments, the
    zero padding, the buckets and the order of the adds are the JAX
    package's, so the ring's sums are bitwise its ring's;

  * an **AsyncHandle start/wait API** that splits the ring at its seam so
    that the two halves can run in different iterations of the layer
    loop::

        handle = all_reduce_start(dW_i, axes)     # layer i
        ... the next layers' VJP and G-step ...
        dW_i   = all_reduce_wait(handle)          # depth layers later

Dense split: ``start`` runs the reduce-scatter hops and the handle holds
this rank's reduced 1/g segment; ``wait`` runs the all-gather hops.
Compressed split (the int8 wire format of ``quant.compression``):
``start`` runs a decompress-add-recompress reduce-scatter ring, each hop
moving one compressed 1/g segment, and the handle holds this rank's fully
reduced compressed segment; ``wait`` gathers the compressed segments and
decompresses.  The error against ``collectives.compressed_psum`` is at
most one codec half-step per compression event:
``|err| <= (2g - 2) * max_block_absmax / 254`` an element.

Transports (``transport=``): ``"ring"`` as above; ``"psum"`` issues the
all-reduce at ``start`` (dense: one asynchronous all-reduce, whose
``Work`` the handle holds and ``wait`` completes; at the tree API one
all-reduce of one flat buffer for every psum leaf of a dtype, as JAX's
variadic ``lax.psum`` is one collective; compressed:
``collectives.compressed_psum``); ``"scatter"`` (dense only) is the native
reduce-scatter (``dist.reduce_scatter_tensor``) at ``start`` and the
all-gather (``dist.all_gather_into_tensor``) at ``wait``, whose 1/g chunk
the caller can update before gathering (``shard_chunk`` /
``reduce_scatter_chunk`` / ``all_gather_chunks``; chunk d is group rank
d's).  ``"auto"`` asks ``decide_transport``: forced by
``REPRO_TRANSPORT``, else a cached decision (keys exactly the JAX
package's, so a checkpoint's decisions cross-load both ways), else a
measurement of the reduce + update-tail composite over the first g ranks
of the default process group, else a platform model.

The measurement is collective: every rank of the default group times the
transports (ranks past g only wait) and the times are all-reduced with MAX
before the minimum is taken, so every rank caches the same pick and the
group never splits over a transport.  It follows that every rank must
call ``decide_transport``/``prime_transport_cache`` with the same sizes
in the same order and hold the same cache (a checkpoint's decisions are
installed on every rank).  The step itself never measures.

Axes name dimensions of the ambient mesh (``collectives.mesh_ctx``) or
of a ``mesh=`` passed in, as ``collectives.dense_psum`` does; with no axes
or a group of one nothing moves and ``wait(start(x))`` is ``x`` bitwise
(the compressed form: the codec round trip, times ``num_replicas`` with no
axes), which keeps the overlapped loop a pure schedule change on one
device.  A torch rank is a process, so the ring runs across processes by
design: the JAX package's single-process guard has no counterpart.  Axes
with no process group raise; a CUDA tensor moves over NCCL only
(``collectives._group``).
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
import warnings
from typing import Iterable, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.dist.collectives import (_gather_sum, _group,
                                          compressed_psum, current_mesh)
from repro_torch.quant.compression import (BLOCK, compress_int8,
                                           decompress_int8)
from repro_torch.util.tree import tree_leaves, tree_unflatten

# Auto-bucketing: one bucket per this many payload bytes (capped), the JAX
# package's rule; the port moves a hop's buckets in one message
BUCKET_BYTES = 1 << 20
MAX_BUCKETS = 4

TRANSPORTS = ("ring", "psum", "scatter")
# model fallback: below this payload a ring is latency-bound on a GPU and
# the fused psum wins; CPU (gloo) ranks share one host, so the model never
# picks the ring there
RING_MIN_BYTES = 1 << 20


def _transports_for(compressed: bool) -> Tuple[str, ...]:
    """The compressed wire format has no reduce-scatter split (the int8
    codec blocks straddle the 1/g segment boundary), so ``scatter`` is a
    dense-only transport."""
    return ("ring", "psum") if compressed else TRANSPORTS


def group_size(axes: Iterable[str], num_replicas: Optional[int] = None, *,
               mesh=None) -> int:
    """The reduction group's size over the named mesh axes:
    ``num_replicas`` where given, else the product of the axes' sizes in
    ``mesh`` or the ambient mesh (``collectives.mesh_ctx``)."""
    axes = tuple(axes)
    if num_replicas is not None:
        return int(num_replicas)
    if not axes:
        return 1
    mesh = mesh if mesh is not None else current_mesh()
    shape = (dict(zip(mesh.mesh_dim_names, mesh.shape))
             if mesh is not None else {})
    n = 1
    for a in axes:
        if a not in shape:
            raise ValueError(
                f"cannot resolve ring-group size: axis {a!r} not in the "
                f"ambient mesh {tuple(shape)}; pass num_replicas= explicitly")
        n *= shape[a]
    return n


def _num_buckets(nbytes: int, num_buckets: Optional[int]) -> int:
    if num_buckets is not None:
        return max(1, int(num_buckets))
    return max(1, min(MAX_BUCKETS, nbytes // BUCKET_BYTES))


# ---------------------------------------------------------------------------
# transport autotuner: ring vs psum vs scatter, per payload-size bucket
# ---------------------------------------------------------------------------

# (compressed, size_bucket_bytes, g) -> {"transport", "source", "us"}
_TRANSPORT_CACHE: dict = {}
# g -> the process group of the default group's first g ranks (measuring)
_MEASURE_GROUPS: dict = {}


def _size_bucket(nbytes: int) -> int:
    """Round the payload up to a power of two (at least 4 KiB) so that
    near-identical tensors share one decision."""
    b = 1 << 12
    while b < nbytes:
        b <<= 1
    return b


def _forced_transport() -> Optional[str]:
    forced = os.environ.get("REPRO_TRANSPORT", "").strip().lower()
    if forced in TRANSPORTS:
        return forced
    if forced and forced != "auto":
        raise ValueError(
            f"REPRO_TRANSPORT={forced!r} not in {TRANSPORTS + ('auto',)}")
    return None


def _on_nccl() -> bool:
    return dist.is_initialized() and dist.get_backend() == "nccl"


def _model_transport(nbytes: int, g: int, compressed: bool = False) -> str:
    """The decision where no measurement can run.  The default process
    group's device decides (the CPU without one): gloo ranks on one host
    share its memory, so the ring has nothing to overlap into and the
    model gives ``psum`` for the compressed format and ``scatter`` for
    dense payloads (the same bytes as one psum, and a 1/g shard for the
    update); over NCCL the ring from ``RING_MIN_BYTES`` up, else
    ``psum``."""
    if not _on_nccl():
        return "psum" if compressed else "scatter"
    return "ring" if nbytes >= RING_MIN_BYTES else "psum"


def _measure_group(g: int):
    """The process group of the default group's first g ranks (the default
    group itself at its full size); every rank creates it, in the same
    order."""
    if g == dist.get_world_size():
        return dist.group.WORLD
    if g not in _MEASURE_GROUPS:
        _MEASURE_GROUPS[g] = dist.new_group(list(range(g)))
    return _MEASURE_GROUPS[g]


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _measure_transport(nbytes: int, g: int, compressed: bool,
                       reps: int = 3) -> dict:
    """Time each transport's REDUCE + UPDATE-TAIL composite for one
    bucket-sized payload over the first g ranks of the default group:
    what the backward loop instantiates per dW leaf is reduce -> SGD
    saxpy -> the updated tensor on every rank, and the transports differ
    in where the saxpy runs (``psum``/``ring`` update the whole tensor on
    every rank, ``scatter`` this rank's 1/g shard and gathers the result).

    Collective over the whole default group: the members time, every rank
    all-reduces the times with MAX, so every rank returns the same
    microseconds."""
    dev = (torch.device("cuda", torch.cuda.current_device()) if _on_nccl()
           else torch.device("cpu"))
    group = _measure_group(g)
    transports = _transports_for(compressed)
    times = torch.zeros(len(transports), dtype=torch.float64, device=dev)
    if dist.get_rank() < g:
        ring = _ring_of(group, g)
        n = max(BLOCK * g, (nbytes // 4 // (BLOCK * g)) * BLOCK * g)
        x = torch.arange(n, dtype=torch.float32, device=dev) / n
        lr = torch.tensor(0.01, dtype=torch.float32, device=dev)

        def build(transport):
            if transport == "scatter":
                def f(v):
                    shard = _reduce_scatter_chunk(v, ring)
                    new = _flat_padded(v, g)[ring.idx] - lr * shard
                    return _all_gather_chunks(new, ring, v.shape, v.dtype)
            else:
                def f(v):
                    h = _start(v, ring, (), compressed=compressed,
                               num_buckets=None, dummy=False,
                               transport=transport)
                    return v - lr * all_reduce_wait(h)
            return f

        for k, transport in enumerate(transports):
            fn = build(transport)
            fn(x)                                  # warm
            _sync(dev)
            t0 = time.perf_counter()
            for _ in range(reps):
                fn(x)
                _sync(dev)
            times[k] = (time.perf_counter() - t0) / reps * 1e6
    dist.all_reduce(times, op=dist.ReduceOp.MAX)
    return dict(zip(transports, times.tolist()))


def decide_transport(nbytes: int, g: int, *, compressed: bool = False,
                     allow_measure: bool = True) -> str:
    """Pick the transport for one payload: forced (``REPRO_TRANSPORT``) >
    cached > measured (``allow_measure``, a default process group of at
    least g ranks) > the platform model.  Decisions are cached per
    (compressed, size bucket, g).  A measurement is collective over the
    default group (module docstring); once it has started nothing is
    caught."""
    forced = _forced_transport()
    if forced is not None:
        # the compressed wire format has no scatter split
        return "psum" if (compressed and forced == "scatter") else forced
    if g <= 1:
        return "psum"                     # nothing moves; no cache entry
    key = (bool(compressed), _size_bucket(nbytes), int(g))
    hit = _TRANSPORT_CACHE.get(key)
    if hit is not None:
        return hit["transport"]
    if allow_measure and dist.is_initialized() \
            and g <= dist.get_world_size():
        us = _measure_transport(key[1], g, compressed)
        pick = min(us, key=us.get)
        _TRANSPORT_CACHE[key] = {"transport": pick, "source": "measured",
                                 "us": us}
        return pick
    pick = _model_transport(nbytes, g, compressed)
    _TRANSPORT_CACHE[key] = {"transport": pick, "source": "model", "us": {}}
    return pick


def prime_transport_cache(sizes_bytes: Iterable[int], g: int, *,
                          compressed: bool = False) -> dict:
    """Measure and cache the decisions a run will need before its first
    step (the step only consults the cache or the model).  Collective when
    it measures: every rank calls it with the same sizes.  Returns
    {bucket_bytes: transport}."""
    out = {}
    for nbytes in sorted({_size_bucket(int(b)) for b in sizes_bytes}):
        out[nbytes] = decide_transport(nbytes, g, compressed=compressed)
    return out


def transport_cache_snapshot() -> dict:
    """Copy of the decision cache, with the JAX package's key strings."""
    return {f"compressed={k[0]},bytes={k[1]},g={k[2]}": dict(v)
            for k, v in sorted(_TRANSPORT_CACHE.items())}


def dump_transport_cache(path: str) -> None:
    """Persist the decision cache as JSON."""
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    with open(path, "w") as f:
        json.dump(transport_cache_snapshot(), f, indent=2, sort_keys=True)


def load_transport_cache(snapshot: dict, *, overwrite: bool = False) -> int:
    """Inverse of ``transport_cache_snapshot``: install persisted decisions
    (a checkpoint's, either package's) so that a resumed run reuses the
    original run's transports and so its reduction order.  Returns the
    number of entries installed; malformed entries are skipped."""
    n = 0
    for key, entry in (snapshot or {}).items():
        try:
            parts = dict(p.split("=", 1) for p in key.split(","))
            k = (parts["compressed"] == "True", int(parts["bytes"]),
                 int(parts["g"]))
            transport = entry["transport"]
        except (KeyError, ValueError, AttributeError, TypeError):
            continue
        if transport not in TRANSPORTS:
            continue
        if not overwrite and k in _TRANSPORT_CACHE:
            continue
        source = entry.get("source", "?")
        _TRANSPORT_CACHE[k] = {"transport": transport,
                               "source": f"restored:{source}",
                               "us": dict(entry.get("us") or {})}
        n += 1
    return n


def clear_transport_cache() -> None:
    _TRANSPORT_CACHE.clear()


# ---------------------------------------------------------------------------
# the ring's group and its hop
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _Ring:
    """A reduction group as the ring sees it: the process group, its size
    and this rank's index in it (the JAX package's ``axis_index``)."""
    group: object
    g: int
    idx: int

    def peer(self, k: int) -> int:
        """The default-group rank of group rank ``k % g``."""
        return dist.get_global_rank(self.group, k % self.g)


def _ring_of(group, g: int) -> _Ring:
    size = dist.get_world_size(group)
    if size != g:
        raise ValueError(f"a ring of {g} ranks over a process group of "
                         f"{size}")
    return _Ring(group, g, dist.get_group_rank(group, dist.get_rank()))


def _ring(axes: tuple, g: int, mesh, x: torch.Tensor) -> _Ring:
    return _ring_of(_group(axes, mesh, x), g)


def _hop(ring: _Ring, *tensors: torch.Tensor) -> list:
    """One ring step (``lax.ppermute`` over ``i -> i+1``): send each tensor
    to group rank idx+1, receive the same shapes from idx-1."""
    nxt, prv = ring.peer(ring.idx + 1), ring.peer(ring.idx - 1)
    outs = [torch.empty_like(t) for t in tensors]
    ops = []
    for tag, (t, o) in enumerate(zip(tensors, outs)):
        ops.append(dist.P2POp(dist.isend, t.contiguous(), nxt, ring.group,
                              tag))
        ops.append(dist.P2POp(dist.irecv, o, prv, ring.group, tag))
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return outs


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


@dataclasses.dataclass
class AsyncHandle:
    """An in-flight all-reduce: ``arrays`` are the in-flight tensors,
    ``works`` the ``torch.distributed`` works ``wait`` completes first,
    ``ring`` the group the wait moves over; the rest is the JAX package's
    static metadata."""

    arrays: Tuple[torch.Tensor, ...]
    kind: str          # "identity" | "dense" | "compressed" | "scatter"
    axis: object
    g: int
    shape: Tuple[int, ...]
    dtype: object
    n_buckets: int
    ring: Optional[_Ring] = None
    works: tuple = ()


def _identity_handle(x: torch.Tensor, works: tuple = ()) -> AsyncHandle:
    return AsyncHandle((x,), "identity", None, 1, tuple(x.shape), x.dtype, 1,
                       works=works)


def _resolve_transport(transport: str, nbytes: int, g: int,
                       compressed: bool) -> str:
    """'auto' consults the cache or the model (never a measurement) and
    the REPRO_TRANSPORT override; an explicit transport wins; ``scatter``
    degrades to ``psum`` on the compressed path."""
    if transport == "auto":
        return decide_transport(int(nbytes), g, compressed=compressed,
                                allow_measure=False)
    if transport not in TRANSPORTS:
        raise ValueError(f"transport={transport!r} not in "
                         f"{TRANSPORTS + ('auto',)}")
    return "psum" if (compressed and transport == "scatter") else transport


def _quiet(fn, *args, **kw):
    """A collective whose name newer torch releases deprecate (a
    FutureWarning each call); the names are kept because older releases
    lack their successors."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        return fn(*args, **kw)


# ---------------------------------------------------------------------------
# scatter transport: native reduce-scatter / all-gather over 1/g chunks
#
# The payload is viewed flat, zero-padded to g equal chunks; group rank d
# owns chunk d.  The chunk is a real 1/g shard the caller can run the
# optimizer update on before gathering: the sharded update of
# ``core.taxonn`` for elementwise optimizers.
# ---------------------------------------------------------------------------

def _chunk_len(shape, g: int) -> int:
    return -(-_numel(shape) // g)


def _flat_padded(x: torch.Tensor, g: int) -> torch.Tensor:
    """[...] -> [g, c] zero-padded flat f32 view (no copy where the size
    divides evenly)."""
    flat = x.to(torch.float32).reshape(-1)
    c = _chunk_len(x.shape, g)
    if g * c != flat.numel():
        flat = torch.cat([flat, flat.new_zeros(g * c - flat.numel())])
    return flat.reshape(g, c)


def _reduce_scatter_chunk(x: torch.Tensor, ring: _Ring,
                          async_op: bool = False):
    flat = _flat_padded(x, ring.g)
    out = flat.new_empty(flat.shape[1])
    work = _quiet(dist.reduce_scatter_tensor, out, flat.reshape(-1),
                  group=ring.group, async_op=async_op)
    return (out, work) if async_op else out


def _all_gather_chunks(chunk: torch.Tensor, ring: _Ring, shape,
                       dtype) -> torch.Tensor:
    full = chunk.new_empty(ring.g * chunk.numel())
    _quiet(dist.all_gather_into_tensor, full, chunk.contiguous(),
           group=ring.group)
    return full[:_numel(shape)].reshape(tuple(shape)).to(dtype)


def _axes_of(axis) -> tuple:
    return tuple(axis) if isinstance(axis, (tuple, list)) else (axis,)


def shard_chunk(x: torch.Tensor, axis, g: int, *, mesh=None) -> torch.Tensor:
    """This rank's [c] chunk of the padded flat f32 view of ``x`` (no
    collective): the parameter side of a sharded update."""
    ring = _ring(_axes_of(axis), g, mesh, x)
    return _flat_padded(x, g)[ring.idx]


def reduce_scatter_chunk(x: torch.Tensor, axis, g: int, *,
                         mesh=None) -> torch.Tensor:
    """Native reduce-scatter: the fully reduced [c] f32 chunk this rank
    owns, in ``shard_chunk``'s and ``all_gather_chunks``' order."""
    return _reduce_scatter_chunk(x, _ring(_axes_of(axis), g, mesh, x))


def all_gather_chunks(chunk: torch.Tensor, axis, g: int, shape, dtype, *,
                      mesh=None) -> torch.Tensor:
    """Inverse of the chunk split: gather every rank's [c] chunk and
    restore the original shape and dtype (padding dropped)."""
    return _all_gather_chunks(chunk, _ring(_axes_of(axis), g, mesh, chunk),
                              shape, dtype)


# ---------------------------------------------------------------------------
# dense ring: start = reduce-scatter phase, wait = all-gather phase
# ---------------------------------------------------------------------------

def _to_chunks(x: torch.Tensor, g: int, n_buckets: int) -> torch.Tensor:
    """[...] -> [n_buckets, g, c] zero-padded chunk view (f32),
    bucket-major so each bucket holds a contiguous [g, c] ring layout."""
    flat = x.to(torch.float32).reshape(-1)
    c = -(-flat.numel() // (g * n_buckets))
    pad = g * n_buckets * c - flat.numel()
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat.reshape(n_buckets, g, c)


def _reduce_scatter(chunks: torch.Tensor, ring: _Ring, hop) -> torch.Tensor:
    """Buckets [nb, g, c] -> this rank's reduced shards [nb, c] after g-1
    hops (every bucket in one message a hop); rank d owns segment
    (d+1) % g."""
    idx, g = ring.idx, ring.g
    acc = chunks[:, idx]
    for s in range(1, g):
        (acc,) = hop(acc)
        acc = acc + chunks[:, (idx - s) % g]
    return acc


def _all_gather_ring(shards: torch.Tensor, ring: _Ring) -> torch.Tensor:
    """Reduced shards [nb, c] (segment (d+1)%g on rank d) -> [nb, g, c]."""
    idx, g = ring.idx, ring.g
    out = shards.new_zeros((shards.shape[0], g, shards.shape[1]))
    out[:, (idx + 1) % g] = shards
    cur = shards
    for s in range(1, g):
        (cur,) = _hop(ring, cur)
        # arrived from rank d-s, which owned segment (d-s+1) % g
        out[:, (idx - s + 1) % g] = cur
    return out


# ---------------------------------------------------------------------------
# compressed ring: decompress-add-recompress reduce-scatter + all-gather
# ---------------------------------------------------------------------------

def _compressed_reduce_scatter(x: torch.Tensor, ring: _Ring, hop):
    """Reduce-scatter ``x`` over the ring in the int8 wire format: each hop
    moves one compressed 1/g segment (payload and block scales), with a
    decompress-add-recompress at every hop.  A segment's chain has g-1
    in-ring compressions plus the final one, the reference path g of its
    own, so it stays within ``(2g - 2) * max_block_absmax / 254`` of
    ``collectives.compressed_psum``.  Returns this rank's reduced
    compressed segment ``(payload int8[c], scales f32[c/BLOCK])``, segment
    (d+1) % g on rank d."""
    idx, g = ring.idx, ring.g
    flat = x.to(torch.float32).reshape(-1)
    c = -(-flat.numel() // g)
    c = -(-c // BLOCK) * BLOCK     # whole scale blocks per segment
    pad = g * c - flat.numel()
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    chunks = flat.reshape(g, c)
    acc = chunks[idx]
    for s in range(1, g):
        payload, scales = hop(*compress_int8(acc))
        acc = decompress_int8(payload, scales, (c,), torch.float32)
        acc = acc + chunks[(idx - s) % g]
    return compress_int8(acc)


def _compressed_all_gather(payload: torch.Tensor, scales: torch.Tensor,
                           ring: _Ring, shape, dtype) -> torch.Tensor:
    """All-gather the reduced compressed segments and decompress."""
    idx, g = ring.idx, ring.g
    c = payload.shape[0]
    full_p = payload.new_zeros((g, c))
    full_s = scales.new_zeros((g, c // BLOCK))
    full_p[(idx + 1) % g], full_s[(idx + 1) % g] = payload, scales
    cur = (payload, scales)
    for s in range(1, g):
        cur = _hop(ring, *cur)
        # arrived from rank d-s, which owned segment (d-s+1) % g
        full_p[(idx - s + 1) % g], full_s[(idx - s + 1) % g] = cur
    out = decompress_int8(full_p.reshape(-1), full_s.reshape(-1), (g * c,),
                          torch.float32)
    return out[:_numel(shape)].reshape(tuple(shape)).to(dtype)


def _start(x, ring: _Ring, axes: tuple, *, compressed, num_buckets, dummy,
           transport) -> AsyncHandle:
    """``all_reduce_start`` past its short cuts, over ``ring``."""
    axis = axes if len(axes) > 1 else (axes[0] if axes else None)
    g = ring.g
    if transport == "psum":
        if dummy:
            return _identity_handle(x)
        if compressed:
            # all_reduce_start takes the named-axes form; the measurement
            # names no axes and hands its group over
            return _identity_handle(_gather_sum(x, *compress_int8(x),
                                                ring.group))
        y = x.clone()
        return _identity_handle(y, (dist.all_reduce(
            y, group=ring.group, async_op=True),))
    if transport == "scatter":
        # the reduce-scatter at start; the handle holds the 1/g reduced
        # chunk and wait all-gathers it (dummy: this rank's own chunk)
        if dummy:
            chunk, works = _flat_padded(x, g)[ring.idx], ()
        else:
            chunk, work = _reduce_scatter_chunk(x, ring, async_op=True)
            works = (work,)
        return AsyncHandle((chunk,), "scatter", axis, g, tuple(x.shape),
                           x.dtype, 1, ring, works)

    def hop(*ts):
        return list(ts) if dummy else _hop(ring, *ts)

    if compressed:
        payload, scales = _compressed_reduce_scatter(x, ring, hop)
        return AsyncHandle((payload, scales), "compressed", axis, g,
                           tuple(x.shape), x.dtype, 1, ring)
    n_buckets = _num_buckets(x.numel() * 4, num_buckets)
    shards = _reduce_scatter(_to_chunks(x, g, n_buckets), ring, hop)
    return AsyncHandle(tuple(shards.unbind(0)), "dense", axis, g,
                       tuple(x.shape), x.dtype, n_buckets, ring)


def all_reduce_start(x: torch.Tensor, axes: Iterable[str] = (), *,
                     compressed: bool = False,
                     num_replicas: Optional[int] = None,
                     num_buckets: Optional[int] = None,
                     dummy: bool = False,
                     transport: str = "auto", mesh=None) -> AsyncHandle:
    """Begin an all-reduce of ``x`` over the named mesh axes (of ``mesh``
    or the ambient mesh); several axes ring over their combined group.

    With no axes (or a group of one) nothing moves: an identity handle
    whose ``wait`` returns ``x`` bitwise (compressed: the codec round trip
    of ``x``, times ``num_replicas`` with no axes, as
    ``collectives.compressed_psum``).

    ``transport`` is ``"auto"`` (``decide_transport`` from the cache or
    the model), ``"ring"``, ``"psum"`` or ``"scatter"``.  ``dummy=True``
    moves nothing and returns a handle of the shapes a real start makes
    (the JAX package's warm-up carry; the port's loop needs none).
    """
    axes = tuple(axes)
    g = group_size(axes, num_replicas, mesh=mesh)
    if not axes or g == 1:
        if compressed:
            x = compressed_psum(x, (), num_replicas=num_replicas)
        return _identity_handle(x)
    transport = _resolve_transport(transport, x.numel() * x.element_size(),
                                   g, compressed)
    if compressed and transport == "psum":
        return _identity_handle(x if dummy else compressed_psum(
            x, axes, num_replicas=num_replicas, mesh=mesh))
    return _start(x, _ring(axes, g, mesh, x), axes, compressed=compressed,
                  num_buckets=num_buckets, dummy=dummy, transport=transport)


def all_reduce_wait(handle: AsyncHandle) -> torch.Tensor:
    """Complete an in-flight all-reduce and return the elementwise sum
    (the same bits on every rank of the group)."""
    for work in handle.works:
        work.wait()
    if handle.kind == "identity":
        return handle.arrays[0]
    if handle.kind == "scatter":
        return _all_gather_chunks(handle.arrays[0], handle.ring,
                                  handle.shape, handle.dtype)
    if handle.kind == "compressed":
        payload, scales = handle.arrays
        return _compressed_all_gather(payload, scales, handle.ring,
                                      handle.shape, handle.dtype)
    assert handle.kind == "dense", handle.kind
    gathered = _all_gather_ring(torch.stack(handle.arrays), handle.ring)
    n = _numel(handle.shape)
    return gathered.reshape(-1)[:n].reshape(handle.shape).to(handle.dtype)


def ring_all_reduce(x: torch.Tensor, axes: Iterable[str] = (), *,
                    compressed: bool = False,
                    num_replicas: Optional[int] = None,
                    num_buckets: Optional[int] = None,
                    transport: str = "ring", mesh=None) -> torch.Tensor:
    """Blocking convenience wrapper: ``wait(start(x))``; the ring unless
    ``transport`` says otherwise (``"auto"`` asks the autotuner)."""
    return all_reduce_wait(all_reduce_start(
        x, axes, compressed=compressed, num_replicas=num_replicas,
        num_buckets=num_buckets, transport=transport, mesh=mesh))


# ---------------------------------------------------------------------------
# tree-level API (the backward loop reduces one layer's dW tree at a time)
# ---------------------------------------------------------------------------

def _nbytes(x) -> int:
    """Bytes of a tensor or of anything with ``shape`` and ``dtype`` (a
    meta tensor stands for JAX's ShapeDtypeStruct)."""
    return _numel(x.shape) * x.dtype.itemsize


def resolve_leaf_transports(tree, axes: Iterable[str] = (), *,
                            compressed: bool = False,
                            num_replicas: Optional[int] = None,
                            transport: str = "auto", mesh=None) -> list:
    """The per-leaf transport decisions ``tree_all_reduce_start`` would
    make for ``tree`` (``tree_leaves`` order), from the leaves' byte sizes
    alone: ``core.taxonn`` shapes its loop around them (blocking
    transports land the update in the same layer, scatter leaves get the
    sharded update, only ring leaves ride the depth pipeline)."""
    axes = tuple(axes)
    g = group_size(axes, num_replicas, mesh=mesh)
    leaves = tree_leaves(tree)
    if not axes or g == 1:
        return ["psum" for _ in leaves]
    return [_resolve_transport(transport, _nbytes(x), g, compressed)
            for x in leaves]


def _fused_psum(xs: list, ring: _Ring) -> Tuple[list, tuple]:
    """One asynchronous all-reduce of one flat buffer per dtype for all of
    ``xs`` (JAX's variadic ``lax.psum``: one rendezvous, not one a leaf).
    Returns the reduced views (valid once the works complete) and the
    works."""
    out: list = [None] * len(xs)
    works = []
    for dtype in dict.fromkeys(x.dtype for x in xs):
        idx = [i for i, x in enumerate(xs) if x.dtype == dtype]
        flat = torch.cat([xs[i].reshape(-1) for i in idx])
        works.append(dist.all_reduce(flat, group=ring.group, async_op=True))
        for i, part in zip(idx, flat.split([xs[i].numel() for i in idx])):
            out[i] = part.view(xs[i].shape)
    return out, tuple(works)


def tree_all_reduce_start(tree, axes: Iterable[str] = (), *,
                          compressed: bool = False,
                          num_replicas: Optional[int] = None,
                          num_buckets: Optional[int] = None,
                          dummy: bool = False,
                          transport: str = "auto", mesh=None):
    """Start one all-reduce per leaf; returns a tree of AsyncHandles.

    Dense leaves whose transport is ``"psum"`` go in ONE collective (one
    flat buffer a dtype, ``_fused_psum``); ring and scatter leaves, and
    the compressed path (one wire buffer a leaf already), start one by
    one."""
    axes = tuple(axes)
    g = group_size(axes, num_replicas, mesh=mesh)
    leaves = tree_leaves(tree)
    if not axes or g == 1 or compressed:
        return tree_unflatten(tree, [all_reduce_start(
            x, axes, compressed=compressed, num_replicas=num_replicas,
            num_buckets=num_buckets, dummy=dummy, transport=transport,
            mesh=mesh) for x in leaves])
    decisions = [_resolve_transport(transport, _nbytes(x), g, False)
                 for x in leaves]
    handles: list = [None] * len(leaves)
    fuse = [i for i, d in enumerate(decisions) if d == "psum"]
    if fuse:
        xs = [leaves[i] for i in fuse]
        reduced, works = ((xs, ()) if dummy else
                          _fused_psum(xs, _ring(axes, g, mesh, xs[0])))
        for i, r in zip(fuse, reduced):
            handles[i] = _identity_handle(r, works)
    for i, d in enumerate(decisions):
        if d in ("ring", "scatter"):
            handles[i] = all_reduce_start(
                leaves[i], axes, compressed=False, num_replicas=num_replicas,
                num_buckets=num_buckets, dummy=dummy, transport=d, mesh=mesh)
    return tree_unflatten(tree, handles)


def tree_all_reduce_wait(handles):
    """Wait on a tree of AsyncHandles (from ``tree_all_reduce_start``)."""
    return tree_unflatten(handles, [all_reduce_wait(h)
                                    for h in tree_leaves(handles)])
