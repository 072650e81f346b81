"""Pipeline schedules (GPipe, 1F1B, interleaved 1F1B) and stage-sharded
execution (port of ``dist/pipeline.py``).

Two layers live here:

**Execution** -- ``pipeline_apply(stage_params, x, body, mesh, schedule)``
runs M microbatches through S stages as a PyTorch tick loop that autograd
differentiates: the forward diagonal of T = M + S - 1 ticks, where at tick
t stage s runs microbatch t - s.  The pipeline value ``x`` is a tree of
[M, ...] tensors: side values ride with the activation -- per-microbatch
reduce-class accumulators (aux-loss statistics a stage adds to) and the
microbatch index itself, which stages use to slice broadcast-class
operands down to their current microbatch.

The JAX package computes every slot at every tick (a ``vmap`` over the
slots inside a ``lax.scan``) and drops the warm-up and drain garbage with
predicated writes.  Here only the active units (``0 <= t - s < M``) run: a
slot loop, since ``torch.func.vmap`` cannot batch the kernel datapath's
autograd ops.  The outputs and the gradients are the same function.  One
execution order serves every schedule (at each tick the active stages in
ascending order), so on one rank gpipe, 1f1b and interleaved give bitwise
the same results; the schedule picks the stage placement and the cost
model.

**Placement.**  With a "pipe" dimension of P > 1 ranks in ``mesh`` (a
``DeviceMesh``, ``launch.mesh``), the slots are device-major
(``Schedule.stage_of_slot``) and the rank at pipe coordinate d owns slots
d*S/P ... (d+1)*S/P - 1: with P = S / num_virtual, interleaved's
round-robin virtual stages.  Every rank runs the same tick loop and
computes the units of the stages it owns.  A stage output bound for a
stage on another rank crosses in the tick's one P2P exchange
(``batch_isend_irecv``), whose backward sends the cotangent back along the
same hop.  The input enters at stage 0's owner; the outputs collected at
stage S-1's owner are broadcast over the pipe group (the JAX step's
``_unpipe`` replication), and the broadcast's backward hands the owner its
own cotangent: every rank computes the same loss from them, so the
cotangents are not summed.  In the backward, each stage's gradient is
broadcast from its owner and the input's from stage 0's owner, so every
rank holds all of them bitwise, as the JAX package's replicated results.
The exchanges, the broadcast and the entry of the inputs are one chain in
autograd, whose backward every rank runs in the same order (a rank that
sends nothing at a tick still takes part).  An S that P does not divide
raises (the JAX package leaves the buffer unpinned), and a CUDA tensor
over a group that is not NCCL raises (``dist.collectives``).

**Shared operands** (``shared``): broadcast-class operands every stage
reads (the hybrid's weight-tied block, an encoder's output).  The body
gets them after the value; each stage reads its own copy, and the backward
sums the stages' gradients in stage order (each broadcast from its stage's
owner), so one rank and P ranks add them alike.

**Cost model** -- each ``Schedule`` builds a tick table (which (stage,
microbatch, fwd/bwd) unit runs on which device at which tick) under the
TaxoNN TDM frame model: one device-tick can co-issue one forward and one
backward unit, because the paper's time-division-multiplexed datapath
(``kernels.bp_fused_unit``) runs FP + BP + WU of one frame back-to-back on
the same PEs.  GPipe cannot co-issue -- its loss barrier means no backward
work exists until every forward has drained -- so its table is the forward
diagonal followed by the backward diagonal.  1F1B interleaves the two
diagonals in steady state and interleaved-1F1B additionally shrinks the
warm-up by splitting each device into virtual stages.  From the table each
schedule derives ``bubble_fraction(S, M)`` (idle device-ticks / total) and
``peak_activation_microbatches(S, M)`` (max in-flight forward activations
resident on one device) -- the bubble/memory tradeoff GPipe vs 1F1B is
about.  ``(S-1)/(M+S-1)`` is GPipe's closed form (CATERPILLAR, Li &
Pedram 2017); 1F1B's fused frames land strictly below it for S >= 2.  The
tables and their error texts are the JAX package's.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.dist.collectives import _group
from repro_torch.util.tree import tree_leaves, tree_unflatten


def bubble_fraction(num_stages: int, num_microbatches: int) -> float:
    """Idle fraction of the GPipe schedule: (S-1) / (M + S - 1)."""
    s, m = num_stages, num_microbatches
    return (s - 1) / (m + s - 1)


# ---------------------------------------------------------------------------
# Tick tables (the cost model)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SchedulePlan:
    """One schedule instantiated at (S stages, M microbatches).

    ``fwd_tick[s, m]`` / ``bwd_tick[s, m]`` give the tick at which the
    forward / backward unit of microbatch m runs on stage s.  Everything
    else (bubble, peak memory) is derived from these two arrays.
    """
    num_stages: int
    num_microbatches: int
    num_devices: int
    num_virtual: int
    num_ticks: int
    fwd_tick: np.ndarray          # [S, M] int
    bwd_tick: np.ndarray          # [S, M] int
    busy_slots: int               # device-ticks with >= 1 unit issued
    bubble: float                 # 1 - busy / (num_ticks * num_devices)
    peak_activation_microbatches: int

    def stage_device(self, s: int) -> int:
        return s % self.num_devices


def _finish_plan(S: int, M: int, D: int, v: int, fwd: np.ndarray,
                 bwd: np.ndarray) -> SchedulePlan:
    """Derive span/bubble/peak-memory from the (fwd, bwd) tick arrays."""
    ticks = int(max(fwd.max(), bwd.max())) + 1
    # busy device-ticks: a fused (F, B) pair on one device is ONE busy slot
    busy = set()
    for s in range(S):
        for m in range(M):
            busy.add((s % D, int(fwd[s, m])))
            busy.add((s % D, int(bwd[s, m])))
    # peak in-flight activations per device: an activation is live from the
    # tick its forward issues until the tick its backward (the consumer)
    # issues
    peak = 0
    for d in range(D):
        stages = range(d, S, D)
        events = []                 # (+1 at fwd tick, -1 at bwd tick)
        for s in stages:
            for m in range(M):
                events.append((int(fwd[s, m]), 1))
                events.append((int(bwd[s, m]), -1))
        live = 0
        for _, delta in sorted(events):   # -1 sorts before +1 at equal ticks
            live += delta
            peak = max(peak, live)
    return SchedulePlan(
        num_stages=S, num_microbatches=M, num_devices=D, num_virtual=v,
        num_ticks=ticks, fwd_tick=fwd, bwd_tick=bwd, busy_slots=len(busy),
        bubble=1.0 - len(busy) / (ticks * D),
        peak_activation_microbatches=peak)


def _gpipe_plan(S: int, M: int) -> SchedulePlan:
    """All forwards, loss barrier, all backwards (two diagonals)."""
    fwd = np.zeros((S, M), np.int64)
    bwd = np.zeros((S, M), np.int64)
    t_flush = M + S - 1
    for s in range(S):
        for m in range(M):
            fwd[s, m] = m + s
            bwd[s, m] = t_flush + (S - 1 - s) + m
    return _finish_plan(S, M, S, 1, fwd, bwd)


def _one_f_one_b_plan(S: int, M: int) -> SchedulePlan:
    """Closed-form 1F1B on TDM fused frames: two interleaved diagonals.

    F(s, m) at tick s + m and B(s, m) at tick (2S-1-s) + m satisfy every
    dependency (F feeds forward one tick apart, B feeds backward one tick
    apart, and F(s, m) < B(s, m) since 2s < 2S-1), and in steady state a
    device co-issues one F and one B per tick -- the paper's TDM frame.
    Span = M + 2S - 2 ticks after tick 0, so bubble = (S-1)/(M+2S-1) --
    strictly below GPipe's (S-1)/(M+S-1) for every S >= 2 -- and in-flight
    activations at stage s cap at min(M, 2(S-s)-1) instead of GPipe's M.
    """
    s_idx = np.arange(S)[:, None]
    m_idx = np.arange(M)[None, :]
    fwd = np.broadcast_to(s_idx + m_idx, (S, M)).astype(np.int64)
    bwd = np.broadcast_to((2 * S - 1 - s_idx) + m_idx, (S, M)).astype(np.int64)
    return _finish_plan(S, M, S, 1, fwd, bwd)


def _interleaved_plan(S: int, M: int, v: int) -> SchedulePlan:
    """Greedy work-conserving simulation of interleaved-1F1B under the
    TDM fused-frame model: per tick a device issues at most one backward
    (lowest microbatch, deepest stage first) and one forward (subject to
    the per-stage in-flight cap that gives 1F1B its memory bound)."""
    D = S // v
    NOT_DONE = -1
    fwd = np.full((S, M), NOT_DONE, np.int64)
    bwd = np.full((S, M), NOT_DONE, np.int64)
    next_fwd = [0] * S                  # microbatches enter a stage in order
    next_bwd = [0] * S

    def fwd_ready(s: int, t: int) -> Optional[int]:
        m = next_fwd[s]
        if m >= M:
            return None
        if s > 0 and not (0 <= fwd[s - 1, m] < t):
            return None
        return m

    def bwd_ready(s: int, t: int) -> Optional[int]:
        m = next_bwd[s]
        if m >= M or not (0 <= fwd[s, m] < t):
            return None
        if s < S - 1 and not (0 <= bwd[s + 1, m] < t):
            return None
        return m

    def inflight(s: int) -> int:
        return next_fwd[s] - next_bwd[s]

    remaining = 2 * S * M
    t = 0
    while remaining:
        issued_any = False
        for relax_caps in (False, True):
            for d in range(D):
                stages = list(range(d, S, D))
                # one backward: lowest microbatch, deepest stage breaks ties
                cand = [(m, -s, s) for s in stages
                        for m in (bwd_ready(s, t),) if m is not None]
                b_issue = min(cand) if cand else None
                if b_issue is not None:
                    s = b_issue[2]
                    bwd[s, next_bwd[s]] = t
                    next_bwd[s] += 1
                    remaining -= 1
                    issued_any = True
                # one forward: earliest microbatch first, capped in-flight
                cand = [(m, s) for s in stages
                        for m in (fwd_ready(s, t),) if m is not None
                        and (relax_caps or inflight(s) < 2 * (S - s) - 1)]
                if cand:
                    s = min(cand)[1]
                    fwd[s, next_fwd[s]] = t
                    next_fwd[s] += 1
                    remaining -= 1
                    issued_any = True
            if issued_any:
                break
        assert issued_any, "1F1B simulation stalled (dependency bug)"
        t += 1
    return _finish_plan(S, M, D, v, fwd, bwd)


@functools.lru_cache(maxsize=None)
def _plan_cached(kind: str, S: int, M: int, v: int) -> SchedulePlan:
    if kind == "gpipe":
        return _gpipe_plan(S, M)
    if v == 1:
        return _one_f_one_b_plan(S, M)
    return _interleaved_plan(S, M, v)


# ---------------------------------------------------------------------------
# Schedule abstraction
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Schedule:
    """A pipeline schedule: stage placement + tick-table cost model."""
    name: str = "gpipe"
    num_virtual: int = 1          # virtual stages per device (interleaved)

    _kind = "gpipe"

    # -- validation / placement -------------------------------------------
    def validate(self, num_stages: int, num_microbatches: int = 1) -> None:
        if num_stages < 1 or num_microbatches < 1:
            raise ValueError(
                f"{self.name}: need num_stages >= 1 and num_microbatches >= "
                f"1, got S={num_stages}, M={num_microbatches}")
        if self.num_virtual < 1:
            raise ValueError(f"{self.name}: num_virtual must be >= 1, got "
                             f"{self.num_virtual}")
        if num_stages % self.num_virtual != 0:
            raise ValueError(
                f"{self.name}: num_stages={num_stages} does not divide into "
                f"num_virtual={self.num_virtual} virtual stages per device; "
                f"use a stage count divisible by the virtual-stage count")

    def num_devices(self, num_stages: int) -> int:
        return num_stages // self.num_virtual

    def stage_of_slot(self, num_stages: int) -> np.ndarray:
        """Storage order of the slots: slot j holds which stage.

        Device-major: with D devices and v virtual stages, slot (d*v + k)
        holds stage (k*D + d), so splitting the slots over the "pipe" mesh
        dimension gives each device its round-robin virtual stages.
        """
        self.validate(num_stages)
        D = self.num_devices(num_stages)
        return np.add.outer(np.arange(D),
                            np.arange(self.num_virtual) * D).reshape(-1)

    # -- cost model --------------------------------------------------------
    def plan(self, num_stages: int, num_microbatches: int) -> SchedulePlan:
        self.validate(num_stages, num_microbatches)
        return _plan_cached(self._kind, num_stages, num_microbatches,
                            self.num_virtual)

    def bubble_fraction(self, num_stages: int, num_microbatches: int) -> float:
        """Idle fraction of device-ticks in this schedule's tick table."""
        return self.plan(num_stages, num_microbatches).bubble

    def peak_activation_microbatches(self, num_stages: int,
                                     num_microbatches: int) -> int:
        """Max forward activations simultaneously resident on one device."""
        return self.plan(num_stages,
                         num_microbatches).peak_activation_microbatches

    def peak_activation_bytes(self, num_stages: int, num_microbatches: int,
                              microbatch_bytes: int) -> int:
        """Peak per-device activation memory, given one stage's activation
        footprint for one microbatch."""
        return (self.peak_activation_microbatches(num_stages,
                                                  num_microbatches)
                * int(microbatch_bytes))

    def summary(self, num_stages: int, num_microbatches: int) -> Dict:
        p = self.plan(num_stages, num_microbatches)
        return {
            "schedule": self.name,
            "num_stages": p.num_stages,
            "num_microbatches": p.num_microbatches,
            "num_devices": p.num_devices,
            "num_virtual": p.num_virtual,
            "ticks": p.num_ticks,
            "bubble_fraction": p.bubble,
            "peak_activation_microbatches": p.peak_activation_microbatches,
        }


@dataclasses.dataclass(frozen=True)
class GPipeSchedule(Schedule):
    """All-forward / flush / all-backward; peak memory grows with M."""
    name: str = "gpipe"
    _kind = "gpipe"

    def validate(self, num_stages: int, num_microbatches: int = 1) -> None:
        if self.num_virtual != 1:
            raise ValueError("gpipe has no virtual stages; use the "
                             "interleaved schedule for num_virtual > 1")
        super().validate(num_stages, num_microbatches)

    def bubble_fraction(self, num_stages: int, num_microbatches: int) -> float:
        self.validate(num_stages, num_microbatches)
        return bubble_fraction(num_stages, num_microbatches)  # closed form


@dataclasses.dataclass(frozen=True)
class OneFOneBSchedule(Schedule):
    """PipeDream-flush 1F1B on TaxoNN TDM frames: steady-state ticks fuse
    one forward with one backward, bounding in-flight activations by ~S
    instead of M and shrinking the bubble below GPipe's."""
    name: str = "1f1b"
    _kind = "1f1b"

    def validate(self, num_stages: int, num_microbatches: int = 1) -> None:
        if self.num_virtual != 1:
            raise ValueError("1f1b runs one stage per device; use the "
                             "interleaved schedule for num_virtual > 1")
        super().validate(num_stages, num_microbatches)


@dataclasses.dataclass(frozen=True)
class Interleaved1F1BSchedule(Schedule):
    """1F1B with ``num_virtual`` round-robin virtual stages per device
    (Megatron-style): the warm-up diagonal spans D = S / v devices instead
    of S, trading bubble for more hops per tick."""
    name: str = "interleaved"
    num_virtual: int = 2
    _kind = "1f1b"


SCHEDULES: Dict[str, Callable[..., Schedule]] = {
    "gpipe": GPipeSchedule,
    "1f1b": OneFOneBSchedule,
    "interleaved": Interleaved1F1BSchedule,
}


def get_schedule(spec: Union[str, Schedule, None] = "gpipe",
                 num_virtual: Optional[int] = None) -> Schedule:
    """Resolve a schedule name ("gpipe" | "1f1b" | "interleaved") or pass
    a ``Schedule`` instance through.  ``num_virtual`` overrides the
    virtual-stage count for the interleaved schedule."""
    if spec is None:
        spec = "gpipe"
    if isinstance(spec, Schedule):
        if num_virtual is not None and num_virtual != spec.num_virtual:
            return dataclasses.replace(spec, num_virtual=num_virtual)
        return spec
    if spec not in SCHEDULES:
        raise ValueError(f"unknown pipeline schedule {spec!r}; expected one "
                         f"of {tuple(SCHEDULES)}")
    kwargs = {}
    if num_virtual is not None:
        if spec != "interleaved" and num_virtual != 1:
            raise ValueError(f"schedule {spec!r} does not take virtual "
                             f"stages (num_virtual={num_virtual})")
        if spec == "interleaved":
            kwargs["num_virtual"] = num_virtual
    return SCHEDULES[spec](**kwargs)


# ---------------------------------------------------------------------------
# Execution
# ---------------------------------------------------------------------------

def _slot_maps(sched: Schedule, S: int) -> Tuple[np.ndarray, np.ndarray,
                                                 np.ndarray, bool]:
    stage_of_slot = sched.stage_of_slot(S)
    slot_of_stage = np.argsort(stage_of_slot)
    route = slot_of_stage[(stage_of_slot - 1) % S]   # dst slot <- src slot
    identity = bool((stage_of_slot == np.arange(S)).all())
    return stage_of_slot, slot_of_stage, route, identity


class _Wire:
    """One rank's end of the pipe group: its coordinate, its peers' global
    ranks, and the device a tensor crosses the group on (NCCL: this
    rank's CUDA device; gloo: the CPU).  A tensor that lives elsewhere
    crosses as a copy and lands back on its own device."""

    def __init__(self, group, size: int):
        self.group, self.size = group, size
        self.me = dist.get_group_rank(group, dist.get_rank())
        self.dev = (torch.device("cuda", torch.cuda.current_device())
                    if dist.get_backend(group) == "nccl"
                    else torch.device("cpu"))

    def peer(self, k: int) -> int:
        return dist.get_global_rank(self.group, k)

    def exchange(self, sends: list, recvs: list) -> list:
        """One ``batch_isend_irecv``: ``sends`` [(coordinate, tag,
        tensor)], ``recvs`` [(coordinate, tag, (shape, dtype, device))].
        Returns the received tensors."""
        ops, bufs = [], []
        for k, tag, t in sends:
            ops.append(dist.P2POp(dist.isend, t.detach().to(self.dev)
                                  .contiguous(), self.peer(k), self.group,
                                  tag))
        for k, tag, (shape, dtype, _) in recvs:
            bufs.append(torch.empty(shape, dtype=dtype, device=self.dev))
            ops.append(dist.P2POp(dist.irecv, bufs[-1], self.peer(k),
                                  self.group, tag))
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        return [b.to(like[2]) for b, (_, _, like) in zip(bufs, recvs)]

    def broadcast(self, t: torch.Tensor, src: int) -> torch.Tensor:
        """``t`` as pipe coordinate ``src`` holds it (a new tensor)."""
        buf = t.detach().to(self.dev, copy=True).contiguous()
        dist.broadcast(buf, src=self.peer(src), group=self.group)
        return buf.to(t.device)


def _meta(t: torch.Tensor) -> tuple:
    return tuple(t.shape), t.dtype, t.device


def _mark_integers(ctx, outs) -> None:
    ints = [o for o in outs if not o.is_floating_point()]
    if ints:
        ctx.mark_non_differentiable(*ints)




class _Enter(torch.autograd.Function):
    """The entry of the inputs, the root of the pipeline's chain: identity
    on the value's leaves and the stage parameters' ([S, ...]), and a copy
    (a view) of each shared operand leaf for each stage.  Its backward
    gives every rank the whole of each gradient: the value's from stage
    0's owner, each stage's slice of the parameters' from that stage's
    owner, and each shared leaf's as the f32 sum in stage order of the
    stages' own, each from its owner.  With no wire (one rank) it only
    sums the shared leaves' stages."""

    @staticmethod
    def forward(ctx, wire, owner, counts, meta, token, *leaves):
        ctx.wire, ctx.owner, ctx.counts, ctx.meta = wire, owner, counts, meta
        n_x, n_p, _ = counts
        outs = [a.view_as(a) for a in leaves[:n_x + n_p]]
        outs += [a.view_as(a) for a in leaves[n_x + n_p:]
                 for _ in range(len(owner))]
        _mark_integers(ctx, outs)
        return (token.clone(), *outs)

    @staticmethod
    def backward(ctx, g_token, *grads):
        wire, owner, (n_x, n_p, n_sh) = ctx.wire, ctx.owner, ctx.counts
        S = len(owner)
        out = []
        for i, g in enumerate(grads[:n_x + n_p]):
            shape, dtype, dev = ctx.meta[i]
            if not dtype.is_floating_point:
                out.append(None)
                continue
            if g is None:
                g = torch.zeros(shape, dtype=dtype, device=dev)
            if wire is not None and i < n_x:
                g = wire.broadcast(g, owner[0])
            elif wire is not None:
                g = torch.stack([wire.broadcast(g[s], owner[s])
                                 for s in range(S)])
            out.append(g)
        for j in range(n_sh):
            shape, dtype, dev = ctx.meta[n_x + n_p + j]
            if not dtype.is_floating_point:
                out.append(None)
                continue
            acc = torch.zeros(shape, dtype=torch.float32, device=dev)
            for s in range(S):
                g = grads[n_x + n_p + j * S + s]
                if g is None:
                    g = torch.zeros(shape, dtype=dtype, device=dev)
                if wire is not None:
                    g = wire.broadcast(g, owner[s])
                acc = acc + g.to(torch.float32)
            out.append(acc.to(dtype))
        return (None, None, None, None, None, *out)


class _Hop(torch.autograd.Function):
    """One tick's P2P exchange of stage outputs (``sends`` [(coordinate,
    tag)] of the tensors, ``recvs`` [(coordinate, tag, meta)]), a link of
    the chain.  Its backward sends each received tensor's cotangent back
    to its sender and receives the cotangents of what this rank sent; a
    floating tensor always carries one (zeros where autograd has none), so
    both ends agree on the messages."""

    @staticmethod
    def forward(ctx, wire, sends, recvs, token, *tensors):
        ctx.wire, ctx.sends, ctx.recvs = wire, sends, recvs
        ctx.meta = [_meta(t) for t in tensors]
        outs = wire.exchange([(k, tag, t) for (k, tag), t
                              in zip(sends, tensors)], recvs)
        _mark_integers(ctx, outs)
        return (token.clone(), *outs)

    @staticmethod
    def backward(ctx, g_token, *grads):
        back = [(k, tag, g if g is not None
                 else torch.zeros(meta[0], dtype=meta[1], device=meta[2]))
                for (k, tag, meta), g in zip(ctx.recvs, grads)
                if meta[1].is_floating_point]
        want = [(k, tag, meta) for (k, tag), meta in zip(ctx.sends, ctx.meta)
                if meta[1].is_floating_point]
        got = iter(ctx.wire.exchange(back, want))
        out = [next(got) if meta[1].is_floating_point else None
               for meta in ctx.meta]
        return (None, None, None, torch.zeros_like(g_token), *out)


class _Exit(torch.autograd.Function):
    """The end of the chain: each output leaf broadcast from stage S-1's
    owner ``src``.  The backward hands the owner its own cotangent and
    sends nothing (every rank computes the same loss)."""

    @staticmethod
    def forward(ctx, wire, src, token, *leaves):
        ctx.mine, ctx.token = wire.me == src, _meta(token)
        outs = [wire.broadcast(a, src) for a in leaves]
        _mark_integers(ctx, outs)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        mine = [g if ctx.mine else None for g in grads]
        _, dtype, dev = ctx.token
        return (None, None, torch.zeros((), dtype=dtype, device=dev), *mine)


def _wire(mesh, ref: torch.Tensor) -> Optional[_Wire]:
    """The pipe group's wire, or None without a "pipe" dimension of more
    than one rank in ``mesh``."""
    if mesh is None or "pipe" not in tuple(mesh.mesh_dim_names or ()):
        return None
    size = dict(zip(mesh.mesh_dim_names, mesh.shape))["pipe"]
    if size == 1:
        return None
    return _Wire(_group(("pipe",), mesh, ref), size)


def pipeline_apply(stage_params, x, body: Callable, mesh=None,
                   schedule: Union[str, Schedule, None] = "gpipe",
                   shared: tuple = ()):
    """Apply an S-stage pipeline to M microbatches under a schedule.

    stage_params : tree whose leaves carry a leading stage axis [S, ...]
    x            : tree whose leaves carry a leading microbatch axis
                   [M, microbatch...].  A bare tensor is the common case; a
                   tree lets side values ride with the activation -- e.g. a
                   per-microbatch aux-loss accumulator each stage adds to
                   (reduce-class operand, summed by the caller after the
                   drain) or the microbatch index itself, which stages use
                   to slice broadcast-class operands (an encoder output
                   fan-out) down to their current microbatch
    body         : body(stage_params_s, v, *shared_s) -> v', one stage on
                   one microbatch value; must preserve the value's
                   structure, leaf shapes and dtypes
    mesh         : optional ``DeviceMesh`` whose "pipe" dimension places
                   the stages on ranks (see the module docstring)
    schedule     : "gpipe" | "1f1b" | "interleaved" or a Schedule; selects
                   the stage placement (interleaved's device-major slots
                   give each rank its round-robin virtual stages) and the
                   cost model reported by ``Schedule.summary``.  Every
                   schedule computes the same function in the same order:
                   on one rank the results and gradients are bitwise equal
                   across schedules.
    shared       : a tuple of trees every stage reads (broadcast-class
                   operands), handed to ``body`` after the value; their
                   gradient is summed over the stages in stage order

    Returns a tree shaped like ``x`` ([M, microbatch...] leaves), equal on
    every rank of the pipe group.  Across ranks, differentiate with
    respect to the stage parameters, so that every rank runs the chain's
    backward.
    """
    sched = get_schedule(schedule)
    p_leaves, x_leaves = tree_leaves(stage_params), tree_leaves(x)
    S, M = int(p_leaves[0].shape[0]), int(x_leaves[0].shape[0])
    sched.validate(S, M)
    _, slot_of_stage, _, _ = _slot_maps(sched, S)
    ref = next(a for a in x_leaves if a.is_floating_point())
    wire = _wire(mesh, ref)
    P, me = (wire.size, wire.me) if wire is not None else (1, 0)
    if S % P:
        raise ValueError(f"{sched.name}: num_stages={S} does not divide "
                         f"over the pipe axis of {P} ranks")
    owner = [int(slot_of_stage[s]) // (S // P) for s in range(S)]
    sh_leaves = tree_leaves(shared)
    leaves = x_leaves + p_leaves + sh_leaves
    token = torch.zeros((), device=ref.device, requires_grad=True)
    token, *entered = _Enter.apply(
        wire, owner, (len(x_leaves), len(p_leaves), len(sh_leaves)),
        [_meta(a) for a in leaves], token, *leaves)
    n_x, n_p = len(x_leaves), len(p_leaves)
    xs = [tree_unflatten(x, list(c))
          for c in zip(*(torch.unbind(a) for a in entered[:n_x]))]
    ps = [tree_unflatten(stage_params, list(c))
          for c in zip(*(torch.unbind(a) for a in entered[n_x:n_x + n_p]))]
    copies = entered[n_x + n_p:]
    shs = [tree_unflatten(shared, copies[s::S]) for s in range(S)]
    like = [_meta(a) for a in tree_leaves(xs[0])]
    nl = len(like)

    inbox, outs = {}, [None] * M
    T = M + S - 1
    for t in range(T):
        done = {}
        for s in range(S):
            m = t - s
            if 0 <= m < M and owner[s] == me:
                y = body(ps[s], xs[m] if s == 0 else inbox.pop(s), *shs[s])
                if s == S - 1:
                    outs[m] = y
                else:
                    done[s] = y
        if t == T - 1:
            break
        sends = []
        for s, y in done.items():
            if owner[s + 1] == me:
                inbox[s + 1] = y
            else:
                sends += [((owner[s + 1], s * nl + i), a)
                          for i, a in enumerate(tree_leaves(y))]
        if wire is None:
            continue
        into = [s + 1 for s in range(S - 1) if 0 <= t - s < M
                and owner[s] != me and owner[s + 1] == me]
        recvs = [(owner[s - 1], (s - 1) * nl + i, like[i])
                 for s in into for i in range(nl)]
        token, *got = _Hop.apply(wire, [k for k, _ in sends], recvs, token,
                                 *(a for _, a in sends))
        for k, s in enumerate(into):
            inbox[s] = tree_unflatten(xs[0], got[k * nl:(k + 1) * nl])

    if me == owner[S - 1]:
        local = [torch.stack(c) for c in zip(*(tree_leaves(o)
                                               for o in outs))]
    else:
        local = [torch.empty(a.shape, dtype=a.dtype, device=a.device)
                 for a in x_leaves]
    if wire is not None:
        local = list(_Exit.apply(wire, owner[S - 1], token, *local))
    return tree_unflatten(x, local)
