"""The TaxoNN engine: SGD unrolled into an explicit per-layer G-chain (port
of ``core/taxonn.py``, blocking path).

The paper's Eq. (2)-(9): back-propagation is not autograd over the whole
model but an explicit reverse loop over layers whose carry is the paper's
G vector:

    G_i = (G_{i+1} @ W_{i+1}) * f'_i          (Eq. 8)
    dE/dW_i = G_i  (x)  X_i                   (Eq. 9)
    W_i <- W_i - alpha * dE/dW_i              (Eq. 1, fused: step 4)

at layer granularity: each iteration takes a local VJP of one layer's body
at its cached (quantized) input X_i, quantizes the outgoing G and applies
that layer's update at once, so the whole-model gradient never exists
(gradient lifetime = one layer, the paper's pipeline in Fig. 3).

Memory discipline: the forward runs without autograd and keeps only each
layer's quantized input X_i; everything else (pre-activations, f') is
recomputed in the backward from X_i -- the paper's activation derivation
unit executed on the fly.

Stochastic rounding (``QuantPolicy.stochastic`` with a ``base_key``):
layer i's key is ``fold_in(base_key, i)``; G is rounded with noise drawn
per batch row from ``fold_in(layer key, b)``, and strict mode's update
``q(lr * dW)`` with noise drawn from the layer key itself, the same key for
every leaf of the layer, as the JAX package's ``tree_map`` does.  The keys
are JAX's and so are the draws (``util.prng``).

The JAX package runs both passes as ``lax.scan`` over stacked [L, ...]
leaves; here they are Python loops over layer views of the same stacked
leaves, and the X_i caches are a list.  ``shared`` is the JAX package's
operand that every unit reads besides its own slice: a tuple of trees
handed to the body after its bits and differentiated in every unit's VJP
at its step-start value; the backward sums its gradient over the units.
With ``quantize_shared`` (the hybrid's weight-tied attention block) each
unit quantizes it with its own weight format; without (the
encoder-decoder's encoder output, an activation that the caller quantizes
once) it enters every unit as it is.  ``QuantPolicy.bit_anneal`` carries a
step-indexed F-bit ramp (``search.anneal``) that
``core.steps.make_train_step`` applies to the step's bits.

Cross-replica dW (``QuantPolicy.compress_dw``, ``dw_psum_axes``,
``dw_num_replicas``): each leaf's dW is reduced over the mesh axes
``dw_psum_axes`` of the ambient mesh (``dist.mesh_ctx``) where the JAX
package reduces it, after the un-scaling and before ``quantize_update``:
through the int8 wire format (``dist.collectives.compressed_psum``) with
``compress_dw``, else a dense all-reduce.  With ``compress_dw`` and no
axes it is the codec round trip.  Only the stacks' dW is reduced, as in
the JAX step: the boundary and shared updates use each replica's own
gradient.

The communication-overlapped reduce (``overlap="on"``, over a group of
more than one rank) follows the static per-leaf transport decisions
(``dw_transport``, ``dist.async_collectives``): where any leaf rides the
ring, each layer's whole dW tree starts its all-reduce and its update
lands ``overlap_depth`` layers later (a queue of pending layers, each
with its step-start parameter and state views, its bits and its key);
where every leaf rides a blocking transport the update lands in the same
layer, the psum leaves in one collective and the scatter leaves, for
``sgd`` without a clip, with the sharded (ZeRO-style) update.  Those
paths hold a layer's (or ``overlap_depth`` layers') whole dW in f32.
With ``overlap="off"``, no axes or a group of one the update stays leaf
by leaf, and ``overlap="on"`` is then bitwise ``"off"``.  The stacked
update tail of the pipeline (``apply_stacked_updates``) takes the same
schedules.

Under a model axis (``dist.mesh_ctx`` with "model" of m > 1 ranks) the
stack's leaves are this rank's shards (``dist.sharding``) and the layers
run tensor-parallel (``models.layers``); ``backward_stack``'s ``specs``
name each stacked leaf's spec, so that the update of a shard is the
logical leaf's slice: the optimizer's reductions span the model group
(``optim.apply_update``), the strict mode's stochastic rounding draws
each element's noise from its index in the logical leaf
(``quantize_update``'s ``block``), and the returned squared norm counts
each shard's squares once over the group.

The stage-sharded pipeline (``core.steps``, ``dist.pipeline``) runs the
stack under plain autograd instead of the reverse loop: ``grad_tap`` and
``grad_tap_stochastic`` at each layer input quantize the cotangent as the
loop quantizes G, and ``apply_stacked_updates`` applies the whole stacked
dW it hands back.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.dist.async_collectives import (all_gather_chunks,
                                                group_size,
                                                reduce_scatter_chunk,
                                                resolve_leaf_transports,
                                                shard_chunk,
                                                tree_all_reduce_start,
                                                tree_all_reduce_wait)
from repro_torch.dist.api import model_axis_index_ctx, model_axis_size_ctx
from repro_torch.dist.collectives import compressed_psum, dense_psum
from repro_torch.dist.sharding import MODEL, P, model_dim
from repro_torch.optim import Hyper, OptimizerConfig, apply_update
from repro_torch.quant.fixed_point import (BitSchedule, make_bit_schedule,
                                           maybe_quantize, quantize_ste,
                                           quantize_stochastic,
                                           stochastic_round_batched)
from repro_torch.util import prng
from repro_torch.util.tree import tree_leaves, tree_map, tree_unflatten


@dataclasses.dataclass(frozen=True)
class QuantPolicy:
    """Which tensor classes get the per-layer (I,F) treatment (static)."""

    quantize_weights: bool = True
    quantize_acts: bool = True
    quantize_grads: bool = True
    quantize_updates: bool = False   # strict paper mode: q(alpha*dW)
    grad_scale: float = 1.0          # loss scaling for the low-bit G chain
    # stochastic rounding of G (and of the update in strict mode), keyed
    # per (layer, batch row) from the step's ``rng``
    stochastic: bool = False
    # the dense-unit datapath: "off" (plain PyTorch), "emulate" (the
    # kernels, f32), "int8" (int8 operands, int32 sums), "auto" (off on
    # the CPU, int8 on CUDA)
    kernel_backend: str = "auto"
    # Progressive bitwidth-annealing spec ("0:16,200:12,..." — see
    # search.anneal.AnnealSchedule).  Consumed by make_train_step: the
    # effective per-layer F bits become a step-indexed ramp applied on top
    # of the run's BitSchedule.  None = no anneal.
    bit_anneal: Optional[str] = None
    # Route each layer's dW through the int8 block-scaled wire format in the
    # backward loop (dist.collectives.compressed_psum).  With
    # ``dw_psum_axes`` naming axes of the ambient mesh (dist.mesh_ctx) the
    # all-reduce moves compressed bytes; with no axes it is the codec round
    # trip, ``dw_num_replicas`` its simulated replica count.  With axes
    # named and ``compress_dw=False`` the reduction is a dense all-reduce.
    compress_dw: bool = False
    dw_psum_axes: tuple = ()
    dw_num_replicas: Optional[int] = None
    # The communication-overlapped backward loop ("off" | "on"): layer i
    # STARTS its dW all-reduce (dense or compressed, dist.async_collectives)
    # and its update lands ``overlap_depth`` layers later (clamped to the
    # layer count), so the collective overlaps those layers' VJP and
    # G-step.  With no ``dw_psum_axes`` or a group of one it is a pure
    # schedule change (bitwise "off").
    overlap: str = "off"
    overlap_depth: int = 2
    # Transport of the overlapped dW reduce: "auto" (the per-bucket
    # decision, dist.async_collectives.decide_transport; REPRO_TRANSPORT
    # overrides), "ring", "psum" (one blocking collective a layer) or
    # "scatter" (reduce-scatter, the sharded sgd update, all-gather)
    dw_transport: str = "auto"

    @staticmethod
    def off() -> "QuantPolicy":
        return QuantPolicy(quantize_weights=False, quantize_acts=False,
                           quantize_grads=False)


def default_bits_for(num_units: int, enabled: bool = True) -> BitSchedule:
    """Paper-style default: (2,12) weights/grads, (4,10) acts, ramped tail."""
    return make_bit_schedule(num_units, weight=(2, 12), act=(4, 10),
                             grad=(2, 12), enabled=enabled)


# ---------------------------------------------------------------------------
# Quantization helpers (leaf policies)
# ---------------------------------------------------------------------------

def _is_matmul_leaf(w: torch.Tensor) -> bool:
    """Quantize matmul weights; keep vector params (norm scales) at full
    precision -- the paper's wide accumulator registers.  Applied to one
    layer's slice, so ``bq`` [H, hd] counts as a matrix."""
    return w.dim() >= 2


def quantize_weight_tree(tree, w_i, w_f, enabled, on: bool):
    if not on:
        return tree
    return tree_map(
        lambda w: maybe_quantize(w, w_i, w_f, enabled)
        if _is_matmul_leaf(w) else w, tree)


def _blend_quant(x: torch.Tensor, i_bits, f_bits, enabled) -> torch.Tensor:
    """enabled * q(x) + (1 - enabled) * x in f32, cast back to x's dtype:
    a blend, not a branch, so one step serves every schedule."""
    xf = x.to(torch.float32)
    q = quantize_ste(xf, i_bits, f_bits)
    return (enabled * q + (1.0 - enabled) * xf).to(x.dtype)


def _quant_grad(g: torch.Tensor, g_i, g_f, enabled, policy: QuantPolicy,
                key=None) -> torch.Tensor:
    """The G-chain's per-layer ``G <- q(G)`` (Eq. 8's low-bit signal), in
    f32; with ``policy.stochastic`` and a layer ``key``, stochastically
    rounded with noise keyed per (layer key, batch row)."""
    if not policy.quantize_grads:
        return g
    gf = g.to(torch.float32)
    if policy.stochastic and key is not None:
        q = stochastic_round_batched(gf, g_i, g_f, key, 0)
    else:
        q = quantize_ste(gf, g_i, g_f)
    return (enabled * q + (1.0 - enabled) * gf).to(g.dtype)


class _GradTap(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g_i, g_f, enabled, key, offset):
        ctx.bits, ctx.key, ctx.offset = (g_i, g_f, enabled), key, offset
        return x.view_as(x)

    @staticmethod
    def backward(ctx, ct):
        g_i, g_f, enabled = ctx.bits
        ctf = ct.to(torch.float32)
        q = (quantize_ste(ctf, g_i, g_f) if ctx.key is None else
             stochastic_round_batched(ctf, g_i, g_f, ctx.key, ctx.offset))
        return ((enabled * q + (1.0 - enabled) * ctf).to(ct.dtype), None,
                None, None, None, None)


def grad_tap(x: torch.Tensor, g_i, g_f, enabled) -> torch.Tensor:
    """Identity forward whose COTANGENT is quantized to the (g_i, g_f)
    grid in f32 with the ``enabled`` blend and cast back: the G-chain's
    per-layer ``G <- q(G)`` (Eq. 8's low-bit signal) as a forward-graph
    annotation.  At each layer input it makes plain autograd through the
    stack compute the quantized G-chain of the engine's reverse loop,
    which is how the stage-sharded pipeline (``dist.pipeline``) keeps the
    engine's numerics without a hand-written backward."""
    return _GradTap.apply(x, g_i, g_f, enabled, None, 0)


def grad_tap_stochastic(x: torch.Tensor, g_i, g_f, enabled, key,
                        offset: int) -> torch.Tensor:
    """``grad_tap`` with stochastic rounding: the cotangent's row ``b``
    draws from ``fold_in(key, offset + b)`` (``stochastic_round_batched``).
    ``key`` is the layer key (``fold_in(rng, layer)``, a port key) and
    ``offset`` the microbatch's first global batch row, so the pipeline's
    per-microbatch draws are the engine's full-batch ones."""
    return _GradTap.apply(x, g_i, g_f, enabled, prng.as_key(key),
                          int(offset))


def shard_block(spec, shape) -> Optional[tuple]:
    """(logical shape, start) of a leaf of local ``shape`` that ``spec``
    shards over the ambient mesh's "model" axis, else None."""
    d = model_dim(spec)
    if d is None:
        return None
    logical, start = list(shape), [0] * len(shape)
    logical[d] = shape[d] * model_axis_size_ctx()
    start[d] = shape[d] * model_axis_index_ctx()
    return tuple(logical), tuple(start)


def quantize_update(g: torch.Tensor, b_l: dict, key, enabled,
                    policy: QuantPolicy, hyper: Hyper,
                    block: Optional[tuple] = None) -> torch.Tensor:
    """Strict-paper mode: ``q(alpha * dW)`` in the layer's gradient (I,F)
    format, returned in the dW domain (divided back by lr) so the
    optimizer applies it unchanged.  With ``policy.stochastic`` and the
    layer ``key``, the rounding is stochastic with noise drawn from that
    key (every leaf of a layer draws from the same key); where ``g`` is a
    shard, ``block`` (``shard_block``) places it in the logical leaf, whose
    draws it takes its slice of."""
    if not policy.quantize_updates:
        return g
    upd = hyper.lr * g
    if policy.stochastic and key is not None:
        noise = key
        if block is not None:
            noise = prng.uniform_block(key, block[0], block[1], g.shape,
                                       device=g.device)
        updq = quantize_stochastic(upd, b_l["g_i"], b_l["g_f"], noise)
    else:
        updq = quantize_ste(upd, b_l["g_i"], b_l["g_f"])
    upd = enabled * updq + (1.0 - enabled) * upd
    lr = hyper.lr
    lr = torch.clamp_min(lr, 1e-20) if isinstance(lr, torch.Tensor) \
        else max(lr, 1e-20)
    return upd / lr


def _reduce_dw(dw: torch.Tensor, policy: QuantPolicy) -> torch.Tensor:
    """One leaf's dW reduced across replicas as the policy asks: the int8
    wire format (a codec round trip with no axes), a dense all-reduce over
    ``dw_psum_axes``, or as it is."""
    if policy.compress_dw:
        return compressed_psum(dw, policy.dw_psum_axes,
                               num_replicas=policy.dw_num_replicas)
    if policy.dw_psum_axes:
        return dense_psum(dw, policy.dw_psum_axes)
    return dw


def _bits_layer(bits: BitSchedule, i: int) -> dict:
    """Layer i's bitwidths as the body's ``b_l`` dict."""
    return {k: getattr(bits, k)[i]
            for k in ("w_i", "w_f", "a_i", "a_f", "g_i", "g_f")}


def _quantize_shared(shared: tuple, b_l: dict, enabled,
                     policy: QuantPolicy) -> tuple:
    """The shared operand in unit ``b_l``'s weight format."""
    return tuple(quantize_weight_tree(t, b_l["w_i"], b_l["w_f"], enabled,
                                      policy.quantize_weights)
                 for t in shared)


def _slice(tree, i: int):
    return tree_map(lambda a: a[i], tree)


def _leaf_paths(tree, pre: tuple = ()) -> list:
    """The key path of each leaf of a tree of dicts (``()`` for a bare
    leaf), in ``tree_leaves`` order (sorted keys)."""
    if not isinstance(tree, dict):
        return [pre]
    return [p for k in sorted(tree) for p in _leaf_paths(tree[k], pre + (k,))]


def _at(tree, path: tuple):
    for k in path:
        tree = tree[k]
    return tree


def _only(tree, path: tuple, leaf: bool = False):
    """The sub-tree of ``tree`` that holds only its leaf at ``path`` (with
    ``leaf``, ``tree`` is that leaf itself)."""
    out = tree if leaf else _at(tree, path)
    for k in reversed(path):
        out = {k: out}
    return out


def _num_units(stacked) -> int:
    return int(tree_leaves(stacked)[0].shape[0])


# ---------------------------------------------------------------------------
# Forward: the stack, caching the quantized layer inputs (the X_i registers)
# ---------------------------------------------------------------------------

@torch.no_grad()
def forward_stack(body_fn: Callable, stacked, x0: torch.Tensor,
                  bits: BitSchedule, policy: QuantPolicy, shared: tuple = (),
                  quantize_shared: bool = True):
    """body_fn(params_slice, x, bits_layer, *shared) -> (y, aux).

    Returns (x_final, caches, aux_sum): ``caches[i]`` is layer i's
    *quantized* input, exactly what the backward re-linearises at, so the
    forward and backward see the same numerics.  Runs without autograd.
    ``shared`` (a tuple of trees) is quantized with each unit's weight
    format, or with ``quantize_shared=False`` (a shared activation, which
    the caller quantized once) handed over as it is.
    """
    enabled = bits.enabled
    x, caches, aux_sum = x0, [], None
    for i in range(_num_units(stacked)):
        b_l = _bits_layer(bits, i)
        xq = (_blend_quant(x, b_l["a_i"], b_l["a_f"], enabled)
              if policy.quantize_acts else x)
        wq = quantize_weight_tree(_slice(stacked, i), b_l["w_i"],
                                  b_l["w_f"], enabled,
                                  policy.quantize_weights)
        sq = (_quantize_shared(shared, b_l, enabled, policy)
              if quantize_shared else shared)
        x, aux = body_fn(wq, xq, b_l, *sq)
        del wq, sq      # one unit's quantized weights at a time
        caches.append(xq)
        aux_sum = aux if aux_sum is None else aux_sum + aux
    return x, caches, aux_sum


# ---------------------------------------------------------------------------
# The update schedules of a layer's dW: leaf by leaf; blocking (one
# collective a layer, the sharded scatter update); the depth pipeline of
# in-flight ring reduces
# ---------------------------------------------------------------------------

def overlap_depth_for(policy: QuantPolicy, n_units: int) -> int:
    """Effective pipeline depth: ``policy.overlap_depth`` clamped to the
    layer count (a 2-layer stack can keep at most 2 reduces in flight)."""
    depth = int(policy.overlap_depth)
    if depth < 1:
        raise ValueError(
            f"QuantPolicy.overlap_depth must be >= 1, got {depth}")
    return min(depth, int(n_units))


def _dw_leaf_transports(policy: QuantPolicy, stacked) -> list:
    """The per-leaf transport decisions for one layer's dW tree (the [1:]
    slice shapes of ``stacked`` in f32, as the VJP hands dW over; meta
    tensors, no memory).  ``"ring"`` leaves have in-flight hops worth
    deferring ``overlap_depth`` layers; the blocking transports
    (``"psum"``, ``"scatter"``) complete at start and update in the same
    layer."""
    slices = [torch.empty(a.shape[1:], dtype=torch.float32, device="meta")
              for a in tree_leaves(stacked)]
    return resolve_leaf_transports(
        slices, policy.dw_psum_axes, compressed=policy.compress_dw,
        num_replicas=policy.dw_num_replicas, transport=policy.dw_transport)


def _make_blocking_layer_update(policy: QuantPolicy, hyper: Hyper,
                                optim_cfg: OptimizerConfig, enabled,
                                decisions: list):
    """A layer's reduce + quantize + update when every dW leaf rides a
    BLOCKING transport, over named axes and a group of more than one rank
    (``_updater``): the update lands in the same layer.

      * psum leaves go in ONE collective (``tree_all_reduce_start`` with
        ``transport="psum"``), one rendezvous a layer, not one a leaf;
      * scatter leaves get the ZeRO-style SHARDED update where the
        optimizer and the update quantizer are elementwise (sgd, no clip,
        no codec, no stochastic strict mode): reduce-scatter the dW leaf,
        quantize-update and step this rank's 1/g chunk only, all-gather
        the UPDATED parameters.  Elementwise math on the same chunk values
        keeps it within reassociation of the psum path.

    The sharded leaves' squared norm is this rank's chunk's only, so the
    caller closes the step with ``gsq += dense_psum(gsq_sharded, axes)``
    where ``uses_sharded``.  Returns ``(update_layer, uses_sharded)`` with
    ``update_layer(p_l, dW, opt_l, b_l, key) -> (new_p, new_opt, gsq,
    gsq_sharded)``."""
    axes = tuple(policy.dw_psum_axes)
    axis = axes if len(axes) > 1 else axes[0]
    g = group_size(axes, policy.dw_num_replicas)
    sharded_ok = (optim_cfg.kind == "sgd" and optim_cfg.grad_clip == 0
                  and not policy.compress_dw
                  and not (policy.quantize_updates and policy.stochastic))
    sharded = [d == "scatter" and sharded_ok for d in decisions]
    uses_sharded = any(sharded)

    def fused_psum(xs: list) -> list:
        return tree_all_reduce_wait(tree_all_reduce_start(
            xs, axes, num_replicas=policy.dw_num_replicas, transport="psum"))

    def update_layer(p_l, dW, opt_l, b_l, key):
        def qu(gg):
            return quantize_update(gg, b_l, key, enabled, policy, hyper)
        g_leaves = tree_leaves(dW)
        zero = torch.zeros((), dtype=torch.float32,
                           device=g_leaves[0].device)
        if not uses_sharded:
            # one blocking reduce of the layer + a whole-tree update: the
            # off path's numerics, any optimizer
            if policy.compress_dw:
                leaves = [compressed_psum(x, axes,
                                          num_replicas=policy.dw_num_replicas)
                          for x in g_leaves]
            else:
                leaves = fused_psum(g_leaves)
            leaves = [qu(x) for x in leaves]
            new_p, new_opt = apply_update(p_l, tree_unflatten(dW, leaves),
                                          opt_l, hyper, optim_cfg)
            gsq = sum(torch.sum(torch.square(x)) for x in leaves)
            return new_p, new_opt, gsq, zero
        p_leaves = tree_leaves(p_l)
        fuse = [i for i, s in enumerate(sharded) if not s]
        red = dict(zip(fuse, fused_psum([g_leaves[i] for i in fuse])))
        new_leaves: list = [None] * len(p_leaves)
        gsq, gsq_sh = zero, zero
        for i, (pw, gw) in enumerate(zip(p_leaves, g_leaves)):
            if sharded[i]:
                chunk = qu(reduce_scatter_chunk(gw, axis, g))
                own = shard_chunk(pw, axis, g)
                new_chunk, _ = apply_update(own, chunk, {}, hyper, optim_cfg)
                new_leaves[i] = all_gather_chunks(new_chunk, axis, g,
                                                  tuple(pw.shape), pw.dtype)
                gsq_sh = gsq_sh + torch.sum(torch.square(chunk))
            else:
                gq = qu(red[i])
                new_leaves[i], _ = apply_update(pw, gq, {}, hyper, optim_cfg)
                gsq = gsq + torch.sum(torch.square(gq))
        # sgd is stateless (sharded_ok implies it): opt_l passes through
        return tree_unflatten(p_l, new_leaves), opt_l, gsq, gsq_sh

    return update_layer, uses_sharded


def _start_layer(dW, policy: QuantPolicy):
    """Start a layer's dW all-reduce with the policy's transport."""
    return tree_all_reduce_start(dW, policy.dw_psum_axes,
                                 compressed=policy.compress_dw,
                                 num_replicas=policy.dw_num_replicas,
                                 transport=policy.dw_transport)


def _finalize(entry: dict, policy: QuantPolicy, hyper: Hyper,
              optim_cfg: OptimizerConfig, enabled):
    """Wait on a pending layer's reduce, quantize the update with the
    layer's own bits and key and step its step-start parameters and
    state.  Returns (new_p, new_opt, gsq)."""
    dW = tree_all_reduce_wait(entry["h"])
    dW = tree_map(lambda g: quantize_update(g, entry["bits"], entry["key"],
                                            enabled, policy, hyper), dW)
    new_p, new_opt = apply_update(entry["p"], dW, entry["opt"], hyper,
                                  optim_cfg)
    return new_p, new_opt, sum(torch.sum(torch.square(g))
                               for g in tree_leaves(dW))


def _write(new_stacked, new_opt, i: int, new_p, new_o) -> None:
    """Land layer i's updated parameters and state in the stacks."""
    for dst, src in zip(tree_leaves(new_stacked), tree_leaves(new_p)):
        dst[i].copy_(src)
    for dst, src in zip(tree_leaves(new_opt), tree_leaves(new_o)):
        dst[i].copy_(src)


class _Pipeline:
    """The depth-deep pipeline of in-flight layer reduces (the JAX scan's
    carry of pending entries, as a queue): ``push`` starts a layer's
    all-reduce and, once more than ``depth`` are in flight, lands the
    oldest; ``drain`` lands the rest, oldest first.  An entry holds the
    layer's step-start parameter and state views (the loop writes into new
    stacks, so they stay the step-start values), its bits and its key."""

    def __init__(self, depth: int, policy, hyper, optim_cfg, enabled,
                 new_stacked, new_opt, gsq):
        self.depth, self.queue = depth, collections.deque()
        self.args = (policy, hyper, optim_cfg, enabled)
        self.new_stacked, self.new_opt, self.gsq = new_stacked, new_opt, gsq

    def _land(self, entry: dict) -> None:
        new_p, new_o, ginc = _finalize(entry, *self.args)
        _write(self.new_stacked, self.new_opt, entry["i"], new_p, new_o)
        self.gsq = self.gsq + ginc

    def push(self, i: int, dW, p_l, opt_l, b_l, key) -> None:
        self.queue.append({"i": i, "p": p_l, "opt": opt_l, "bits": b_l,
                           "key": key, "h": _start_layer(dW, self.args[0])})
        if len(self.queue) > self.depth:
            self._land(self.queue.popleft())

    def drain(self):
        while self.queue:
            self._land(self.queue.popleft())
        return self.gsq


class _SameLayer:
    """The blocking schedule: each layer's update lands as it is pushed
    (``_make_blocking_layer_update``); ``drain`` closes the sharded
    leaves' squared norm over the group."""

    def __init__(self, decisions: list, policy, hyper, optim_cfg, enabled,
                 new_stacked, new_opt, gsq):
        self.update, self.uses_sharded = _make_blocking_layer_update(
            policy, hyper, optim_cfg, enabled, decisions)
        self.axes = tuple(policy.dw_psum_axes)
        self.new_stacked, self.new_opt = new_stacked, new_opt
        self.gsq = self.gsq_sh = gsq

    def push(self, i: int, dW, p_l, opt_l, b_l, key) -> None:
        new_p, new_o, ginc, ginc_sh = self.update(p_l, dW, opt_l, b_l, key)
        _write(self.new_stacked, self.new_opt, i, new_p, new_o)
        self.gsq, self.gsq_sh = self.gsq + ginc, self.gsq_sh + ginc_sh

    def drain(self):
        if self.uses_sharded:
            # the sharded leaves squared only this rank's chunk
            return self.gsq + dense_psum(self.gsq_sh, self.axes)
        return self.gsq


def _updater(policy: QuantPolicy, stacked, hyper: Hyper,
             optim_cfg: OptimizerConfig, enabled, new_stacked, new_opt, gsq):
    """The schedule of the layers' dW updates: None (leaf by leaf) with
    ``overlap="off"``, no axes or a group of one, where every decision
    would be psum and nothing moves; else, from the static per-leaf
    transport decisions, ``_Pipeline`` where a leaf rides the ring and
    ``_SameLayer`` where none does.  Both land each layer's update in
    ``new_stacked``/``new_opt`` and return the squared norm from
    ``drain``."""
    if policy.overlap not in ("off", "on"):
        raise ValueError(f"QuantPolicy.overlap must be 'off' or 'on', got "
                         f"{policy.overlap!r}")
    axes = tuple(policy.dw_psum_axes)
    if (policy.overlap == "off" or not axes
            or group_size(axes, policy.dw_num_replicas) == 1):
        return None
    decisions = _dw_leaf_transports(policy, stacked)
    if "ring" in decisions:
        return _Pipeline(overlap_depth_for(policy, _num_units(stacked)),
                         policy, hyper, optim_cfg, enabled, new_stacked,
                         new_opt, gsq)
    return _SameLayer(decisions, policy, hyper, optim_cfg, enabled,
                      new_stacked, new_opt, gsq)


def _layer_key(base_key, policy: QuantPolicy, i: int):
    return (prng.fold_in(base_key, i)
            if base_key is not None and policy.stochastic else None)


# ---------------------------------------------------------------------------
# Backward: the G-chain, reverse over layers, with the fused update
# ---------------------------------------------------------------------------

def backward_stack(body_fn: Callable, stacked, opt_stacked, caches,
                   bits: BitSchedule, G_out: torch.Tensor, hyper: Hyper,
                   policy: QuantPolicy, optim_cfg: OptimizerConfig,
                   aux_coef: float, base_key=None, shared: tuple = (),
                   quantize_shared: bool = True, specs=None):
    """The reverse loop over layers.  Per layer (the paper's steps 1-4 in
    one TDM frame):

      1. re-linearise the layer body at (q(W_i), X_i) under autograd;
      2. dW_i, G_i <- the VJP seeded by G_{i+1};
      3. G_i <- q(G_i), the low-bit backward signal sent upstream;
      4. W_i <- W_i - lr * dW_i at once, before layer i-1's VJP starts,
         each dW leaf first reduced across replicas where the policy asks
         (``_reduce_dw``).

    With ``policy.overlap == "on"`` over a group of more than one rank,
    step 4 follows the static per-leaf transport decisions
    (``_updater``): where a leaf rides the ring, layer i STARTS
    its whole dW tree's all-reduce and its update lands ``overlap_depth``
    layers later (``_Pipeline``), with layer i's own bits and key, on its
    step-start parameters; where every leaf rides a blocking transport the
    update lands in the same layer (``_make_blocking_layer_update``).
    Otherwise, and always with no axes or a group of one, the update goes
    leaf by leaf, and ``overlap="on"`` is bitwise ``"off"``.

    Gradient scale: ``G_out`` arrives scaled by ``policy.grad_scale``; dW is
    un-scaled just before the update, G stays scaled.  With
    ``policy.stochastic``, layer i rounds with the key ``fold_in(base_key,
    i)`` (a port key, ``util.prng``); without a ``base_key`` it rounds to
    nearest, as the JAX package does.

    ``shared`` is an input of every layer's VJP, taken with respect to the
    unquantized tree (the STE; quantized in each layer only with
    ``quantize_shared``, as in ``forward_stack``), and is not updated
    inside the loop: every layer sees its step-start value.  Its gradient
    dS is summed in f32 over the layers and stays in the scaled domain
    (the caller un-scales it: the hybrid applies it as the shared block's
    update, the encoder-decoder sends it back through the encoder).

    ``specs`` (a tree like ``stacked`` of its leaves' specs, under a model
    axis): the leaves are shards, updated as the module docstring says,
    and ``grad_sq_sum`` sums each shard's squares over the model group.

    Returns (G_in, new_stacked, new_opt, grad_sq_sum, dS), dS a tuple like
    ``shared``.
    """
    enabled = bits.enabled
    inv_scale = 1.0 / policy.grad_scale
    new_stacked = tree_map(torch.empty_like, stacked)
    new_opt = tree_map(torch.empty_like, opt_stacked)
    gsq = torch.zeros((), dtype=torch.float32, device=G_out.device)
    gsq_sh = torch.zeros((), dtype=torch.float32, device=G_out.device)
    # each leaf's spec as one layer's slice sees it
    slice_specs = (None if specs is None
                   else tree_map(lambda sp: P(*tuple(sp)[1:]), specs))
    updater = _updater(policy, stacked, hyper, optim_cfg, enabled,
                       new_stacked, new_opt, gsq)
    aux_seed = torch.tensor(aux_coef * policy.grad_scale, dtype=torch.float32,
                            device=G_out.device)
    dS = tuple(tree_map(lambda w: torch.zeros(w.shape, dtype=torch.float32,
                                              device=w.device), t)
               for t in shared)
    n_shared = len(tree_leaves(shared))
    G = G_out
    for i in reversed(range(_num_units(stacked))):
        b_l = _bits_layer(bits, i)
        key = _layer_key(base_key, policy, i)
        p_l = _slice(stacked, i)
        with torch.enable_grad():
            pw = tree_map(lambda w: w.detach().requires_grad_(), p_l)
            sw = tuple(tree_map(lambda w: w.detach().requires_grad_(), t)
                       for t in shared)
            xx = caches[i].detach().requires_grad_()
            wq = quantize_weight_tree(pw, b_l["w_i"], b_l["w_f"], enabled,
                                      policy.quantize_weights)
            sq = (_quantize_shared(sw, b_l, enabled, policy)
                  if quantize_shared else sw)
            y, aux = body_fn(wq, xx, b_l, *sq)
            del wq, sq  # autograd keeps what the VJP needs of them
            outs, seeds = [y], [G.to(y.dtype)]
            if aux.requires_grad:
                outs.append(aux)
                seeds.append(aux_seed)
            wrt = tree_leaves(pw) + tree_leaves(sw) + [xx]
            grads = torch.autograd.grad(outs, wrt, seeds, allow_unused=True)
            del y, aux, outs
        grads = [torch.zeros_like(w) if g is None else g
                 for g, w in zip(grads, wrt)]
        n_own = len(grads) - n_shared - 1
        with torch.no_grad():
            dS = tree_unflatten(dS, [
                a + g.to(torch.float32) for a, g in
                zip(tree_leaves(dS), grads[n_own:n_own + n_shared])])
            G = _quant_grad(grads[-1], b_l["g_i"], b_l["g_f"], enabled,
                            policy, key)
            opt_l = _slice(opt_stacked, i)
            if updater is not None:
                # the layer's whole dW tree (a group of two or more only)
                updater.push(i, tree_unflatten(
                    p_l, [g.to(torch.float32) * inv_scale
                          for g in grads[:n_own]]), p_l, opt_l, b_l, key)
                del grads
                continue
            # the update leaf by leaf, in ``tree_leaves`` order: one leaf's
            # dW, update and optimizer temporaries exist at a time (a
            # mixtral-8x7b expert stack is 1.9 GB of f32)
            for j, path in enumerate(_leaf_paths(p_l)):
                dw = grads[j].to(torch.float32) * inv_scale
                grads[j] = None
                dw = _reduce_dw(dw, policy)
                spec = None if specs is None else _at(slice_specs, path)
                dw = quantize_update(dw, b_l, key, enabled, policy, hyper,
                                     shard_block(spec, dw.shape))
                shard_kw = ({} if specs is None
                            else {"specs": _only(slice_specs, path)})
                new_p, new_o = apply_update(
                    _only(p_l, path), _only(dw, path, leaf=True),
                    {k: _only(t, path) for k, t in opt_l.items()}, hyper,
                    optim_cfg, **shard_kw)
                _at(new_stacked, path)[i].copy_(_at(new_p, path))
                for k, t in new_o.items():
                    _at(new_opt[k], path)[i].copy_(_at(t, path))
                if model_dim(spec) is None:
                    gsq = gsq + torch.sum(torch.square(dw))
                else:
                    gsq_sh = gsq_sh + torch.sum(torch.square(dw))
                del dw, new_p, new_o
            del grads
    if updater is not None:
        # the ring's last depth layers are still in flight
        gsq = updater.drain()
    if specs is not None:
        # each shard's squares once over the model group
        gsq = gsq + dense_psum(gsq_sh, MODEL)
    return G, new_stacked, new_opt, gsq, dS


# ---------------------------------------------------------------------------
# The stacked-dW update tail (the stage-sharded pipeline path)
# ---------------------------------------------------------------------------

@torch.no_grad()
def apply_stacked_updates(stacked, dW, opt_stacked, bits: BitSchedule,
                          hyper: Hyper, policy: QuantPolicy,
                          optim_cfg: OptimizerConfig, base_key=None):
    """Reduce + quantize + apply the per-layer updates of a whole stacked
    dW tree: the update tail of the stage-sharded pipeline, where the
    backward through the stages hands back every layer's dW at once.

    Per layer, as ``backward_stack``'s step 4 (the same order and the same
    per-layer keys): each dW leaf through ``_reduce_dw`` (the codec with
    ``compress_dw``, a dense all-reduce over ``dw_psum_axes``), then
    ``quantize_update``, then the optimizer.  ``overlap="off"`` (and any
    overlap with no axes or a group of one): layer by layer, the JAX
    package's vmap.  ``overlap="on"``: the schedules of the overlapped
    backward loop, over the layers in reverse: ring leaves through the
    depth pipeline, all-blocking layers same-layer with the fused psum and
    the sharded scatter update.

    Returns ``(new_stacked, new_opt, grad_sq_sum)``.
    """
    enabled = bits.enabled
    new_stacked = tree_map(torch.empty_like, stacked)
    new_opt = tree_map(torch.empty_like, opt_stacked)
    updater = _updater(policy, stacked, hyper, optim_cfg, enabled,
                       new_stacked, new_opt,
                       torch.zeros((), dtype=torch.float32,
                                   device=tree_leaves(stacked)[0].device))
    layers = [(i, _slice(dW, i), _slice(stacked, i), _slice(opt_stacked, i),
               _bits_layer(bits, i), _layer_key(base_key, policy, i))
              for i in range(_num_units(stacked))]
    if updater is not None:
        for layer in reversed(layers):
            updater.push(*layer)
        return new_stacked, new_opt, updater.drain()
    gsqs = []
    for i, g_l, p_l, opt_l, b_l, key in layers:
        g_l = tree_map(lambda g: quantize_update(
            _reduce_dw(g, policy), b_l, key, enabled, policy, hyper), g_l)
        new_p, new_o = apply_update(p_l, g_l, opt_l, hyper, optim_cfg)
        _write(new_stacked, new_opt, i, new_p, new_o)
        gsqs.append(sum(torch.sum(torch.square(g))
                        for g in tree_leaves(g_l)))
    return new_stacked, new_opt, torch.sum(torch.stack(gsqs))
