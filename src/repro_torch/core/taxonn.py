"""The TaxoNN engine: SGD unrolled into an explicit per-layer G-chain (port
of ``core/taxonn.py``, single device, blocking path).

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
operand that every unit reads besides its own slice (the hybrid's
weight-tied attention block): a tuple of trees handed to the body after
its bits, quantized with each unit's weight format, and differentiated
in every unit's VJP at the step-start weights; the backward sums its
gradient over the units.  ``QuantPolicy.bit_anneal`` carries a
step-indexed F-bit ramp (``search.anneal``) that
``core.steps.make_train_step`` applies to the step's bits.  The JAX package's options for the multi-device engine (the
dW all-reduce, its codec, overlap and transports, ``grad_tap_stochastic``)
are not fields of the port's ``QuantPolicy`` yet: they come with
multi-GPU (A11).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

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


def quantize_update(g: torch.Tensor, b_l: dict, key, enabled,
                    policy: QuantPolicy, hyper: Hyper) -> torch.Tensor:
    """Strict-paper mode: ``q(alpha * dW)`` in the layer's gradient (I,F)
    format, returned in the dW domain (divided back by lr) so the
    optimizer applies it unchanged.  With ``policy.stochastic`` and the
    layer ``key``, the rounding is stochastic with noise drawn from that
    key (every leaf of a layer draws from the same key)."""
    if not policy.quantize_updates:
        return g
    upd = hyper.lr * g
    if policy.stochastic and key is not None:
        updq = quantize_stochastic(upd, b_l["g_i"], b_l["g_f"], key)
    else:
        updq = quantize_ste(upd, b_l["g_i"], b_l["g_f"])
    upd = enabled * updq + (1.0 - enabled) * upd
    lr = hyper.lr
    lr = torch.clamp_min(lr, 1e-20) if isinstance(lr, torch.Tensor) \
        else max(lr, 1e-20)
    return upd / lr


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
                  bits: BitSchedule, policy: QuantPolicy, shared: tuple = ()):
    """body_fn(params_slice, x, bits_layer, *shared) -> (y, aux).

    Returns (x_final, caches, aux_sum): ``caches[i]`` is layer i's
    *quantized* input, exactly what the backward re-linearises at, so the
    forward and backward see the same numerics.  Runs without autograd.
    ``shared`` (a tuple of trees) is quantized with each unit's weight
    format.
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
        sq = _quantize_shared(shared, b_l, enabled, policy)
        x, aux = body_fn(wq, xq, b_l, *sq)
        del wq, sq      # one unit's quantized weights at a time
        caches.append(xq)
        aux_sum = aux if aux_sum is None else aux_sum + aux
    return x, caches, aux_sum


# ---------------------------------------------------------------------------
# Backward: the G-chain, reverse over layers, with the fused update
# ---------------------------------------------------------------------------

def backward_stack(body_fn: Callable, stacked, opt_stacked, caches,
                   bits: BitSchedule, G_out: torch.Tensor, hyper: Hyper,
                   policy: QuantPolicy, optim_cfg: OptimizerConfig,
                   aux_coef: float, base_key=None, shared: tuple = ()):
    """The reverse loop over layers.  Per layer (the paper's steps 1-4 in
    one TDM frame):

      1. re-linearise the layer body at (q(W_i), X_i) under autograd;
      2. dW_i, G_i <- the VJP seeded by G_{i+1};
      3. G_i <- q(G_i), the low-bit backward signal sent upstream;
      4. W_i <- W_i - lr * dW_i at once, before layer i-1's VJP starts.

    Gradient scale: ``G_out`` arrives scaled by ``policy.grad_scale``; dW is
    un-scaled just before the update, G stays scaled.  With
    ``policy.stochastic``, layer i rounds with the key ``fold_in(base_key,
    i)`` (a port key, ``util.prng``); without a ``base_key`` it rounds to
    nearest, as the JAX package does.

    ``shared`` is an input of every layer's VJP, taken with respect to the
    unquantized tree (the STE), and is not updated inside the loop: every
    layer sees the step-start shared weights.  Its gradient dS is summed
    in f32 over the layers and stays in the scaled domain (the caller
    un-scales it and applies its update).

    Returns (G_in, new_stacked, new_opt, grad_sq_sum, dS), dS a tuple like
    ``shared``.
    """
    enabled = bits.enabled
    inv_scale = 1.0 / policy.grad_scale
    new_stacked = tree_map(torch.empty_like, stacked)
    new_opt = tree_map(torch.empty_like, opt_stacked)
    gsq = torch.zeros((), dtype=torch.float32, device=G_out.device)
    aux_seed = torch.tensor(aux_coef * policy.grad_scale, dtype=torch.float32,
                            device=G_out.device)
    dS = tuple(tree_map(lambda w: torch.zeros(w.shape, dtype=torch.float32,
                                              device=w.device), t)
               for t in shared)
    n_shared = len(tree_leaves(shared))
    G = G_out
    for i in reversed(range(_num_units(stacked))):
        b_l = _bits_layer(bits, i)
        key = (prng.fold_in(base_key, i)
               if base_key is not None and policy.stochastic else None)
        p_l = _slice(stacked, i)
        with torch.enable_grad():
            pw = tree_map(lambda w: w.detach().requires_grad_(), p_l)
            sw = tuple(tree_map(lambda w: w.detach().requires_grad_(), t)
                       for t in shared)
            xx = caches[i].detach().requires_grad_()
            wq = quantize_weight_tree(pw, b_l["w_i"], b_l["w_f"], enabled,
                                      policy.quantize_weights)
            sq = _quantize_shared(sw, b_l, enabled, policy)
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
            # the update leaf by leaf, in ``tree_leaves`` order: one leaf's
            # dW, update and optimizer temporaries exist at a time (a
            # mixtral-8x7b expert stack is 1.9 GB of f32)
            opt_l = _slice(opt_stacked, i)
            for j, path in enumerate(_leaf_paths(p_l)):
                dw = grads[j].to(torch.float32) * inv_scale
                grads[j] = None
                dw = quantize_update(dw, b_l, key, enabled, policy, hyper)
                new_p, new_o = apply_update(
                    _only(p_l, path), _only(dw, path, leaf=True),
                    {k: _only(t, path) for k, t in opt_l.items()}, hyper,
                    optim_cfg)
                _at(new_stacked, path)[i].copy_(_at(new_p, path))
                for k, t in new_o.items():
                    _at(new_opt[k], path)[i].copy_(_at(t, path))
                gsq = gsq + torch.sum(torch.square(dw))
                del dw, new_p, new_o
            del grads
    return G, new_stacked, new_opt, gsq, dS
