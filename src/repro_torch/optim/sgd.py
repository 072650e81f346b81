"""Optimizers built for per-layer fused updates (port of ``optim/sgd.py``).

The TaxoNN engine applies updates inside the backward pass, one layer at a
time (the paper's step-4 fused ``W -= alpha * dW``).  So the optimizer is a
leafwise ``apply_update(params, grads, state, hyper)`` over any sub-tree
(one layer's slice or the whole boundary group): no whole-model gradient
tree ever exists on the TaxoNN path.

Kinds:
  sgd        -- stateless (the paper's optimizer)
  momentum   -- classic heavy-ball
  momentum8  -- heavy-ball with int8 momentum buffers, one scale a row (over
                the last axis), rounded half to even
  adam       -- for baseline comparisons

Under a model axis (``dist.sharding``) a leaf may be one rank's shard of
the logical leaf: ``apply_update``'s ``specs`` name each leaf's spec, and
the two reductions over a leaf then span the model group, so that each
rank's update is its slice of the logical leaf's: the per-leaf clip's sum
of squares (a SUM), and momentum8's rowwise absmax where the leaf is
sharded on its last dimension (a MAX; its ``m_s`` is then replicated).
"""
from __future__ import annotations

import dataclasses
from typing import Union

import torch

from repro_torch.dist.collectives import dense_pmax, dense_psum
from repro_torch.dist.sharding import MODEL, model_dim
from repro_torch.util.tree import tree_map, tree_unzip

Scalar = Union[float, int, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    kind: str = "sgd"             # sgd | momentum | momentum8 | adam
    momentum: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: float = 0.0        # 0 = off; per-leaf clip by its own norm


@dataclasses.dataclass(frozen=True)
class Hyper:
    """Per-step hyperparameters: ``lr`` and ``step`` as Python numbers or
    scalar tensors (a tensor is read on its device, with no host sync)."""
    lr: Scalar
    step: Scalar


def init_opt_state(params, cfg: OptimizerConfig) -> dict:
    if cfg.kind == "sgd":
        return {}
    if cfg.kind == "momentum":
        return {"m": tree_map(torch.zeros_like, params)}
    if cfg.kind == "momentum8":
        # one scale a row (over the last axis): stacked params keep their
        # leading layer axis, so the engine can slice the state per layer
        return {
            "m_q": tree_map(lambda w: torch.zeros(w.shape, dtype=torch.int8,
                                                  device=w.device), params),
            "m_s": tree_map(lambda w: torch.ones(w.shape[:-1],
                                                 dtype=torch.float32,
                                                 device=w.device), params),
        }
    if cfg.kind == "adam":
        return {"m": tree_map(torch.zeros_like, params),
                "v": tree_map(torch.zeros_like, params)}
    raise ValueError(cfg.kind)


def _clip(g: torch.Tensor, limit: float, spec=None) -> torch.Tensor:
    """Clip ``g`` by its own norm: the logical leaf's where ``spec``
    shards it over "model" (the sum of squares summed over the group)."""
    if limit <= 0:
        return g
    sq = torch.sum(torch.square(g.to(torch.float32)))
    if model_dim(spec) is not None:
        sq = dense_psum(sq, MODEL)
    norm = torch.sqrt(sq)
    return g * torch.clamp_max(limit / (norm + 1e-12), 1.0)


def _grad(g, w, cfg: OptimizerConfig, spec=None) -> torch.Tensor:
    g = _clip(g, cfg.grad_clip, spec).to(torch.float32)
    if cfg.weight_decay:
        g = g + cfg.weight_decay * w
    return g


@torch.no_grad()
def apply_update(params, grads, state, hyper: Hyper, cfg: OptimizerConfig,
                 *, specs=None):
    """Leafwise update over a sub-tree.  ``specs``: a tree like ``params``
    of each leaf's spec (``dist.sharding.P``) where the leaves are shards
    (module docstring), else None.  Returns (params, state)."""
    lr = hyper.lr
    if specs is None:
        specs = tree_map(lambda _: None, params)

    if cfg.kind == "sgd":
        def upd(w, g, sp):
            return (w - lr * _grad(g, w, cfg, sp)).to(w.dtype)
        return tree_map(upd, params, grads, specs), state

    if cfg.kind == "momentum":
        def upd(w, g, m, sp):
            m_new = cfg.momentum * m + _grad(g, w, cfg, sp)
            return (w - lr * m_new).to(w.dtype), m_new
        new_p, new_m = tree_unzip(tree_map(upd, params, grads, state["m"],
                                           specs), 2)
        return new_p, {"m": new_m}

    if cfg.kind == "momentum8":
        def upd(w, g, mq, ms, sp):
            m = mq.to(torch.float32) * ms[..., None]
            m_new = cfg.momentum * m + _grad(g, w, cfg, sp)
            absmax = torch.amax(torch.abs(m_new), dim=-1)
            if model_dim(sp) == w.dim() - 1:    # rows span the group
                absmax = dense_pmax(absmax, MODEL)
            s_new = torch.where(absmax > 0, absmax / 127.0,
                                torch.ones_like(absmax))
            mq_new = torch.clamp(torch.round(m_new / s_new[..., None]),
                                 -127, 127).to(torch.int8)
            return (w - lr * m_new).to(w.dtype), mq_new, s_new
        new_p, m_q, m_s = tree_unzip(tree_map(
            upd, params, grads, state["m_q"], state["m_s"], specs), 3)
        return new_p, {"m_q": m_q, "m_s": m_s}

    if cfg.kind == "adam":
        t = torch.as_tensor(hyper.step, dtype=torch.float32) + 1.0

        def upd(w, g, m, v, sp):
            g = _grad(g, w, cfg, sp)
            m_new = cfg.momentum * m + (1 - cfg.momentum) * g
            v_new = cfg.beta2 * v + (1 - cfg.beta2) * torch.square(g)
            tt = t.to(w.device)
            mh = m_new / (1 - cfg.momentum ** tt)
            vh = v_new / (1 - cfg.beta2 ** tt)
            return ((w - lr * mh / (torch.sqrt(vh) + cfg.eps)).to(w.dtype),
                    m_new, v_new)
        new_p, m, v = tree_unzip(tree_map(upd, params, grads, state["m"],
                                          state["v"], specs), 3)
        return new_p, {"m": m, "v": v}

    raise ValueError(cfg.kind)
