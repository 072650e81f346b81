"""Model parameters for the dense family (port of the serving subset of
``models/lm.py``).

Parameters are a nested dict of tensors in the JAX package's layout: the
``blocks`` leaves are stacked on a leading layer axis, so ``wq`` is
[L, D, H, hd].  ``params_from_numpy`` carries a JAX parameter pytree across
(given as numpy arrays, e.g. ``jax.tree.map(np.asarray, params)``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models import blocks as B
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig


def _stack(trees: list) -> dict:
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


def init_params(cfg: ModelConfig, seed: int = 0, device=None) -> dict:
    """Random f32 master weights for the dense family, drawn from a
    ``torch.Generator`` on ``device`` seeded with ``seed`` (CUDA unless the
    caller names another; raises when CUDA is absent)."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"the port covers the dense family so far, not {cfg.family}")
    gen = torch.Generator(device=resolve_device(device))
    gen.manual_seed(int(seed))
    D, V = cfg.d_model, cfg.vocab_size
    params = {"embed": L._randn(gen, (V, D), D ** -0.5),
              "final_norm": L.init_norm(D, cfg, gen.device)}
    if not cfg.tie_embeddings:
        params["lm_head"] = L._randn(gen, (D, V), D ** -0.5)
    params["blocks"] = _stack([B.init_transformer_block(gen, cfg)
                               for _ in range(cfg.num_layers)])
    return params


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32


def head_weight(params, cfg: ModelConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        return params["embed"].T  # [D, V]
    return params["lm_head"]


def params_from_numpy(tree, device=None):
    """The JAX parameter pytree (numpy leaves) as the port's dict of tensors,
    with the same keys, shapes, dtypes and layout, on ``device`` (CUDA
    unless the caller names another: ``resolve_device``)."""
    device = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, copy=True)).to(device)


def layer_params(blocks: dict, i: int) -> dict:
    """Layer ``i``'s parameters: views into the stacked ``blocks`` leaves."""
    return {k: layer_params(v, i) if isinstance(v, dict) else v[i]
            for k, v in blocks.items()}
