"""Transformer blocks of the dense family (port of ``models/blocks.py``):
the initializer and the full-sequence block the training engine runs.
Serving runs its own block body (``serving.engine._paged_block``).  MoE and
MLA blocks are not ported yet and raise."""
from __future__ import annotations

import torch

from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig


def _dense_only(cfg: ModelConfig) -> None:
    if cfg.family != "dense" or cfg.use_mla:
        raise NotImplementedError(
            f"the port covers the dense family (no MLA) so far, not "
            f"{cfg.family} (ROADMAP A9)")


def init_transformer_block(gen: torch.Generator, cfg: ModelConfig) -> dict:
    _dense_only(cfg)
    dev = gen.device
    return {"attn_norm": L.init_norm(cfg.d_model, cfg, dev),
            "mlp_norm": L.init_norm(cfg.d_model, cfg, dev),
            "attn": L.init_attention(gen, cfg),
            "mlp": L.init_mlp(gen, cfg)}


def transformer_block(params, x: torch.Tensor, cfg: ModelConfig,
                      positions: torch.Tensor, causal: bool = True):
    """Pre-norm attention and MLP with residuals.  Returns (new_x, aux):
    the dense block has no auxiliary loss, so aux is an f32 zero."""
    _dense_only(cfg)
    h = L.apply_norm(params["attn_norm"], x, cfg)
    x = x + L.attention(params["attn"], h, cfg, positions, causal=causal)
    h = L.apply_norm(params["mlp_norm"], x, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + L.mlp(params["mlp"], h, cfg), aux
