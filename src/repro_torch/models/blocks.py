"""Transformer block parameters (port of ``models/blocks.py``; the dense
family's initializer only: serving runs the block body in
``serving.engine._paged_block``)."""
from __future__ import annotations

import torch

from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig


def init_transformer_block(gen: torch.Generator, cfg: ModelConfig) -> dict:
    if cfg.use_mla or cfg.family == "moe":
        raise NotImplementedError(
            "the port covers the dense family (no MLA / MoE) so far")
    dev = gen.device
    return {"attn_norm": L.init_norm(cfg.d_model, cfg, dev),
            "mlp_norm": L.init_norm(cfg.d_model, cfg, dev),
            "attn": L.init_attention(gen, cfg),
            "mlp": L.init_mlp(gen, cfg)}
