"""Per-family blocks (port of ``models/blocks.py``): the transformer block
of the dense family and of the hybrid's weight-tied shared block (attention
and MLP), and the Mamba2 block of the ssm and hybrid backbones.  Each has
an initializer, the full-sequence apply, and the contiguous cache's prefill
and one-token decode.  Paged serving runs its own block body
(``serving.engine._paged_block``).  MoE, MLA, the encoder-decoder and the
vlm blocks are not ported yet and raise (ROADMAP A9)."""
from __future__ import annotations

import torch

from repro_torch.kernels import decode_prologue as DP
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models.config import ModelConfig

PORTED_FAMILIES = ("dense", "ssm", "hybrid")


def require_ported(cfg: ModelConfig) -> None:
    """Raise unless the port's blocks cover ``cfg``: the dense, ssm and
    hybrid families, with no MLA."""
    if cfg.family not in PORTED_FAMILIES or cfg.use_mla:
        raise NotImplementedError(
            f"the port's models cover the dense, ssm and hybrid families (no "
            f"MLA) so far, not {cfg.family}"
            f"{' with MLA' if cfg.use_mla else ''} (ROADMAP A9)")


def init_transformer_block(gen: torch.Generator, cfg: ModelConfig) -> dict:
    require_ported(cfg)
    dev = gen.device
    return {"attn_norm": L.init_norm(cfg.d_model, cfg, dev),
            "mlp_norm": L.init_norm(cfg.d_model, cfg, dev),
            "attn": L.init_attention(gen, cfg),
            "mlp": L.init_mlp(gen, cfg)}


def transformer_block(params, x: torch.Tensor, cfg: ModelConfig,
                      positions: torch.Tensor, causal: bool = True):
    """Pre-norm attention and MLP with residuals.  Returns (new_x, aux):
    the dense block has no auxiliary loss, so aux is an f32 zero."""
    require_ported(cfg)
    h = L.apply_norm(params["attn_norm"], x, cfg)
    x = x + L.attention(params["attn"], h, cfg, positions, causal=causal)
    h = L.apply_norm(params["mlp_norm"], x, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + L.mlp(params["mlp"], h, cfg), aux


def init_block_cache(cfg: ModelConfig, batch: int, max_len: int,
                     dtype=torch.bfloat16, device=None) -> dict:
    require_ported(cfg)
    return L.init_kv_cache(cfg, batch, max_len, dtype, device)


def transformer_block_decode(params, x: torch.Tensor, cfg: ModelConfig,
                             cache: dict, pos: int):
    """One decode token per row against the block's contiguous cache
    (written in place); ``pos`` is the batch's one write position.  With a
    kernel backend installed, the fused decode-prologue kernel computes
    RMSNorm + QKV + RoPE, and the MLP runs on ``fxp_matmul``."""
    require_ported(cfg)
    if DP.prologue_active(cfg, x):
        q, k, v = DP.decode_prologue(
            params["attn_norm"], params["attn"], x, cfg,
            torch.full((x.shape[0],), pos, dtype=torch.int32,
                       device=x.device))
        attn_out, cache = L.attention_decode_tail(
            params["attn"], q, k, v, x.dtype, cfg, cache, pos)
    else:
        h = L.apply_norm(params["attn_norm"], x, cfg)
        attn_out, cache = L.attention_decode(params["attn"], h, cfg, cache,
                                             pos)
    x = x + attn_out
    h = L.apply_norm(params["mlp_norm"], x, cfg)
    return x + L.mlp(params["mlp"], h, cfg), cache


def transformer_block_prefill(params, x: torch.Tensor, cfg: ModelConfig,
                              positions: torch.Tensor, cache_len: int,
                              cache_dtype=torch.bfloat16):
    """The full-sequence block that also seeds the decode cache from this
    layer's K/V (placed by ``fill_ring``, cast to ``cache_dtype``)."""
    require_ported(cfg)
    h = L.apply_norm(params["attn_norm"], x, cfg)
    attn_out, (k, v) = L.attention(params["attn"], h, cfg, positions,
                                   causal=True, return_kv=True)
    length = (cache_len if cfg.swa_window is None
              else min(cfg.swa_window, cache_len))
    cache = {"k": L.fill_ring(k, length).to(cache_dtype),
             "v": L.fill_ring(v, length).to(cache_dtype)}
    x = x + attn_out
    h = L.apply_norm(params["mlp_norm"], x, cfg)
    return x + L.mlp(params["mlp"], h, cfg), cache


# ---------------------------------------------------------------------------
# Mamba2 block (ssm / hybrid backbone)
# ---------------------------------------------------------------------------

def init_mamba_block(gen: torch.Generator, cfg: ModelConfig) -> dict:
    return {"norm": L.init_norm(cfg.d_model, cfg, gen.device),
            "mamba": S.init_mamba(gen, cfg)}


def mamba_block(params, x: torch.Tensor, cfg: ModelConfig, positions=None):
    """Pre-norm Mamba2 with a residual.  Returns (new_x, f32 zero aux)."""
    h = L.apply_norm(params["norm"], x, cfg)
    out, _ = S.mamba_forward(params["mamba"], h, cfg)
    return x + out, torch.zeros((), dtype=torch.float32, device=x.device)


def mamba_block_decode(params, x: torch.Tensor, cfg: ModelConfig,
                       cache: dict, pos=None):
    """One token against the layer's state (written in place); the Mamba
    step needs no position."""
    h = L.apply_norm(params["norm"], x, cfg)
    out, cache = S.mamba_decode(params["mamba"], h, cfg, cache)
    return x + out, cache


def mamba_block_prefill(params, x: torch.Tensor, cfg: ModelConfig,
                        positions=None, cache_dtype=torch.bfloat16):
    """The full-sequence block that also returns the layer's decode state:
    the final SSD state (f32) and the conv tail cast to ``cache_dtype``."""
    h = L.apply_norm(params["norm"], x, cfg)
    out, (hT, conv_tail) = S.mamba_forward(params["mamba"], h, cfg)
    return x + out, {"h": hT, "conv": conv_tail.to(cache_dtype)}
