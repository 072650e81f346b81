"""Per-family blocks (port of ``models/blocks.py``): the transformer block
of the dense and moe families and of the hybrid's weight-tied shared block
(GQA attention or, with ``use_mla``, MLA; then the MLP or the routed
experts), and the Mamba2 block of the ssm and hybrid backbones.  Each has
an initializer, the full-sequence apply, and the contiguous cache's
prefill and one-token decode.  Paged serving runs its own block body
(``serving.engine._paged_block``; no MLA, as in the JAX package).  The
encoder-decoder and the vlm blocks are not ported yet and raise (ROADMAP
A9e)."""
from __future__ import annotations

import torch

from repro_torch.kernels import decode_prologue as DP
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models.config import ModelConfig

PORTED_FAMILIES = ("dense", "moe", "ssm", "hybrid")
_LATER_ITEM = {"encdec": "A9e", "vlm": "A9e"}


def require_ported(cfg: ModelConfig) -> None:
    """Raise unless the port's blocks cover ``cfg``: the dense, moe, ssm
    and hybrid families, with MLA or GQA attention; the error names the
    ROADMAP item that ports the rest."""
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"the port's models cover the dense, moe, ssm and hybrid "
            f"families so far, not {cfg.family} (ROADMAP "
            f"{_LATER_ITEM.get(cfg.family, 'A9')})")


def init_transformer_block(gen: torch.Generator, cfg: ModelConfig) -> dict:
    require_ported(cfg)
    dev = gen.device
    p = {"attn_norm": L.init_norm(cfg.d_model, cfg, dev),
         "mlp_norm": L.init_norm(cfg.d_model, cfg, dev),
         "attn": (L.init_mla(gen, cfg) if cfg.use_mla
                  else L.init_attention(gen, cfg))}
    if cfg.family == "moe":
        p["moe"] = L.init_moe(gen, cfg)
    else:
        p["mlp"] = L.init_mlp(gen, cfg)
    return p


def ffn(params, h: torch.Tensor, cfg: ModelConfig):
    """The block's feed-forward half: (out, aux), the routed experts and
    their load-balance aux in the moe family, else the MLP and None."""
    if cfg.family == "moe":
        return L.moe(params["moe"], h, cfg)
    return L.mlp(params["mlp"], h, cfg), None


def transformer_block(params, x: torch.Tensor, cfg: ModelConfig,
                      positions: torch.Tensor, causal: bool = True):
    """Pre-norm attention and MLP (or routed experts) with residuals.
    Returns (new_x, aux): the moe block's load-balance aux, an f32 zero in
    the dense block."""
    require_ported(cfg)
    h = L.apply_norm(params["attn_norm"], x, cfg)
    if cfg.use_mla:
        x = x + L.mla_attention(params["attn"], h, cfg, positions)
    else:
        x = x + L.attention(params["attn"], h, cfg, positions,
                            causal=causal)
    h = L.apply_norm(params["mlp_norm"], x, cfg)
    out, aux = ffn(params, h, cfg)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + out, aux


def init_block_cache(cfg: ModelConfig, batch: int, max_len: int,
                     dtype=torch.bfloat16, device=None) -> dict:
    require_ported(cfg)
    if cfg.use_mla:
        return L.init_mla_cache(cfg, batch, max_len, dtype, device)
    return L.init_kv_cache(cfg, batch, max_len, dtype, device)


def transformer_block_decode(params, x: torch.Tensor, cfg: ModelConfig,
                             cache: dict, pos: int):
    """One decode token per row against the block's contiguous cache
    (written in place); ``pos`` is the batch's one write position.  With a
    kernel backend installed, the fused decode-prologue kernel computes
    RMSNorm + QKV + RoPE, and the dense MLP runs on ``fxp_matmul`` (the
    moe experts and MLA's absorbed decode are plain products, as in the
    JAX package)."""
    require_ported(cfg)
    if cfg.use_mla:
        h = L.apply_norm(params["attn_norm"], x, cfg)
        attn_out, cache = L.mla_decode(params["attn"], h, cfg, cache, pos)
    elif DP.prologue_active(cfg, x):
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
    return x + ffn(params, h, cfg)[0], cache


def transformer_block_prefill(params, x: torch.Tensor, cfg: ModelConfig,
                              positions: torch.Tensor, cache_len: int,
                              cache_dtype=torch.bfloat16):
    """The full-sequence block that also seeds the decode cache from this
    layer's K/V (placed by ``fill_ring``, cast to ``cache_dtype``), or
    with MLA from its latents and rope keys (padded to ``cache_len``, no
    ring, cast to ``cache_dtype``)."""
    require_ported(cfg)
    h = L.apply_norm(params["attn_norm"], x, cfg)
    if cfg.use_mla:
        attn_out, (ckv, kpe) = L.mla_attention(params["attn"], h, cfg,
                                               positions, return_cache=True)
        pad = (0, 0, 0, cache_len - ckv.shape[1])
        cache = {"ckv": torch.nn.functional.pad(ckv, pad).to(cache_dtype),
                 "kpe": torch.nn.functional.pad(kpe, pad).to(cache_dtype)}
    else:
        attn_out, (k, v) = L.attention(params["attn"], h, cfg, positions,
                                       causal=True, return_kv=True)
        length = (cache_len if cfg.swa_window is None
                  else min(cfg.swa_window, cache_len))
        cache = {"k": L.fill_ring(k, length).to(cache_dtype),
                 "v": L.fill_ring(v, length).to(cache_dtype)}
    x = x + attn_out
    h = L.apply_norm(params["mlp_norm"], x, cfg)
    return x + ffn(params, h, cfg)[0], cache


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
