"""Per-family blocks (port of ``models/blocks.py``): the transformer block
of the dense, moe and vlm families, of the encoder-decoder's encoder
(``causal=False``) and of the hybrid's weight-tied shared block (GQA
attention or, with ``use_mla``, MLA; then the MLP or the routed experts),
the Mamba2 block of the ssm and hybrid backbones, and the encoder-decoder's
decoder block (causal self-attention, cross-attention over the encoder's
output, the MLP).  Each has an initializer, the full-sequence apply, and
the contiguous cache's prefill and one-token decode.  Paged serving runs
its own block body (``serving.engine._paged_block``; no MLA and no
cross-attention, as in the JAX package)."""
from __future__ import annotations

import torch

from repro_torch.dist.api import constrain
from repro_torch.kernels import decode_prologue as DP
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models.config import ModelConfig

PORTED_FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")


def require_ported(cfg: ModelConfig) -> None:
    """Raise unless ``cfg``'s family is one of the JAX package's six
    (``PORTED_FAMILIES``), with MLA or GQA attention."""
    if cfg.family not in PORTED_FAMILIES:
        raise ValueError(f"unknown model family {cfg.family!r}; the "
                         f"families are {PORTED_FAMILIES}")


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


def ffn(params, h: torch.Tensor, cfg: ModelConfig,
        moe_aux_parts: bool = False):
    """The block's feed-forward half: (out, aux), the routed experts and
    their load-balance aux in the moe family (with ``moe_aux_parts`` its
    two batch-mean statistics ``{"frac", "p"}``), else the MLP and None."""
    if cfg.family == "moe":
        if moe_aux_parts:
            out, frac, probs_mean = L.moe_verbose(params["moe"], h, cfg)
            return out, {"frac": frac, "p": probs_mean}
        return L.moe(params["moe"], h, cfg)
    return L.mlp(params["mlp"], h, cfg), None


def transformer_block(params, x: torch.Tensor, cfg: ModelConfig,
                      positions: torch.Tensor, causal: bool = True,
                      moe_aux_parts: bool = False):
    """Pre-norm attention and MLP (or routed experts) with residuals.
    Returns (new_x, aux): the moe block's load-balance aux, an f32 zero in
    the dense block.  ``moe_aux_parts=True`` returns the moe aux as its two
    batch-mean statistics ``{"frac", "p"}``: the aux is bilinear in those
    means, so a caller that splits the batch (the stage-sharded pipeline)
    accumulates the parts and recombines them with
    ``layers.moe_aux_from_stats``."""
    require_ported(cfg)
    x = constrain(x, "btd")
    h = L.apply_norm(params["attn_norm"], x, cfg)
    if cfg.use_mla:
        x = x + L.mla_attention(params["attn"], h, cfg, positions)
    else:
        x = x + L.attention(params["attn"], h, cfg, positions,
                            causal=causal)
    h = L.apply_norm(params["mlp_norm"], x, cfg)
    out, aux = ffn(params, h, cfg, moe_aux_parts)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return constrain(x + out, "btd"), aux


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
    x = constrain(x, "btd")
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
    return constrain(x + ffn(params, h, cfg)[0], "btd"), cache


# ---------------------------------------------------------------------------
# Mamba2 block (ssm / hybrid backbone)
# ---------------------------------------------------------------------------

def init_mamba_block(gen: torch.Generator, cfg: ModelConfig) -> dict:
    return {"norm": L.init_norm(cfg.d_model, cfg, gen.device),
            "mamba": S.init_mamba(gen, cfg)}


def mamba_block(params, x: torch.Tensor, cfg: ModelConfig, positions=None):
    """Pre-norm Mamba2 with a residual.  Returns (new_x, f32 zero aux)."""
    x = constrain(x, "btd")
    h = L.apply_norm(params["norm"], x, cfg)
    out, _ = S.mamba_forward(params["mamba"], h, cfg)
    return constrain(x + out, "btd"), torch.zeros((), dtype=torch.float32, device=x.device)


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
    x = constrain(x, "btd")
    h = L.apply_norm(params["norm"], x, cfg)
    out, (hT, conv_tail) = S.mamba_forward(params["mamba"], h, cfg)
    return constrain(x + out, "btd"), {"h": hT, "conv": conv_tail.to(cache_dtype)}


# ---------------------------------------------------------------------------
# Whisper decoder block (self-attn + cross-attn + mlp)
# ---------------------------------------------------------------------------

def init_decoder_block(gen: torch.Generator, cfg: ModelConfig) -> dict:
    dev = gen.device
    return {"self_norm": L.init_norm(cfg.d_model, cfg, dev),
            "self_attn": L.init_attention(gen, cfg),
            "cross_norm": L.init_norm(cfg.d_model, cfg, dev),
            "cross_attn": L.init_attention(gen, cfg),
            "mlp_norm": L.init_norm(cfg.d_model, cfg, dev),
            "mlp": L.init_mlp(gen, cfg)}


def cross_kv(params, enc_out: torch.Tensor, dt):
    """The cross-attention's keys and values [B, S, Hkv, hd] from the
    encoder's output, plain products in ``dt`` (as JAX's einsums)."""
    k = torch.einsum("bsd,dhk->bshk", enc_out, params["wk"].to(dt))
    v = torch.einsum("bsd,dhk->bshk", enc_out, params["wv"].to(dt))
    return k, v


def _cross_attend(params, x: torch.Tensor, k, v, cfg: ModelConfig):
    """Queries from the decoder's ``x`` over the encoder's ``k``/``v`` (in
    x's dtype): f32 scores, softmax, probabilities cast to x's dtype, then
    the output projection; every product plain, as in the JAX package."""
    dt = x.dtype
    q = torch.einsum("btd,dhk->bthk", x, params["wq"].to(dt))
    k = L._expand_kv(k, cfg.gqa_groups)
    v = L._expand_kv(v, cfg.gqa_groups)
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32),
                     k.to(torch.float32)) * cfg.head_dim ** -0.5
    p = torch.softmax(s, dim=-1).to(dt)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v)
    return torch.einsum("bthk,hkd->btd", out, params["wo"].to(dt))


def _cross_attention(params, x: torch.Tensor, enc_out: torch.Tensor,
                     cfg: ModelConfig) -> torch.Tensor:
    """Cross-attention: queries from decoder x, keys/values from enc_out."""
    k, v = cross_kv(params, enc_out, x.dtype)
    return _cross_attend(params, x, k, v, cfg)


def decoder_block(params, x: torch.Tensor, cfg: ModelConfig,
                  positions: torch.Tensor, enc_out: torch.Tensor):
    """Pre-norm causal self-attention, cross-attention over ``enc_out``
    and the MLP, with residuals.  Returns (new_x, f32 zero aux)."""
    x = constrain(x, "btd")
    h = L.apply_norm(params["self_norm"], x, cfg)
    x = x + L.attention(params["self_attn"], h, cfg, positions, causal=True)
    h = L.apply_norm(params["cross_norm"], x, cfg)
    x = x + _cross_attention(params["cross_attn"], h, enc_out, cfg)
    h = L.apply_norm(params["mlp_norm"], x, cfg)
    x = constrain(x + L.mlp(params["mlp"], h, cfg), "btd")
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def init_decoder_cache(cfg: ModelConfig, batch: int, max_len: int,
                       enc_len: int, dtype=torch.bfloat16,
                       device=None) -> dict:
    """The self-attention's KV ring and the cross-attention's K/V
    [B, enc_len, Hkv, hd] (filled at prefill)."""
    shape = (batch, enc_len, cfg.num_kv_heads, cfg.head_dim)
    return {"self": L.init_kv_cache(cfg, batch, max_len, dtype, device),
            "cross_k": torch.zeros(shape, dtype=dtype, device=device),
            "cross_v": torch.zeros(shape, dtype=dtype, device=device)}


def decoder_block_decode(params, x: torch.Tensor, cfg: ModelConfig,
                         cache: dict, pos: int):
    """One decode token per row: the self-attention against its ring
    (written in place), the cross-attention over the cached K/V."""
    dt = x.dtype
    h = L.apply_norm(params["self_norm"], x, cfg)
    attn_out, _ = L.attention_decode(params["self_attn"], h, cfg,
                                     cache["self"], pos)
    x = x + attn_out
    h = L.apply_norm(params["cross_norm"], x, cfg)
    x = x + _cross_attend(params["cross_attn"], h, cache["cross_k"].to(dt),
                          cache["cross_v"].to(dt), cfg)
    h = L.apply_norm(params["mlp_norm"], x, cfg)
    return x + L.mlp(params["mlp"], h, cfg), cache


def decoder_block_prefill(params, x: torch.Tensor, cfg: ModelConfig,
                          positions: torch.Tensor, enc_out: torch.Tensor,
                          cache_len: int, cache_dtype=torch.bfloat16):
    """The full-sequence decoder block that also seeds its cache: the
    self-attention's K/V in the ring, the cross-attention's K/V from
    ``enc_out``, each cast to ``cache_dtype``."""
    h = L.apply_norm(params["self_norm"], x, cfg)
    attn_out, (k, v) = L.attention(params["self_attn"], h, cfg, positions,
                                   causal=True, return_kv=True)
    self_cache = {"k": L.fill_ring(k, cache_len).to(cache_dtype),
                  "v": L.fill_ring(v, cache_len).to(cache_dtype)}
    x = x + attn_out
    h = L.apply_norm(params["cross_norm"], x, cfg)
    ck, cv = cross_kv(params["cross_attn"], enc_out, x.dtype)
    x = x + _cross_attend(params["cross_attn"], h, ck, cv, cfg)
    h = L.apply_norm(params["mlp_norm"], x, cfg)
    x = x + L.mlp(params["mlp"], h, cfg)
    return x, {"self": self_cache, "cross_k": ck.to(cache_dtype),
               "cross_v": cv.to(cache_dtype)}


def fill_cross_cache(params_stacked, enc_out: torch.Tensor,
                     cfg: ModelConfig, dtype=torch.bfloat16):
    """The cross-attention K/V of every decoder layer from the encoder's
    output, stacked on a leading layer axis: ([L, B, S, Hkv, hd] twice)."""
    ks, vs = [], []
    for i in range(params_stacked["cross_attn"]["wk"].shape[0]):
        p = {k: t[i] for k, t in params_stacked["cross_attn"].items()}
        k, v = cross_kv(p, enc_out, enc_out.dtype)
        ks.append(k.to(dtype))
        vs.append(v.to(dtype))
    return torch.stack(ks), torch.stack(vs)
