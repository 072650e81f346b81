"""The layers (port of ``models/layers.py``): norms, RoPE, the
kernel-datapath dense unit with its backward, full-sequence GQA attention
(materialised or chunked online softmax), the attention projections that
serving uses, the contiguous KV cache's ring buffer with its one-token
decode attention, MLA (DeepSeek-V2's latent attention: the materialised
prefill and the absorbed decode over a latent cache), the MLP and the
routed experts.

Parameters are nested dicts of tensors in the JAX package's layout (``wq``
[D, H, hd], ``wo`` [H, hd, D], ...).  Initializers draw from an explicit
``torch.Generator`` on the target device; they match the JAX package's
shapes and distributions, not its random bits.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ops as kops
from repro_torch.kernels.common import act_deriv, act_fn
from repro_torch.models.config import ModelConfig

ATTN_CHUNK_THRESHOLD = 8192   # online-softmax over KV blocks above this T
ATTN_KV_BLOCK = 1024

NEG_INF = -1e30  # additive mask value (finite: no NaN in masked rows)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def init_norm(d: int, cfg: ModelConfig, device=None) -> dict:
    p = {"scale": torch.ones(d, dtype=torch.float32, device=device)}
    if cfg.norm_kind == "layernorm":
        p["bias"] = torch.zeros(d, dtype=torch.float32, device=device)
    return p


def rmsnorm(params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    xf = x.to(torch.float32)
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * params["scale"]).to(dtype)


def layernorm(params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * params["scale"] + params["bias"]).to(dtype)


def apply_norm(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.norm_kind == "layernorm":
        return layernorm(params, x, cfg.norm_eps)
    return rmsnorm(params, x, cfg.norm_eps)


# ---------------------------------------------------------------------------
# RoPE (half-rotation convention)
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [..., T, H, hd]; positions: broadcastable to [..., T]."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)
    angles = positions[..., None].to(torch.float32) * freqs
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# The kernel-datapath dense unit (the TaxoNN PE array as an autograd op)
# ---------------------------------------------------------------------------
#
# ``dense_unit(x, w, act)`` computes act(x @ w) on the kernel datapath of
# the active backend (``kops``): the forward is ``fxp_matmul``; the backward
# is ``bp_gstep`` (dx, Eq. 8's matmul leg) and the dW-only form of
# ``sgd_dw_update`` (Eq. 9).  The engine's STE wrappers own the (I,F) grid
# around this op, so the unit itself stays format-agnostic.  With the
# backend "off" the unit is plain PyTorch under autograd.

class _DenseUnit(torch.autograd.Function):
    """The JAX package's custom VJP of ``_dense_unit``: z is kept only for
    a non-identity activation; dz = dy·f'(z) in f32; dx is cast to x's
    dtype and dW to w's.  Autograd is off inside both methods, so the
    kernel calls record no graph."""

    @staticmethod
    def forward(ctx, x, w, act, backend):
        shape = x.shape
        x2 = x.reshape(-1, shape[-1]).contiguous()
        z = kops.dense_fwd(x2, w, backend)                   # f32 [M, N]
        y = act_fn(z, act).to(x.dtype).reshape(shape[:-1] + (w.shape[1],))
        # z is a per-layer residual: under the engine's recompute-per-layer
        # backward it lives for one layer only
        ctx.save_for_backward(x2, w, z if act != "identity" else None)
        ctx.act, ctx.backend, ctx.shape = act, backend, shape
        return y

    @staticmethod
    def backward(ctx, dy):
        x2, w, z = ctx.saved_tensors
        dy2 = dy.reshape(-1, dy.shape[-1]).to(torch.float32).contiguous()
        dz = dy2 if z is None else dy2 * act_deriv(z, ctx.act)
        dx = kops.dense_bwd_dx(dz, w, ctx.backend)           # Eq. 8 leg
        dw = kops.dense_bwd_dw(x2, dz, ctx.backend)          # Eq. 9
        return dx.reshape(ctx.shape).to(x2.dtype), dw.to(w.dtype), None, None


def dense_unit(x: torch.Tensor, w: torch.Tensor, act: str = "identity",
               backend: Optional[str] = None) -> torch.Tensor:
    """act(x @ w) on the active kernel datapath. x: [..., K]; w: [K, N]."""
    backend = backend or kops.current_backend()
    if backend == "off":
        return act_fn((x @ w.to(x.dtype)).to(torch.float32),
                      act).to(x.dtype)
    return _DenseUnit.apply(x, w.contiguous(), act, backend)


def _proj3(x: torch.Tensor, w3: torch.Tensor, backend: str) -> torch.Tensor:
    """Projection einsum "btd,dhk->bthk" through the dense unit."""
    d, h, hd = w3.shape
    y = dense_unit(x, w3.reshape(d, h * hd), "identity", backend)
    return y.reshape(x.shape[:-1] + (h, hd))


# ---------------------------------------------------------------------------
# Dense attention (GQA / MQA)
# ---------------------------------------------------------------------------

def alloc_heads(cfg: ModelConfig) -> int:
    return cfg.padded_heads or cfg.num_heads


def _live_head_mask(cfg: ModelConfig, dtype, device=None):
    """[H_alloc] mask, 1 for real heads (padding extends each KV group)."""
    hp, h, hkv = alloc_heads(cfg), cfg.num_heads, cfg.num_kv_heads
    if hp == h:
        return None
    g, gp = h // hkv, hp // hkv
    mask = (torch.arange(gp, device=device) < g).to(dtype)
    return mask.expand(hkv, gp).reshape(hp)


def _randn(gen: torch.Generator, shape, std: float) -> torch.Tensor:
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=gen.device) * std


def init_attention(gen: torch.Generator, cfg: ModelConfig) -> dict:
    D, Hkv, hd = cfg.d_model, cfg.num_kv_heads, cfg.head_dim
    H = alloc_heads(cfg)
    s = D ** -0.5
    p = {
        "wq": _randn(gen, (D, H, hd), s),
        "wk": _randn(gen, (D, Hkv, hd), s),
        "wv": _randn(gen, (D, Hkv, hd), s),
        "wo": _randn(gen, (H, hd, D), (H * hd) ** -0.5),
    }
    if cfg.qkv_bias:
        dev = gen.device
        p["bq"] = torch.zeros((H, hd), dtype=torch.float32, device=dev)
        p["bk"] = torch.zeros((Hkv, hd), dtype=torch.float32, device=dev)
        p["bv"] = torch.zeros((Hkv, hd), dtype=torch.float32, device=dev)
    return p


def _project_qkv(params, x: torch.Tensor, cfg: ModelConfig, positions):
    dt = x.dtype
    backend = kops.current_backend()
    if backend != "off":
        q = _proj3(x, params["wq"], backend)
        k = _proj3(x, params["wk"], backend)
        v = _proj3(x, params["wv"], backend)
    else:
        q = torch.einsum("btd,dhk->bthk", x, params["wq"].to(dt))
        k = torch.einsum("btd,dhk->bthk", x, params["wk"].to(dt))
        v = torch.einsum("btd,dhk->bthk", x, params["wv"].to(dt))
    if cfg.qkv_bias:
        q = q + params["bq"].to(dt)
        k = k + params["bk"].to(dt)
        v = v + params["bv"].to(dt)
    if cfg.use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _expand_kv(k: torch.Tensor, groups: int) -> torch.Tensor:
    """[B, T, Hkv, hd] -> [B, T, Hkv*groups, hd] by repeat (GQA)."""
    if groups == 1:
        return k
    b, t, hkv, hd = k.shape
    return k[:, :, :, None, :].expand(b, t, hkv, groups, hd).reshape(
        b, t, hkv * groups, hd)


def _masked_wo(params, cfg: ModelConfig, dt) -> torch.Tensor:
    wo = params["wo"].to(dt)
    mask = _live_head_mask(cfg, dt, wo.device)
    if mask is not None:
        wo = wo * mask[:, None, None]
    return wo


def _attn_mask(t_q: int, t_kv: int, causal: bool, window: Optional[int],
               q_offset: int = 0, device=None) -> torch.Tensor:
    """Additive mask [t_q, t_kv]; query i sits at position i + q_offset."""
    qpos = torch.arange(t_q, device=device)[:, None] + q_offset
    kpos = torch.arange(t_kv, device=device)[None, :]
    ok = torch.ones((t_q, t_kv), dtype=torch.bool, device=device)
    if causal:
        ok &= kpos <= qpos
    if window is not None:
        ok &= kpos > qpos - window
    return torch.where(ok, 0.0, NEG_INF).to(torch.float32)


def _sdpa_full(q, k, v, mask, scale) -> torch.Tensor:
    """Softmax attention with the scores materialised, in the reference's
    order: f32 scores, additive mask, softmax, probs cast to q's dtype.
    q, k, v: [B, T, H, hd]."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32),
                          k.to(torch.float32)) * scale
    scores = scores + mask[None, None]
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _sdpa_chunked(q, k, v, causal, window, scale) -> torch.Tensor:
    """Online-softmax attention over KV blocks of ATTN_KV_BLOCK (memory
    O(T * block), not O(T^2)).  K and V head dims may differ."""
    b, t, h, hd = q.shape
    dv = v.shape[-1]
    blk = min(ATTN_KV_BLOCK, t)
    nblk = (t + blk - 1) // blk
    pad = nblk * blk - t
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    qpos = torch.arange(t, device=q.device)[:, None]
    qf = q.to(torch.float32)
    acc = torch.zeros((b, t, h, dv), dtype=torch.float32, device=q.device)
    m = torch.full((b, h, t), NEG_INF, dtype=torch.float32, device=q.device)
    lse = torch.zeros((b, h, t), dtype=torch.float32, device=q.device)
    for i in range(nblk):
        kblk, vblk = k[:, i * blk:(i + 1) * blk], v[:, i * blk:(i + 1) * blk]
        kpos = i * blk + torch.arange(blk, device=q.device)[None, :]
        ok = kpos < t
        if causal:
            ok = ok & (kpos <= qpos)
        if window is not None:
            ok = ok & (kpos > qpos - window)
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kblk.to(torch.float32)) * scale
        s = s + torch.where(ok, 0.0, NEG_INF)[None, None]
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        lse = lse * corr + torch.sum(p, dim=-1)
        pv = torch.einsum("bhqk,bkhd->bqhd", p.to(q.dtype).to(torch.float32),
                          vblk.to(torch.float32))
        acc = acc * corr.transpose(1, 2)[..., None] + pv
        m = m_new
    out = acc / torch.clamp_min(lse, 1e-30).transpose(1, 2)[..., None]
    return out.to(q.dtype)


def attention(params, x: torch.Tensor, cfg: ModelConfig,
              positions: torch.Tensor, causal: bool = True,
              return_kv: bool = False):
    """Full-sequence attention (training / prefill). x: [B, T, D].

    ``return_kv=True`` also returns the rotated K/V before GQA expansion.
    Scores are plain tensor products outside any kernel; the chunked path
    runs above ATTN_CHUNK_THRESHOLD tokens (the reference's ``flash_attn``
    perf option is not ported).
    """
    dt = x.dtype
    b, t, _ = x.shape
    q, k, v = _project_qkv(params, x, cfg, positions)
    groups = q.shape[2] // cfg.num_kv_heads
    kx, vx = _expand_kv(k, groups), _expand_kv(v, groups)
    scale = cfg.head_dim ** -0.5
    if t > ATTN_CHUNK_THRESHOLD:
        out = _sdpa_chunked(q, kx, vx, causal, cfg.swa_window, scale)
    else:
        mask = _attn_mask(t, t, causal, cfg.swa_window, device=x.device)
        out = _sdpa_full(q, kx, vx, mask, scale)
    wo = _masked_wo(params, cfg, dt)
    backend = kops.current_backend()
    if backend != "off":
        # the output projection on the kernel datapath
        h_, hd_, d_ = wo.shape
        y = dense_unit(out.reshape(b, t, h_ * hd_), wo.reshape(h_ * hd_, d_),
                       "identity", backend)
    else:
        y = torch.einsum("bthk,hkd->btd", out, wo)
    if return_kv:
        return y, (k, v)
    return y


def fill_ring(k: torch.Tensor, length: int) -> torch.Tensor:
    """Place a [B, T, ...] sequence into a ring buffer of ``length`` slots
    so that the token at absolute position p sits at slot p % length (as
    ``attention_decode`` indexes it).  Keeps the last ``length`` tokens."""
    t = k.shape[1]
    if t <= length:
        pad = [0, 0] * (k.dim() - 2) + [0, length - t]
        return torch.nn.functional.pad(k, pad)
    tail = k[:, t - length:]
    idx = (torch.arange(length, device=k.device) - t) % length
    return torch.index_select(tail, 1, idx)


# ---------------------------------------------------------------------------
# Decode with a contiguous KV cache
# ---------------------------------------------------------------------------

def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int,
                  dtype=torch.bfloat16, device=None) -> dict:
    """Ring-buffer KV cache.  For SWA archs the buffer is min(window,
    max_len) long."""
    length = (max_len if cfg.swa_window is None
              else min(cfg.swa_window, max_len))
    shape = (batch, length, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def attention_decode(params, x: torch.Tensor, cfg: ModelConfig, cache: dict,
                     pos: int):
    """One-token decode. x: [B, 1, D]; ``pos``: the position every row's
    token is written at (one for the whole batch, as in the JAX package)."""
    b = x.shape[0]
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q, k, v = _project_qkv(params, x, cfg, positions)
    return attention_decode_tail(params, q, k, v, x.dtype, cfg, cache, pos)


def attention_decode_tail(params, q, k, v, dt, cfg: ModelConfig,
                          cache: dict, pos: int):
    """Cache write + ring-masked softmax + output projection: everything
    after the prologue, shared by the unfused path and the fused
    decode-prologue kernel.  Writes the cache IN PLACE (K/V cast to the
    cache's dtype, with no scale for an int8 cache, as the JAX package
    casts) and returns (y [B, 1, D], cache)."""
    length = cache["k"].shape[1]
    slot = pos % length
    cache["k"][:, slot] = k[:, 0].to(cache["k"].dtype)
    cache["v"][:, slot] = v[:, 0].to(cache["v"].dtype)
    groups = q.shape[2] // cfg.num_kv_heads
    kk = _expand_kv(cache["k"].to(dt), groups)
    vv = _expand_kv(cache["v"].to(dt), groups)
    scale = cfg.head_dim ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32),
                     kk.to(torch.float32)) * scale
    # valid slots: the absolute position last written to slot i is
    # pos - ((slot - i) mod length); it must lie in [0, pos]
    idx = torch.arange(length, device=q.device)
    abs_pos = pos - (slot - idx) % length
    ok = (abs_pos >= 0) & (abs_pos <= pos)
    if cfg.swa_window is not None:
        ok &= abs_pos > pos - cfg.swa_window
    s = s + torch.where(ok, 0.0, NEG_INF)[None, None, None, :]
    p = torch.softmax(s, dim=-1).to(dt)
    out = torch.einsum("bhqk,bkhd->bqhd", p, vv)
    y = torch.einsum("bthk,hkd->btd", out, _masked_wo(params, cfg, dt))
    return y, cache


# ---------------------------------------------------------------------------
# MLA attention (DeepSeek-V2)
# ---------------------------------------------------------------------------
#
# Every MLA product is a plain tensor product, as the JAX package computes
# them outside any Pallas kernel: an MLA layer launches no kernel.

def init_mla(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """The six MLA matrices, drawn in the JAX package's order, and the
    latent's RMSNorm scale."""
    D, H = cfg.d_model, cfg.num_heads
    r, dn, dr, dv = (cfg.kv_lora_rank, cfg.qk_nope_dim, cfg.qk_rope_dim,
                     cfg.v_head_dim)
    s = D ** -0.5
    return {"wq": _randn(gen, (D, H, dn + dr), s),
            "w_dkv": _randn(gen, (D, r), s),
            "w_kpe": _randn(gen, (D, dr), s),
            "w_uk": _randn(gen, (r, H, dn), r ** -0.5),
            "w_uv": _randn(gen, (r, H, dv), r ** -0.5),
            "wo": _randn(gen, (H, dv, D), (H * dv) ** -0.5),
            "ckv_norm": {"scale": torch.ones(r, dtype=torch.float32,
                                             device=gen.device)}}


def _mla_query(params, x: torch.Tensor, cfg: ModelConfig, positions):
    """(q_nope [B,T,H,dn], rotated q_pe [B,T,H,dr])."""
    q = torch.einsum("btd,dhk->bthk", x, params["wq"].to(x.dtype))
    dn = cfg.qk_nope_dim
    return q[..., :dn], apply_rope(q[..., dn:], positions, cfg.rope_theta)


def _mla_latent(params, x: torch.Tensor, cfg: ModelConfig, positions):
    """(c_kv [B,T,r], the normed rank-r latent; k_pe [B,T,1,dr], the
    rotated rope key that every head shares)."""
    dt = x.dtype
    c_kv = rmsnorm(params["ckv_norm"],
                   torch.einsum("btd,dr->btr", x, params["w_dkv"].to(dt)),
                   cfg.norm_eps)
    k_pe = apply_rope(
        torch.einsum("btd,dr->btr", x, params["w_kpe"].to(dt))[:, :, None],
        positions, cfg.rope_theta)
    return c_kv, k_pe


def mla_attention(params, x: torch.Tensor, cfg: ModelConfig,
                  positions: torch.Tensor, return_cache: bool = False):
    """Full-sequence MLA (training / prefill): per-head K/V materialised
    from the latent, causal softmax at the scale (dn + dr)^-0.5, chunked
    above ATTN_CHUNK_THRESHOLD tokens.  ``return_cache=True`` also returns
    (c_kv [B,T,r], k_pe [B,T,dr]), what the decode cache holds."""
    dt = x.dtype
    b, t, _ = x.shape
    dn, dr = cfg.qk_nope_dim, cfg.qk_rope_dim
    q_nope, q_pe = _mla_query(params, x, cfg, positions)
    c_kv, k_pe = _mla_latent(params, x, cfg, positions)
    k_nope = torch.einsum("btr,rhk->bthk", c_kv, params["w_uk"].to(dt))
    v = torch.einsum("btr,rhk->bthk", c_kv, params["w_uv"].to(dt))
    k = torch.cat([k_nope, k_pe.expand(b, t, cfg.num_heads, dr)], dim=-1)
    qq = torch.cat([q_nope, q_pe], dim=-1)
    scale = (dn + dr) ** -0.5
    if t > ATTN_CHUNK_THRESHOLD:
        out = _sdpa_chunked(qq, k, v, True, None, scale)
    else:
        mask = _attn_mask(t, t, True, None, device=x.device)
        out = _sdpa_full(qq, k, v, mask, scale)
    y = torch.einsum("bthk,hkd->btd", out, params["wo"].to(dt))
    if return_cache:
        return y, (c_kv, k_pe[:, :, 0, :])
    return y


def init_mla_cache(cfg: ModelConfig, batch: int, max_len: int,
                   dtype=torch.bfloat16, device=None) -> dict:
    """The compressed cache: the rank-r latents and the shared rope key."""
    return {"ckv": torch.zeros((batch, max_len, cfg.kv_lora_rank),
                               dtype=dtype, device=device),
            "kpe": torch.zeros((batch, max_len, cfg.qk_rope_dim),
                               dtype=dtype, device=device)}


def mla_absorb_q(q_nope: torch.Tensor, w_uk: torch.Tensor) -> torch.Tensor:
    """The decode's absorbed query: q_nope [B,1,H,dn] through w_uk [r,H,dn]
    into the latent space, q_lat [B,H,r]."""
    return torch.einsum("bthk,rhk->bhr", q_nope, w_uk)


def mla_decode(params, x: torch.Tensor, cfg: ModelConfig, cache: dict,
               pos: int):
    """One-token absorbed MLA decode. x: [B, 1, D]; ``pos``: the batch's one
    write position.  Writes this token's latent and rope key into the
    cache IN PLACE (cast to its dtype with no scale, as the JAX package
    casts), then attends in the rank-r latent space: scores q_lat . ckv +
    q_pe . kpe (each product in x's dtype, summed, then f32 times the
    scale), masked to positions <= pos; o_lat = p . ckv, then w_uv and
    wo.  Per-head K/V are never materialised.  Returns (y [B, 1, D],
    cache)."""
    dt = x.dtype
    b = x.shape[0]
    dn, dr = cfg.qk_nope_dim, cfg.qk_rope_dim
    posb = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q_nope, q_pe = _mla_query(params, x, cfg, posb)
    c_new, kpe_new = _mla_latent(params, x, cfg, posb)
    cache["ckv"][:, pos] = c_new[:, 0].to(cache["ckv"].dtype)
    cache["kpe"][:, pos] = kpe_new[:, 0, 0].to(cache["kpe"].dtype)
    ckv, kpe = cache["ckv"].to(dt), cache["kpe"].to(dt)
    q_lat = mla_absorb_q(q_nope, params["w_uk"].to(dt))
    s_nope = torch.einsum("bhr,bsr->bhs", q_lat, ckv)
    s_pe = torch.einsum("bthk,bsk->bhs", q_pe, kpe)
    s = (s_nope + s_pe).to(torch.float32) * ((dn + dr) ** -0.5)
    valid = torch.arange(ckv.shape[1], device=x.device) <= pos
    s = s + torch.where(valid, 0.0, NEG_INF)[None, None, :]
    p = torch.softmax(s, dim=-1).to(dt)
    o_lat = torch.einsum("bhs,bsr->bhr", p, ckv)
    out = torch.einsum("bhr,rhk->bhk", o_lat, params["w_uv"].to(dt))
    y = torch.einsum("bhk,hkd->bd", out, params["wo"].to(dt))[:, None, :]
    return y, cache


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def init_mlp(gen: torch.Generator, cfg: ModelConfig,
             d_ff: Optional[int] = None) -> dict:
    D = cfg.d_model
    F = d_ff or cfg.d_ff
    s_in, s_out = D ** -0.5, F ** -0.5
    if cfg.mlp_kind in ("swiglu", "geglu"):
        return {"w_gate": _randn(gen, (D, F), s_in),
                "w_up": _randn(gen, (D, F), s_in),
                "w_down": _randn(gen, (F, D), s_out)}
    return {"w_up": _randn(gen, (D, F), s_in),
            "w_down": _randn(gen, (F, D), s_out)}


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu`` as XLA computes it: x * (1 / (1 + exp(-x))), each
    op rounded to x's dtype (bitwise JAX's on the CPU in bf16; ``F.silu``
    rounds once and differs by a bf16 ulp on a third of the values)."""
    return x * (1.0 / (1.0 + torch.exp(-x)))


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return torch.nn.functional.gelu(x, approximate="tanh")


def mlp(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    dt = x.dtype
    backend = kops.current_backend()
    if backend != "off":
        # the MLP matmuls on the kernel datapath (fxp_matmul)
        if cfg.mlp_kind in ("swiglu", "geglu"):
            actk = "silu" if cfg.mlp_kind == "swiglu" else "gelu"
            g = dense_unit(x, params["w_gate"], actk, backend)
            u = dense_unit(x, params["w_up"], "identity", backend)
            return dense_unit(g * u, params["w_down"], "identity", backend)
        h = dense_unit(x, params["w_up"], "gelu", backend)
        return dense_unit(h, params["w_down"], "identity", backend)
    if cfg.mlp_kind in ("swiglu", "geglu"):
        act = silu if cfg.mlp_kind == "swiglu" else _gelu_tanh
        g = act(x @ params["w_gate"].to(dt))
        u = x @ params["w_up"].to(dt)
        return (g * u) @ params["w_down"].to(dt)
    h = _gelu_tanh(x @ params["w_up"].to(dt))
    return h @ params["w_down"].to(dt)


# ---------------------------------------------------------------------------
# MoE (top-k routing, per-row sort-based capacity dispatch, shared experts)
# ---------------------------------------------------------------------------
#
# The router and the experts are plain tensor products, as the JAX package
# computes them outside any Pallas kernel.  Its ``_moe_experts_shardmap``
# (the "moe_rowcombine" perf option) is multi-device and waits for A11.

def init_moe(gen: torch.Generator, cfg: ModelConfig) -> dict:
    D, E, F = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    s_in, s_out = D ** -0.5, F ** -0.5
    p = {"router": _randn(gen, (D, E), s_in),
         "w_gate": _randn(gen, (E, D, F), s_in),
         "w_up": _randn(gen, (E, D, F), s_in),
         "w_down": _randn(gen, (E, F, D), s_out)}
    if cfg.num_shared_experts:
        Fs = cfg.moe_d_ff * cfg.num_shared_experts
        p["shared"] = {"w_gate": _randn(gen, (D, Fs), s_in),
                       "w_up": _randn(gen, (D, Fs), s_in),
                       "w_down": _randn(gen, (Fs, D), Fs ** -0.5)}
    return p


def moe_capacity(cfg: ModelConfig, n_tokens: int) -> int:
    """Slots an expert takes from one batch row of ``n_tokens``:
    ``int(t * K * cf / E)``, at least 8, rounded up to a multiple of 8."""
    c = int(n_tokens * cfg.experts_per_token * cfg.capacity_factor
            / cfg.num_experts)
    return max(8, -(-c // 8) * 8)


def moe_aux_from_stats(frac: torch.Tensor,
                       probs_mean: torch.Tensor) -> torch.Tensor:
    """The load-balance aux ``E * sum_e frac[e] * probs_mean[e]``: bilinear
    in two batch means, so a caller that splits the batch accumulates the
    two statistics, not the aux."""
    return torch.sum(frac * probs_mean) * frac.shape[-1]


def top_k_lower_first(probs: torch.Tensor, k: int):
    """``lax.top_k`` over the last axis: the k largest values in descending
    order, a tie broken toward the lower index, the same on every device
    (a stable descending sort; ``torch.topk`` leaves the order of ties
    unspecified).  Returns (values, int64 indices)."""
    idx = torch.sort(probs, dim=-1, descending=True, stable=True).indices
    idx = idx[..., :k]
    return torch.gather(probs, -1, idx), idx


def moe_route(params, x: torch.Tensor, cfg: ModelConfig) -> dict:
    """Routing and the per-row dispatch plan of ``moe_verbose``.  x:
    [b, t, D].  Returns a dict of

      probs [b,t,E] f32, top_p [b,t,K] f32 (renormalised), top_e [b,t,K],
      frac [E] and probs_mean [E] (the aux statistics), and, per batch row
      over its t*K picks in (token, k) order: order (a stable sort by
      expert), sw (the sorted weights, in x's dtype), stok (each sorted
      pick's token), keep (its rank in its expert is under the capacity C)
      and slot (expert * C + rank, or the trash slot E*C), and C.

    The router product runs in x's dtype, the softmax in f32 as
    ``jax.nn.softmax`` computes it; ``frac`` comes from a one-hot and
    carries no gradient, ``probs_mean`` and ``top_p`` do."""
    dt = x.dtype
    b, t, _ = x.shape
    E, K = cfg.num_experts, cfg.experts_per_token
    C = moe_capacity(cfg, t)
    nk = t * K
    logits = torch.einsum("btd,de->bte", x, params["router"].to(dt))
    lf = logits.to(torch.float32)
    ex = torch.exp(lf - torch.amax(lf, dim=-1, keepdim=True))
    probs = ex / torch.sum(ex, dim=-1, keepdim=True)
    top_p, top_e = top_k_lower_first(probs, K)
    top_p = top_p / torch.sum(top_p, dim=-1, keepdim=True)
    onehot = torch.nn.functional.one_hot(top_e, E).to(torch.float32)
    frac = torch.mean(onehot, dim=(0, 1, 2))
    probs_mean = torch.mean(probs, dim=(0, 1))

    flat_e = top_e.reshape(b, nk)
    flat_w = top_p.reshape(b, nk).to(dt)
    order = torch.argsort(flat_e, dim=-1, stable=True)      # per-row sort
    se = torch.gather(flat_e, -1, order)
    sw = torch.gather(flat_w, -1, order)
    stok = order // K                                      # source token
    counts = torch.sum(torch.nn.functional.one_hot(flat_e, E), dim=1)
    offsets = torch.cumsum(counts, dim=-1) - counts
    pos_in_e = (torch.arange(nk, device=x.device)[None, :]
                - torch.gather(offsets, -1, se))
    keep = pos_in_e < C
    slot = torch.where(keep, se * C + pos_in_e, E * C)
    return dict(probs=probs, top_p=top_p, top_e=top_e, frac=frac,
                probs_mean=probs_mean, order=order, sw=sw, stok=stok,
                keep=keep, slot=slot, C=C)


class _RepeatRows(torch.autograd.Function):
    """x [b, t, D] -> each token's row repeated K times, [b, t*K, D] (row
    t*K + j is token t's).  The backward sums a token's K row gradients
    in f32 in j order and rounds the sum once to the gradient's dtype:
    when j ranks a token's picks by expert, the bits of the CPU's
    backward of a gather that reads the token's row K times (its
    scatter-add visits the sorted picks in order and accumulates in f32),
    with no atomics.  On CUDA that scatter-add adds with atomics, in an
    order that changes from run to run."""

    @staticmethod
    def forward(ctx, x, k):
        ctx.k = k
        b, t, d = x.shape
        return x[:, :, None, :].expand(b, t, k, d).reshape(b, t * k, d)

    @staticmethod
    def backward(ctx, g):
        b, tk, d = g.shape
        g = g.reshape(b, tk // ctx.k, ctx.k, d)
        acc = torch.zeros(g[:, :, 0].shape, dtype=torch.float32,
                          device=g.device)
        for j in range(ctx.k):
            acc = acc + g[:, :, j].to(torch.float32)
        return acc.to(g.dtype), None


def moe_verbose(params, x: torch.Tensor, cfg: ModelConfig):
    """Top-k routed MoE with per-row sort-based capacity dispatch (port of
    the JAX package's single-device path).  Each batch row dispatches its
    own t*K picks: a pick whose rank in its expert reaches the capacity C
    goes to the trash slot and contributes nothing.  Returns (out [b,t,D],
    frac [E], probs_mean [E])."""
    dt = x.dtype
    b, t, D = x.shape
    E, K = cfg.num_experts, cfg.experts_per_token
    r = moe_route(params, x, cfg)
    C, keep, slot = r["C"], r["keep"], r["slot"]
    nk = t * K
    rows = torch.arange(b, device=x.device)[:, None].expand(b, nk)
    # a token's picks ranked by expert: by_e[..., j] is the k of its j-th
    # smallest expert, rank its inverse
    by_e = torch.argsort(r["top_e"], dim=-1)                  # [b, t, K]
    rank = torch.argsort(by_e, dim=-1)
    # each sorted pick reads its token's row from x repeated K times, at
    # the copy of its expert's rank (row t*K + rank): every copy is read
    # once, so the gather's backward adds no two values into one place,
    # and ``_RepeatRows`` sums a token's K gradients in expert order
    pick_row = (torch.arange(t, device=x.device)[:, None] * K
                + rank).reshape(b, nk)
    src = torch.gather(_RepeatRows.apply(x, K), 1,
                       torch.gather(pick_row, 1, r["order"])[..., None]
                       .expand(b, nk, D))
    # the dropped picks all write the trash row E*C, which is cut off:
    # which of them lands there does not matter
    buf = torch.zeros((b, E * C + 1, D), dtype=dt, device=x.device)
    buf = buf.index_put((rows, slot), src)
    buf = buf[:, :-1].reshape(b, E, C, D)
    act = silu if cfg.mlp_kind == "swiglu" else _gelu_tanh
    g = act(torch.einsum("becd,edf->becf", buf, params["w_gate"].to(dt)))
    u = torch.einsum("becd,edf->becf", buf, params["w_up"].to(dt))
    eo = torch.einsum("becf,efd->becd", g * u, params["w_down"].to(dt))
    gathered = eo.reshape(b, E * C, D)
    safe_slot = torch.where(keep, slot, 0)
    picked = torch.gather(gathered, 1, safe_slot[..., None].expand(b, nk, D))
    contrib = torch.where(keep[..., None], picked * r["sw"][..., None],
                          torch.zeros((), dtype=dt, device=x.device))
    # the combine: the JAX package scatter-adds the sorted picks into
    # token space, which adds a token's picks in the sort's order,
    # ascending expert, onto a zero.  Here each pick goes back to its
    # (token, k) place (the inverse of the sort), a token's K picks are
    # ordered by expert, and they are summed in that order, in x's dtype,
    # with no atomics: the scatter-add's 0 + a + b + ... bit for bit (for
    # K = 2 either order gives the same bits)
    inv = torch.argsort(r["order"], dim=-1)
    per_k = torch.gather(contrib, 1, inv[..., None].expand(b, nk, D))
    per_k = torch.gather(per_k.reshape(b, t, K, D), 2,
                         by_e[..., None].expand(b, t, K, D))
    out = torch.zeros((b, t, D), dtype=dt, device=x.device)
    for k in range(K):
        out = out + per_k[:, :, k]
    if cfg.num_shared_experts:
        sh = params["shared"]
        gs = act(x @ sh["w_gate"].to(dt))
        us = x @ sh["w_up"].to(dt)
        out = out + (gs * us) @ sh["w_down"].to(dt)
    return out, r["frac"], r["probs_mean"]


def moe(params, x: torch.Tensor, cfg: ModelConfig):
    """``moe_verbose`` with the statistics contracted to the load-balance
    aux scalar.  Returns (out, aux)."""
    out, frac, probs_mean = moe_verbose(params, x, cfg)
    return out, moe_aux_from_stats(frac, probs_mean)
