"""Dense-family layers (port of the dense subset of ``models/layers.py``):
norms, RoPE, the kernel-datapath dense unit with its backward, full-sequence
GQA attention (materialised or chunked online softmax), the attention
projections that serving uses, the MLP, and the contiguous KV cache's
ring buffer with its one-token decode attention.

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
