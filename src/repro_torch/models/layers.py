"""Dense-family layers for serving (port of the dense subset of
``models/layers.py``): norms, RoPE, the forward of the kernel-datapath dense
unit, GQA attention projections and the MLP.

Parameters are nested dicts of tensors in the JAX package's layout (``wq``
[D, H, hd], ``wo`` [H, hd, D], ...).  Initializers draw from an explicit
``torch.Generator`` on the target device; they match the JAX package's
shapes and distributions, not its random bits.  Serving needs no gradient,
so the dense unit is forward only here.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ops as kops
from repro_torch.kernels.common import act_fn
from repro_torch.models.config import ModelConfig

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
# The kernel-datapath dense unit (forward)
# ---------------------------------------------------------------------------

def dense_unit(x: torch.Tensor, w: torch.Tensor, act: str = "identity",
               backend: Optional[str] = None) -> torch.Tensor:
    """act(x @ w) on the active kernel datapath. x: [..., K]; w: [K, N]."""
    backend = backend or kops.current_backend()
    if backend == "off":
        return act_fn((x @ w.to(x.dtype)).to(torch.float32),
                      act).to(x.dtype)
    shape = x.shape
    z = kops.dense_fwd(x.reshape(-1, shape[-1]), w, backend)   # f32 [M, N]
    return act_fn(z, act).to(x.dtype).reshape(shape[:-1] + (w.shape[1],))


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
        act = (torch.nn.functional.silu if cfg.mlp_kind == "swiglu"
               else _gelu_tanh)
        g = act(x @ params["w_gate"].to(dt))
        u = x @ params["w_up"].to(dt)
        return (g * u) @ params["w_down"].to(dt)
    h = _gelu_tanh(x @ params["w_up"].to(dt))
    return h @ params["w_down"].to(dt)
