"""Mamba2 / SSD (state-space duality) blocks (port of ``models/ssm.py``).

The chunked SSD algorithm: the intra-chunk work is dense tensor products,
the inter-chunk recurrence a short loop over the T/Q chunk states (JAX's
``xscan`` becomes a Python loop, as everywhere in the port).

  h_t = exp(dt_t * A) h_{t-1} + dt_t * B_t x_t^T        (per head, A scalar)
  y_t = C_t . h_t + D_skip * x_t

Shapes: x [B,T,H,P] (P = head dim), B,C [B,T,N] (single group), dt [B,T,H].

The functions reproduce the JAX package's op for op, with its casts:
``xdt`` and the intra-chunk scores go back to x's dtype where JAX casts
them, the segment sum is JAX's cumsum difference with a -inf mask, and the
depthwise causal conv is its unrolled shift sum (not ``conv1d``).  Every
projection is a plain product outside any kernel, as in JAX, so the Mamba
path launches no kernel.  ``mamba_decode`` writes the cache it is given IN
PLACE: ``h`` stays f32, ``conv`` is cast to the cache's dtype (an int8
cache truncates, as JAX's cast does).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import _rand, _randn, rmsnorm, silu


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(x, 0) = max(x, 0) + log1p(exp(-|x|)),
    with no threshold (``F.softplus`` returns x above 20)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def init_mamba(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """Component-wise projections, drawn from ``gen`` on its device: the
    JAX package's shapes and distributions, not its random bits.
    ``dt_bias`` is the inverse softplus of a dt log-uniform in [1e-3,
    1e-1]; ``A_log = log(1..H)``; ``D_skip = 1``."""
    D, di, N, H = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    K, dev = cfg.conv_kernel, gen.device
    s = D ** -0.5
    u = _rand(gen, (H,))
    lo, hi = math.log(1e-3), math.log(0.1)
    dt0 = torch.exp(u * (hi - lo) + lo)
    dt_bias = dt0 + torch.log(-torch.expm1(-dt0))  # inverse softplus
    return {
        "w_z": _randn(gen, (D, di), s),
        "w_x": _randn(gen, (D, di), s),
        "w_B": _randn(gen, (D, N), s),
        "w_C": _randn(gen, (D, N), s),
        "w_dt": _randn(gen, (D, H), s),
        "conv_x": _randn(gen, (K, di), di ** -0.5),
        "conv_B": _randn(gen, (K, N), N ** -0.5),
        "conv_C": _randn(gen, (K, N), N ** -0.5),
        "conv_b_x": torch.zeros((di,), dtype=torch.float32, device=dev),
        "conv_b_B": torch.zeros((N,), dtype=torch.float32, device=dev),
        "conv_b_C": torch.zeros((N,), dtype=torch.float32, device=dev),
        "dt_bias": dt_bias,
        "A_log": torch.log(torch.arange(1, H + 1, dtype=torch.float32,
                                        device=dev)),
        "D_skip": torch.ones((H,), dtype=torch.float32, device=dev),
        "gate_norm": {"scale": torch.ones((di,), dtype=torch.float32,
                                          device=dev)},
        "out_proj": _randn(gen, (di, D), di ** -0.5),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over time. x: [B,T,C]; w: [K,C]."""
    k, t = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, k - 1, 0))
    out = torch.zeros_like(x)
    for i in range(k):
        out = out + pad[:, i:i + t, :] * w[i]
    return out + b


def _segsum(dA: torch.Tensor) -> torch.Tensor:
    """out[..., i, j] = sum_{k=j+1..i} dA[..., k] (i >= j) as a difference
    of cumulative sums, -inf below the causal diagonal.  dA: [..., Q]."""
    q = dA.shape[-1]
    cs = torch.cumsum(dA, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    idx = torch.arange(q, device=dA.device)
    mask = idx[:, None] >= idx[None, :]
    return torch.where(mask, diff, torch.full((), -math.inf,
                                              dtype=diff.dtype,
                                              device=diff.device))


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                B: torch.Tensor, C: torch.Tensor, chunk: int,
                h0: Optional[torch.Tensor] = None):
    """Chunked SSD. x: [B,T,H,P]; dt: [B,T,H] f32; A: [H]; B,C: [B,T,N].

    Chunks of ``min(chunk, T)``; a ragged T is padded with dt = 0 (decay
    exp(0) = 1 and zero input: state-neutral).  Returns (y [B,T,H,P] in
    x's dtype, h_final [B,H,N,P] f32).
    """
    b, t_orig, h, p = x.shape
    n = B.shape[-1]
    q = min(chunk, t_orig)
    pad = (-t_orig) % q
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, pad))
    t = t_orig + pad
    nc = t // q

    dA = dt * A                                           # [B,T,H] f32
    xdt = (x.to(torch.float32) * dt[..., None]).to(x.dtype)
    xc = xdt.reshape(b, nc, q, h, p)
    dAc = dA.reshape(b, nc, q, h)
    Bc, Cc = B.reshape(b, nc, q, n), C.reshape(b, nc, q, n)

    cum = torch.cumsum(dAc, dim=2)                        # [B,nc,Q,H]

    # intra-chunk (dense products)
    Lm = torch.exp(_segsum(dAc.permute(0, 1, 3, 2)))      # [B,nc,H,Q,Q]
    scores = torch.einsum("bcqn,bckn->bcqk", Cc.to(torch.float32),
                          Bc.to(torch.float32))
    scores = scores[:, :, None] * Lm                      # [B,nc,H,Q,Q]
    y_intra = torch.einsum("bchqk,bckhp->bcqhp", scores.to(x.dtype), xc)

    # chunk states
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)     # [B,nc,Q,H]
    S = torch.einsum("bcqn,bcqh,bcqhp->bchnp", Bc,
                     decay_to_end.to(x.dtype), xc)        # [B,nc,H,N,P]

    # inter-chunk recurrence: the state ENTERING each chunk
    chunk_decay = torch.exp(cum[:, :, -1, :])             # [B,nc,H]
    hprev = (torch.zeros((b, h, n, p), dtype=torch.float32, device=x.device)
             if h0 is None else h0.to(torch.float32))
    S32 = S.to(torch.float32)
    h_in = []
    for c in range(nc):
        h_in.append(hprev)
        hprev = hprev * chunk_decay[:, c, :, None, None] + S32[:, c]
    h_in = torch.stack(h_in, dim=1)                       # [B,nc,H,N,P]

    y_inter = torch.einsum("bcqn,bcqh,bchnp->bcqhp", Cc,
                           torch.exp(cum).to(x.dtype), h_in.to(x.dtype))
    y = (y_intra + y_inter).reshape(b, t, h, p).to(x.dtype)
    return y[:, :t_orig], hprev


def _split_proj(params, xin: torch.Tensor):
    dt_ = xin.dtype
    return tuple(xin @ params[k].to(dt_)
                 for k in ("w_z", "w_x", "w_B", "w_C", "w_dt"))


def mamba_forward(params, xin: torch.Tensor, cfg: ModelConfig,
                  h0: Optional[torch.Tensor] = None,
                  conv0: Optional[torch.Tensor] = None):
    """Full-sequence Mamba2 block (the caller owns the residual and norm).

    xin: [B, T, D] (already normed).  Returns (out [B,T,D], (h_final,
    conv_tail)): conv_tail packs the last K-1 pre-conv values of [x | B |
    C] on the channel axis (width d_inner + 2N) for decode.
    """
    dt_ = xin.dtype
    b, t, _ = xin.shape
    di, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    z, xr, Br, Cr, dt_raw = _split_proj(params, xin)

    def conv(v, w, bias, c0):
        if c0 is not None:
            ext = torch.cat([c0.to(dt_), v], dim=1)
            return _causal_conv(ext, w.to(dt_),
                                bias.to(dt_))[:, c0.shape[1]:]
        return _causal_conv(v, w.to(dt_), bias.to(dt_))

    c0x = c0B = c0C = None
    if conv0 is not None:
        c0x, c0B, c0C = (conv0[..., :di], conv0[..., di:di + N],
                         conv0[..., di + N:])
    xs = silu(conv(xr, params["conv_x"], params["conv_b_x"], c0x))
    Bm = silu(conv(Br, params["conv_B"], params["conv_b_B"], c0B))
    Cm = silu(conv(Cr, params["conv_C"], params["conv_b_C"], c0C))

    dt = softplus(dt_raw.to(torch.float32) + params["dt_bias"])
    A = -torch.exp(params["A_log"])                       # [H]

    x_heads = xs.reshape(b, t, H, P)
    y, hT = ssd_chunked(x_heads, dt, A, Bm, Cm, cfg.ssm_chunk, h0)
    y = y + x_heads * params["D_skip"].to(dt_)[None, None, :, None]
    y = y.reshape(b, t, di)
    y = rmsnorm(params["gate_norm"], y * silu(z), cfg.norm_eps)
    out = y @ params["out_proj"].to(dt_)
    k = cfg.conv_kernel - 1
    conv_tail = torch.cat([xr[:, -k:, :], Br[:, -k:, :], Cr[:, -k:, :]],
                          dim=-1)
    return out, (hT, conv_tail)


def init_mamba_cache(cfg: ModelConfig, batch: int, dtype=torch.float32,
                     device=None) -> dict:
    """One layer's zeroed decode state: ``h`` [B,H,N,P] f32 whatever the
    cache dtype, ``conv`` [B,K-1,d_inner+2N] in ``dtype``."""
    return {
        "h": torch.zeros((batch, cfg.ssm_heads, cfg.ssm_state,
                          cfg.ssm_head_dim), dtype=torch.float32,
                         device=device),
        "conv": torch.zeros((batch, cfg.conv_kernel - 1,
                             cfg.d_inner + 2 * cfg.ssm_state), dtype=dtype,
                            device=device),
    }


def mamba_decode(params, xin: torch.Tensor, cfg: ModelConfig, cache: dict):
    """One-token Mamba2 step, O(1) in the context. xin: [B, 1, D].

    Returns (out [B,1,D], cache), the cache's ``h`` and ``conv`` written in
    place (``conv`` keeps ``conv_buf[:, 1:]``, cast to its dtype)."""
    dt_ = xin.dtype
    b = xin.shape[0]
    di, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    z, xr, Br, Cr, dt_raw = _split_proj(params, xin)

    xbc = torch.cat([xr, Br, Cr], dim=-1)                 # [B,1,di+2N]
    conv_buf = torch.cat([cache["conv"].to(dt_), xbc], dim=1)
    w = torch.cat([params["conv_x"], params["conv_B"],
                   params["conv_C"]], dim=-1).to(dt_)
    bias = torch.cat([params["conv_b_x"], params["conv_b_B"],
                      params["conv_b_C"]]).to(dt_)
    conv_out = torch.einsum("bkc,kc->bc", conv_buf, w) + bias
    xbc_act = silu(conv_out)[:, None, :]
    xs, Bm, Cm = torch.split(xbc_act, [di, N, N], dim=-1)

    dt = softplus(dt_raw.to(torch.float32) + params["dt_bias"])[:, 0]
    A = -torch.exp(params["A_log"])
    dA = torch.exp(dt * A)                                # [B,H]

    x_heads = xs.reshape(b, H, P).to(torch.float32)
    Bv = Bm[:, 0].to(torch.float32)                       # [B,N]
    Cv = Cm[:, 0].to(torch.float32)
    hx = cache["h"] * dA[..., None, None] + torch.einsum(
        "bn,bh,bhp->bhnp", Bv, dt, x_heads)
    y = torch.einsum("bn,bhnp->bhp", Cv, hx).to(dt_)
    y = y + x_heads.to(dt_) * params["D_skip"].to(dt_)[None, :, None]
    y = y.reshape(b, 1, di)
    y = rmsnorm(params["gate_norm"], y * silu(z), cfg.norm_eps)
    out = y @ params["out_proj"].to(dt_)
    cache["h"].copy_(hx)
    cache["conv"].copy_(conv_buf[:, 1:, :].to(cache["conv"].dtype))
    return out, cache
