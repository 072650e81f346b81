"""Fused decode prologue: RMSNorm + QKV projection + RoPE in one launch.

Port of ``repro/kernels/decode_prologue.py``.  For the decode slot batch
``x [B, 1, D]`` it computes, in the compute dtype of ``x``, exactly what
``layers.apply_norm`` + ``layers._project_qkv`` compute: the RMSNorm of each
row (rounded to the compute dtype), the three projections against the f32
master weights cast to the compute dtype, the QKV biases, and the
half-rotation RoPE of q and k (v is never rotated).

The int8 datapath quantizes the weights per tensor (absmax) outside the
launch, once per call, as the JAX package does; the kernel quantizes each
normed row by its absmax, multiplies at int32 and rescales once.

The CUDA kernel is ``csrc/decode_prologue.cu``; ``prologue_plain`` is its
plain PyTorch version.  ``fused_prologue`` runs the plain version only for
CPU tensors; a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch import _build
from repro_torch.kernels import ops as kops
from repro_torch.kernels.common import int8_dot
from repro_torch.quant.int8 import quantize_int8, quantize_int8_absmax

_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_FN = {}


def _lib():
    if not _FN:
        fn = _build.load("decode_prologue").decode_prologue_launch
        # x, nscale, wq, wk, wv, wscale, bq, bk, bv, pos, q, k, v;
        # B, D, H, Hkv, hd, use_rope; theta, eps; x_bf16, int8; stream
        fn.argtypes = [_VP] * 13 + [_I] * 6 + [_F, _F] + [_I, _I] + [_VP]
        fn.restype = ctypes.c_int
        _FN["launch"] = fn
    return _FN["launch"]


# ---------------------------------------------------------------------------
# Plain PyTorch version (the row math of the JAX package's _prologue_rows*)
# ---------------------------------------------------------------------------

def _rms_rows(x2, nscale, eps: float):
    dtype = x2.dtype
    xf = x2.to(torch.float32)
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * nscale).to(dtype)


def _rope_rows(x3, positions, theta: float):
    """Half-rotation RoPE of [R, H, hd] rows at positions [R]."""
    hd = x3.shape[-1]
    half = hd // 2
    freqs = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                          device=x3.device) / half))
    angles = positions[..., None].to(torch.float32) * freqs
    cos = torch.cos(angles)[:, None, :]
    sin = torch.sin(angles)[:, None, :]
    x1, x2 = torch.chunk(x3.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x3.dtype)


def _finish(q, k, v, biases, positions, *, use_rope, theta, dt):
    if biases is not None:
        bq, bk, bv = biases
        q = q + bq.to(dt)
        k = k + bk.to(dt)
        v = v + bv.to(dt)
    if use_rope:
        q = _rope_rows(q, positions, theta)
        k = _rope_rows(k, positions, theta)
    return q, k, v


def prologue_plain(x2, nscale, wq2, wk2, wv2, biases, positions, *,
                   wscales=None, use_rope: bool, theta: float, eps: float,
                   h: int, hkv: int, hd: int):
    """The kernel's function in plain PyTorch.  ``wscales`` [3] marks the
    int8 datapath (w*2 are then int8 payloads)."""
    dt = x2.dtype
    xn = _rms_rows(x2, nscale, eps)
    if wscales is None:
        q = (xn @ wq2.to(dt)).reshape(-1, h, hd)
        k = (xn @ wk2.to(dt)).reshape(-1, hkv, hd)
        v = (xn @ wv2.to(dt)).reshape(-1, hkv, hd)
    else:
        xf = xn.to(torch.float32)
        amax = torch.amax(torch.abs(xf), dim=-1)
        sx = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
        qx = quantize_int8(xf, sx[:, None])

        def proj(qw, sw, heads):
            acc = int8_dot(qx, qw).to(torch.float32)
            return (acc * (sx[:, None] * sw)).to(dt).reshape(-1, heads, hd)
        q = proj(wq2, wscales[0], h)
        k = proj(wk2, wscales[1], hkv)
        v = proj(wv2, wscales[2], hkv)
    return _finish(q, k, v, biases, positions, use_rope=use_rope,
                   theta=theta, dt=dt)


# ---------------------------------------------------------------------------
# The wrapper
# ---------------------------------------------------------------------------

def fused_prologue(x2, nscale, wq2, wk2, wv2, biases, positions, *,
                   wscales: Optional[torch.Tensor] = None, use_rope: bool,
                   theta: float, eps: float, h: int, hkv: int, hd: int):
    """x2 [B, D] in the compute dtype (f32 or bf16); w*2 [D, heads*hd] f32
    masters, or int8 payloads with ``wscales`` [3] f32; biases None or
    (bq [H,hd], bk, bv [Hkv,hd]) f32; positions [B] int32.
    Returns q [B,H,hd], k [B,Hkv,hd], v [B,Hkv,hd] in the compute dtype."""
    stat = dict(use_rope=use_rope, theta=theta, eps=eps, h=h, hkv=hkv, hd=hd)
    if x2.device.type == "cpu":
        return prologue_plain(x2, nscale, wq2, wk2, wv2, biases, positions,
                              wscales=wscales, **stat)
    return _launch(x2, nscale, wq2, wk2, wv2, biases, positions, wscales,
                   **stat)


fused_prologue.launches = 0


def _launch(x2, nscale, wq2, wk2, wv2, biases, positions, wscales, *,
            use_rope, theta, eps, h, hkv, hd):
    dev = x2.device
    if dev.type != "cuda":
        raise RuntimeError(f"decode_prologue: no kernel for {dev}")
    if x2.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"decode_prologue: compute dtype {x2.dtype}")
    b, d = x2.shape
    int8 = wscales is not None
    wdt = torch.int8 if int8 else torch.float32
    tensors = [x2, nscale, wq2, wk2, wv2, positions]
    if biases is not None:
        tensors += list(biases)
    if int8:
        tensors.append(wscales)
    for t in tensors:
        if t.device != dev or not t.is_contiguous():
            raise ValueError("decode_prologue: operands must be contiguous "
                             f"on {dev}")
    if (wq2.shape != (d, h * hd) or wk2.shape != (d, hkv * hd)
            or wv2.shape != (d, hkv * hd)
            or {wq2.dtype, wk2.dtype, wv2.dtype} != {wdt}):
        raise ValueError("decode_prologue: weight shapes/dtypes do not match")
    if nscale.dtype != torch.float32 or positions.dtype != torch.int32:
        raise TypeError("decode_prologue: nscale f32 and positions int32")
    if biases is not None and any(bb.dtype != torch.float32 for bb in biases):
        raise TypeError("decode_prologue: biases must be f32")
    q = torch.empty((b, h, hd), dtype=x2.dtype, device=dev)
    k = torch.empty((b, hkv, hd), dtype=x2.dtype, device=dev)
    v = torch.empty((b, hkv, hd), dtype=x2.dtype, device=dev)
    bq, bk, bv = (None, None, None) if biases is None else (
        bb.data_ptr() for bb in biases)
    err = _lib()(
        x2.data_ptr(), nscale.data_ptr(), wq2.data_ptr(), wk2.data_ptr(),
        wv2.data_ptr(), wscales.data_ptr() if int8 else None, bq, bk, bv,
        positions.data_ptr(), q.data_ptr(), k.data_ptr(), v.data_ptr(),
        b, d, h, hkv, hd, int(use_rope), float(theta), float(eps),
        int(x2.dtype == torch.bfloat16), int(int8),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "decode_prologue")
    fused_prologue.launches += 1
    return q, k, v


# ---------------------------------------------------------------------------
# Public entry (geometry gates kept from the JAX package)
# ---------------------------------------------------------------------------

def prologue_supported(cfg) -> bool:
    """rmsnorm front, standard GQA/MHA heads (no MLA), aligned head dim."""
    return (cfg.norm_kind == "rmsnorm" and not cfg.use_mla
            and cfg.num_heads > 0 and cfg.head_dim % 8 == 0
            and cfg.d_model % 8 == 0)


def prologue_active(cfg, x) -> bool:
    """Supported geometry, a kernel backend installed, one token per row."""
    return (prologue_supported(cfg) and kops.current_backend() != "off"
            and x.shape[1] == 1)


def decode_prologue(norm_params, attn_params, x, cfg, positions):
    """Fused RMSNorm + QKV + RoPE for one decode token per slot.

    x: [B, 1, D]; positions: [B] int32.  Returns (q [B,1,H,hd],
    k [B,1,Hkv,hd], v [B,1,Hkv,hd]).
    """
    b, t, d = x.shape
    if t != 1:
        raise ValueError(f"decode_prologue takes one token per row: {x.shape}")
    wq, wk, wv = attn_params["wq"], attn_params["wk"], attn_params["wv"]
    _, h, hd = wq.shape
    hkv = wk.shape[1]
    wq2 = wq.reshape(d, h * hd)
    wk2 = wk.reshape(d, hkv * hd)
    wv2 = wv.reshape(d, hkv * hd)
    nscale = norm_params["scale"]
    biases = None
    if cfg.qkv_bias:
        biases = (attn_params["bq"], attn_params["bk"], attn_params["bv"])
    stat = dict(use_rope=bool(cfg.use_rope), theta=float(cfg.rope_theta),
                eps=float(cfg.norm_eps), h=h, hkv=hkv, hd=hd)
    wscales = None
    if kops.current_backend() == "int8":
        # per-tensor weight quantization, once per call, outside the kernel
        (wq2, swq), (wk2, swk), (wv2, swv) = (
            quantize_int8_absmax(w) for w in (wq2, wk2, wv2))
        wscales = torch.stack([swq, swk, swv])
    q, k, v = fused_prologue(x[:, 0, :].contiguous(), nscale, wq2, wk2, wv2,
                             biases, positions.to(torch.int32),
                             wscales=wscales, **stat)
    return q[:, None], k[:, None], v[:, None]
