"""Shared plain-PyTorch helpers of the kernels (port of ``kernels/common.py``).

``kq`` is the in-kernel fixed-point round (round half to even, saturating);
``act_fn``/``act_deriv`` are the paper's activation and derivation units;
``int8_dot`` is the exact int8 x int8 -> int32 product.  The TPU's two-slot
DMA helper ``db_step`` has no counterpart here: on Hopper, overlap of copies
with compute lives inside each CUDA kernel.
"""
from __future__ import annotations

import torch


def kq(x: torch.Tensor, i_bits: int, f_bits: int) -> torch.Tensor:
    """Round-to-nearest-even fixed-point quantize with saturation."""
    step = 2.0 ** (-f_bits)
    qmax = 2.0 ** (i_bits + f_bits) - 1
    qmin = -(2.0 ** (i_bits + f_bits))
    k = torch.clamp(torch.round(x.to(torch.float32) / step), qmin, qmax)
    return k * step


def maybe_kq(x: torch.Tensor, bits) -> torch.Tensor:
    """kq with ``bits=None`` meaning passthrough (unquantized datapath)."""
    return x if bits is None else kq(x, *bits)


def int8_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact int8 [M,K] x int8 [K,N] -> int32 [M,N].

    On the CPU the operands are widened to int32 before the product (an
    int8 matmul would wrap).  CUDA has no integer matmul, so there the
    product runs in float64, which is exact: |sum| <= 127^2 * K < 2^53.
    """
    if a.device.type == "cpu":
        return a.to(torch.int32) @ b.to(torch.int32)
    return (a.to(torch.float64) @ b.to(torch.float64)).to(torch.int32)


_GELU_C = 0.7978845608028654  # sqrt(2/pi)
_GELU_A = 0.044715

# activation name -> the integer code the CUDA kernels take
ACT_CODES = {"identity": 0, "relu": 1, "sigmoid": 2, "tanh": 3, "silu": 4,
             "gelu": 5}


def act_fn(z: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "relu":
        return torch.clamp_min(z, 0.0)
    if kind == "sigmoid":
        return 1.0 / (1.0 + torch.exp(-z))
    if kind == "tanh":
        return torch.tanh(z)
    if kind == "silu":
        return z / (1.0 + torch.exp(-z))
    if kind == "gelu":  # tanh approximation
        return 0.5 * z * (1.0 + torch.tanh(_GELU_C * (z + _GELU_A * z * z * z)))
    if kind == "identity":
        return z
    raise ValueError(kind)


def act_deriv(z: torch.Tensor, kind: str) -> torch.Tensor:
    """The derivation unit f'(z) from the pre-activation."""
    if kind == "relu":
        return (z > 0).to(torch.float32)
    if kind == "sigmoid":
        s = 1.0 / (1.0 + torch.exp(-z))
        return s * (1.0 - s)
    if kind == "tanh":
        t = torch.tanh(z)
        return 1.0 - t * t
    if kind == "silu":
        s = 1.0 / (1.0 + torch.exp(-z))
        return s * (1.0 + z * (1.0 - s))
    if kind == "gelu":
        u = _GELU_C * (z + _GELU_A * z * z * z)
        t = torch.tanh(u)
        du = _GELU_C * (1.0 + 3.0 * _GELU_A * z * z)
        return 0.5 * (1.0 + t) + 0.5 * z * (1.0 - t * t) * du
    if kind == "identity":
        return torch.ones_like(z)
    raise ValueError(kind)
