"""Gradient compression codec for cross-replica reduction (port of
``quant/compression.py``).

TaxoNN moves fewer bits per MAC; across replicas the scarce resource is
the interconnect's bytes, spent on the per-layer dW all-reduce.  The int8
block-scaled codec (4x fewer bytes than f32, 2x fewer than bf16) is the
wire format of ``dist.collectives.compressed_psum``.

The codec is deterministic and shape-preserving:
  compress:   f32[N] -> (int8[N], f32[N/B] scales)
  decompress: the payload times its block's scale.

It is elementwise and bitwise the JAX package's: ``torch.round`` rounds
half to even as ``jnp.round`` does, and the scale is ``absmax / 127``
rounded once (a division by a tensor: PyTorch's CUDA division by a Python
number multiplies by its reciprocal), with 1 for an all-zero block.
"""
from __future__ import annotations

import torch

BLOCK = 256  # elements per scale block; 1 f32 scale per 256 int8 payloads


def _pad_to_block(x: torch.Tensor) -> tuple[torch.Tensor, int]:
    n = x.numel()
    flat = x.reshape(-1)
    pad = (-n) % BLOCK
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat, n


def compress_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Block-scaled int8 quantization. Returns (payload int8, scales f32)."""
    flat, _ = _pad_to_block(x.to(torch.float32))
    blocks = flat.reshape(-1, BLOCK)
    absmax = torch.amax(torch.abs(blocks), dim=1, keepdim=True)
    scale = torch.where(absmax > 0,
                        absmax / torch.full_like(absmax, 127.0),
                        torch.ones_like(absmax))
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q.reshape(-1), scale.reshape(-1)


def decompress_int8(payload: torch.Tensor, scales: torch.Tensor, shape,
                    dtype=torch.float32) -> torch.Tensor:
    blocks = payload.reshape(-1, BLOCK).to(torch.float32)
    x = blocks * scales.reshape(-1, 1)
    n = 1
    for d in shape:
        n *= d
    return x.reshape(-1)[:n].reshape(tuple(shape)).to(dtype)


def quantized_allreduce_bytes(num_elements: int, dtype_bytes: int = 4) -> dict:
    """Napkin accounting of collective bytes: dense vs int8-compressed."""
    dense = num_elements * dtype_bytes
    comp = num_elements * 1 + (num_elements // BLOCK + 1) * 4
    return {
        "dense_bytes": dense,
        "compressed_bytes": comp,
        "reduction": dense / comp,
    }
