"""Block-scaled int8 format for the kernel datapath (port of ``quant/int8.py``).

A fixed-point ``(I, F)`` format with bitwidth ``I + F + 1 <= 8`` embeds
exactly: the int8 payload is the fixed-point integer and the scale is the
format's resolution ``2^-F``.  A wider format keeps its 8 most significant
bits (``shift`` low fractional bits dropped).  Dynamic per-tensor scaling is
absmax/127.

Rounding is ``torch.round``, which rounds half to even like ``jnp.round``;
the int8 payloads match the JAX package bit for bit, ties included.
Only static (Python-int) bits are ported; the traced-bits helpers come with
the training slice.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

INT8_BITS = 8


def _pow2_int(bits: int) -> torch.Tensor:
    """Exact 2^bits as a float32 scalar via an integer shift (the JAX
    package's ``quant.fixed_point._pow2_int``; valid for 0 <= bits <= 30)."""
    return torch.tensor(1 << int(bits), dtype=torch.int32).to(torch.float32)


@dataclasses.dataclass(frozen=True)
class Int8Spec:
    """How a static (I,F) format embeds into int8: q = clip(round(x/scale))."""

    scale: float
    qmin: int
    qmax: int
    shift: int  # dropped low fractional bits (0 when bitwidth <= 8)

    @property
    def exact(self) -> bool:
        """True when the int8 grid equals the (I,F) grid (bitwidth <= 8)."""
        return self.shift == 0


def int8_spec(i_bits: int, f_bits: int) -> Int8Spec:
    shift = max(0, i_bits + f_bits + 1 - INT8_BITS)
    mag = 2 ** (i_bits + f_bits - shift)  # <= 2^7
    return Int8Spec(scale=2.0 ** (shift - f_bits), qmin=-mag, qmax=mag - 1,
                    shift=shift)


def absmax_scale(x: torch.Tensor) -> torch.Tensor:
    """Per-tensor dynamic scale absmax/127 (f32 scalar, zero-safe)."""
    m = torch.amax(torch.abs(x.to(torch.float32)))
    return torch.where(m > 0, m / 127.0, torch.ones_like(m))


def quantize_int8(x: torch.Tensor, scale, qmin=-127.0,
                  qmax=127.0) -> torch.Tensor:
    """Round-half-even int8 payload on the grid ``scale * [qmin, qmax]``."""
    q = torch.clamp(torch.round(x.to(torch.float32) / scale), qmin, qmax)
    return q.to(torch.int8)


def quantize_int8_fxp(x: torch.Tensor, i_bits: int, f_bits: int
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Quantize onto the static (I,F)-derived int8 grid -> (payload, scale)."""
    spec = int8_spec(int(i_bits), int(f_bits))
    return (quantize_int8(x, spec.scale, spec.qmin, spec.qmax),
            torch.tensor(spec.scale, dtype=torch.float32, device=x.device))


def quantize_int8_absmax(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Quantize with a per-tensor dynamic absmax scale -> (payload, scale)."""
    scale = absmax_scale(x)
    return quantize_int8(x, scale), scale


def transport_bits(bits: Optional[tuple]) -> Optional[tuple]:
    """Keep the (I,F) grid when it embeds exactly (bitwidth <= 8); wider
    formats travel with absmax scaling instead (None)."""
    if bits is None:
        return None
    i_bits, f_bits = bits
    return bits if i_bits + f_bits + 1 <= INT8_BITS else None


def quantize_int8_auto(x: torch.Tensor, bits: Optional[tuple]
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """The (I,F) grid when it embeds exactly, per-tensor absmax otherwise."""
    bits = transport_bits(bits)
    if bits is None:
        return quantize_int8_absmax(x)
    return quantize_int8_fxp(x, *bits)


def dequantize_int8(q: torch.Tensor, scale,
                    dtype=torch.float32) -> torch.Tensor:
    return (q.to(torch.float32) * scale).to(dtype)
