"""Block-scaled int8 format for the kernel datapath (port of ``quant/int8.py``).

A fixed-point ``(I, F)`` format with bitwidth ``I + F + 1 <= 8`` embeds
exactly: the int8 payload is the fixed-point integer and the scale is the
format's resolution ``2^-F``.  A wider format keeps its 8 most significant
bits (``shift`` low fractional bits dropped).  Dynamic per-tensor scaling is
absmax/127.

Rounding is ``torch.round``, which rounds half to even like ``jnp.round``;
the int8 payloads match the JAX package bit for bit, ties included.
``fxp_int8_scale`` and ``fxp_int8_bounds`` take bits as Python ints or
tensors (the JAX package's traced bits).  The per-tile container
``BlockScaledInt8`` (``quantize_int8_tiles``) applies the absmax rule of
``quant.compression`` to 2D tiles, each widened from the (I,F) format's
scale only where its absmax overflows the format: a tile of dW in this
format is byte-compatible with ``dist.collectives.compressed_psum``'s wire
format.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.quant.fixed_point import _int32
from repro_torch.quant.fixed_point import _pow2_int as _pow2_bits

INT8_BITS = 8
TILE = (128, 128)  # default storage tile


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


def fxp_int8_scale(i_bits, f_bits) -> torch.Tensor:
    """The (I,F)-derived int8 scale 2^(shift-F), from int or tensor bits."""
    total = _int32(i_bits) + _int32(f_bits)
    shift = torch.clamp_min(total + 1 - INT8_BITS, 0)
    return _pow2_bits(shift) / _pow2_bits(_int32(f_bits))


def fxp_int8_bounds(i_bits, f_bits) -> tuple[torch.Tensor, torch.Tensor]:
    """(qmin, qmax) of the int8 embedding, from int or tensor bits (f32)."""
    total = _int32(i_bits) + _int32(f_bits)
    shift = torch.clamp_min(total + 1 - INT8_BITS, 0)
    mag = _pow2_bits(total - shift)
    return -mag, mag - 1.0


def absmax_scale(x: torch.Tensor, reduce=None) -> torch.Tensor:
    """Per-tensor dynamic scale absmax/127 (f32 scalar, zero-safe).
    ``reduce`` maps the local absmax to the logical tensor's where ``x`` is
    one rank's shard of it (the MAX over the shards' group), so that every
    shard's payload is the logical payload's slice."""
    m = torch.amax(torch.abs(x.to(torch.float32)))
    if reduce is not None:
        m = reduce(m)
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


def quantize_int8_absmax(x: torch.Tensor, reduce=None
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Quantize with a per-tensor dynamic absmax scale -> (payload, scale);
    ``reduce`` as in ``absmax_scale``."""
    scale = absmax_scale(x, reduce)
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


# ---------------------------------------------------------------------------
# Per-tile storage container (the dW wire format, 2D-tiled)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BlockScaledInt8:
    """A 2D array stored as int8 tiles with one f32 scale per tile."""

    payload: torch.Tensor   # int8, padded to a multiple of the tile
    scales: torch.Tensor    # f32 [tiles_r, tiles_c]
    shape: tuple            # original (unpadded) shape
    tile: tuple             # (tr, tc)

    def dequantize(self, dtype=torch.float32) -> torch.Tensor:
        tr, tc = self.tile
        s = torch.repeat_interleave(
            torch.repeat_interleave(self.scales, tr, dim=0), tc, dim=1)
        x = self.payload.to(torch.float32) * s
        return x[:self.shape[0], :self.shape[1]].to(dtype)


def quantize_int8_tiles(x: torch.Tensor, i_bits: Optional[int] = None,
                        f_bits: Optional[int] = None,
                        tile: tuple = TILE) -> BlockScaledInt8:
    """Tile-quantize a 2D array.

    With ``(i_bits, f_bits)`` given, every tile starts from the format's
    int8 scale and widens (per tile) only where the tile's absmax overflows
    the format range; without bits the scale is per-tile absmax/127 (the
    ``compression.compress_int8`` rule applied to 2D tiles).
    """
    if x.dim() != 2:
        raise ValueError(f"quantize_int8_tiles: a 2D array, got "
                         f"{tuple(x.shape)}")
    tr, tc = tile
    r, c = x.shape
    pr, pc = (-r) % tr, (-c) % tc
    xf = torch.nn.functional.pad(x.to(torch.float32), (0, pc, 0, pr))
    nr, nc = xf.shape[0] // tr, xf.shape[1] // tc
    tiles = xf.reshape(nr, tr, nc, tc).permute(0, 2, 1, 3)  # [nr,nc,tr,tc]
    absmax = torch.amax(torch.abs(tiles), dim=(2, 3))
    dyn = torch.where(absmax > 0, absmax / torch.full_like(absmax, 127.0),
                      torch.ones_like(absmax))
    if i_bits is not None and f_bits is not None:
        base = fxp_int8_scale(i_bits, f_bits).to(dyn.device)
        scales = torch.maximum(dyn, base)  # widen only overflowing tiles
    else:
        scales = dyn
    q = torch.clamp(torch.round(tiles / scales[:, :, None, None]), -127, 127)
    payload = q.permute(0, 2, 1, 3).reshape(xf.shape).to(torch.int8)
    return BlockScaledInt8(payload=payload, scales=scales, shape=(r, c),
                           tile=(tr, tc))
