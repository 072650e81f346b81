"""Fixed-point (I,F) emulation with straight-through estimators (port of
``quant/fixed_point.py``).

A TaxoNN number format ``(I, F)`` is a signed fixed-point format with ``I``
integer bits and ``F`` fractional bits (bitwidth ``I + F + 1`` including
sign).  Representable values are ``k * 2^-F`` for integer
``k in [-2^(I+F), 2^(I+F) - 1]``.

The quantizers take ``I`` and ``F`` as tensors (int32 scalars or arrays),
so per-layer bit schedules are runtime data: one train step serves every
schedule, as one TaxoNN chip serves every (I,F) configuration loaded into
its registers.

Randomness: the stochastic quantizers take either a PRNG key, from which
they draw JAX's own threefry noise (``util.prng``: the same key gives the
same bits as ``jax.random``), or the uniform noise ``u`` itself (the shape
of ``x``, in [0, 1)).
"""
from __future__ import annotations

import dataclasses
from typing import Union

import numpy as np
import torch

from repro_torch.util import prng

IntLike = Union[int, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class QFormat:
    """Static description of a fixed-point format (for configs / docs)."""

    i_bits: int
    f_bits: int

    @property
    def bitwidth(self) -> int:
        return self.i_bits + self.f_bits + 1

    @property
    def resolution(self) -> float:
        return 2.0 ** (-self.f_bits)

    @property
    def max_value(self) -> float:
        return (2.0 ** (self.i_bits + self.f_bits) - 1) * self.resolution

    def __repr__(self) -> str:  # the paper's "(I,F)" notation
        return f"({self.i_bits},{self.f_bits})"


def _int32(bits: IntLike, device=None) -> torch.Tensor:
    return torch.as_tensor(bits, dtype=torch.int32, device=device)


def _pow2_int(bits: IntLike) -> torch.Tensor:
    """Exact 2^bits as float32 by an integer shift (valid for
    0 <= bits <= 30; TaxoNN formats are <= 21 bits)."""
    b = _int32(bits)
    return torch.bitwise_left_shift(torch.ones_like(b), b).to(torch.float32)


def fxp_resolution(f_bits: IntLike) -> torch.Tensor:
    """Quantization step 2^-F, exact for tensor F."""
    return 1.0 / _pow2_int(f_bits)


def fxp_max(i_bits: IntLike, f_bits: IntLike) -> torch.Tensor:
    """Largest representable magnitude (positive side) of (I,F)."""
    total = _int32(i_bits) + _int32(f_bits)
    return (_pow2_int(total) - 1.0) * fxp_resolution(f_bits)


def _grid(x: torch.Tensor, i_bits, f_bits):
    """(step, qmin, qmax) of (I,F) in ``x``'s dtype, on ``x``'s device."""
    i, f = _int32(i_bits, x.device), _int32(f_bits, x.device)
    step = fxp_resolution(f).to(x.dtype)
    p = _pow2_int(i + f)
    return step, (-p).to(x.dtype), (p - 1.0).to(x.dtype)


def _quantize_value(x: torch.Tensor, i_bits, f_bits) -> torch.Tensor:
    """Round-to-nearest-even fixed-point quantization (value, no STE)."""
    step, qmin, qmax = _grid(x, i_bits, f_bits)
    return torch.clamp(torch.round(x / step), qmin, qmax) * step


def quantize(x: torch.Tensor, i_bits: IntLike, f_bits: IntLike
             ) -> torch.Tensor:
    """Quantize ``x`` to the (I,F) grid (no gradient definition)."""
    return _quantize_value(x, i_bits, f_bits)


def _ste_mask(x, i_bits, f_bits) -> torch.Tensor:
    bound = fxp_max(_int32(i_bits, x.device), _int32(f_bits, x.device))
    return torch.abs(x) <= bound.to(x.dtype)


class _QuantizeSTE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, i_bits, f_bits):
        ctx.save_for_backward(_ste_mask(x, i_bits, f_bits))
        return _quantize_value(x, i_bits, f_bits)

    @staticmethod
    def backward(ctx, g):
        (mask,) = ctx.saved_tensors
        return g * mask.to(g.dtype), None, None


def quantize_ste(x: torch.Tensor, i_bits, f_bits) -> torch.Tensor:
    """Quantize with a straight-through estimator.

    Forward: round-to-nearest-even onto the (I,F) grid with saturation.
    Backward: identity inside the representable range, zero outside
    (saturated values carry no gradient, as hardware clipping).
    """
    return _QuantizeSTE.apply(x, _int32(i_bits, x.device),
                              _int32(f_bits, x.device))


def _stochastic_value(x, i_bits, f_bits, u) -> torch.Tensor:
    step, qmin, qmax = _grid(x, i_bits, f_bits)
    scaled = x / step
    floor = torch.floor(scaled)
    frac = scaled - floor
    k = floor + (u.to(x.dtype) < frac).to(x.dtype)
    return torch.clamp(k, qmin, qmax) * step


def _is_noise(noise) -> bool:
    """A floating tensor is the uniform draw itself; anything else a key."""
    return isinstance(noise, torch.Tensor) and noise.is_floating_point()


def _require_f32(x: torch.Tensor):
    """JAX draws the noise in ``x``'s dtype; the port draws f32 only."""
    if x.dtype != torch.float32:
        raise TypeError(f"a keyed stochastic rounding draws f32 noise; cast "
                        f"x ({x.dtype}) to float32 first, as the engine does")


class _QuantizeStochastic(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, i_bits, f_bits, u):
        ctx.save_for_backward(_ste_mask(x, i_bits, f_bits))
        return _stochastic_value(x, i_bits, f_bits, u)

    @staticmethod
    def backward(ctx, g):
        (mask,) = ctx.saved_tensors
        return g * mask.to(g.dtype), None, None, None


def quantize_stochastic(x: torch.Tensor, i_bits, f_bits,
                        noise) -> torch.Tensor:
    """Stochastically rounded quantization with an STE backward: ``k`` is
    ``floor(x / 2^-F)``, plus one where ``u`` is below the fraction, so
    E[q(x)] = x for in-range x.  ``noise``: a PRNG key (``util.prng``),
    from which ``u = uniform(key, x.shape)`` is drawn as
    ``jax.random.uniform`` draws it, or ``u`` itself (floating, of
    ``x``'s shape)."""
    if not _is_noise(noise):
        _require_f32(x)
        noise = prng.uniform(noise, x.shape, device=x.device)
    return _QuantizeStochastic.apply(x, _int32(i_bits, x.device),
                                     _int32(f_bits, x.device), noise)


def stochastic_round_batched(x: torch.Tensor, i_bits, f_bits, noise,
                             offset=0) -> torch.Tensor:
    """Stochastic rounding, value only, with noise drawn per row of the
    leading axis: with a key, row ``b`` draws from ``fold_in(key, offset +
    b)`` (``util.prng.uniform_rows``), as the JAX package does, so a slice
    of the rows with its global ``offset`` reproduces the full batch's
    draws.  ``noise`` may instead be those draws, row by row (floating,
    ``x``'s shape; ``offset`` unused)."""
    if not _is_noise(noise):
        _require_f32(x)
        noise = prng.uniform_rows(noise, x.shape, offset, device=x.device)
    return _stochastic_value(x, i_bits, f_bits, noise)


# ---------------------------------------------------------------------------
# Per-layer bit schedules
# ---------------------------------------------------------------------------

_FIELDS = ("w_i", "w_f", "a_i", "a_f", "g_i", "g_f")


@dataclasses.dataclass(frozen=True)
class BitSchedule:
    """Per-layer (I,F) bitwidths for the three tensor classes the paper
    quantizes: weights, activations (the cached X_i) and gradients (G, dW).

    Each field is an int32 tensor of shape [num_layers]; ``enabled`` is an
    f32 scalar tensor (1.0 = quantize, 0.0 = passthrough) that turns
    quantization off without another step object.
    """

    w_i: torch.Tensor
    w_f: torch.Tensor
    a_i: torch.Tensor
    a_f: torch.Tensor
    g_i: torch.Tensor
    g_f: torch.Tensor
    enabled: torch.Tensor

    @property
    def num_layers(self) -> int:
        return int(self.w_i.shape[0])

    def layer(self, idx) -> "BitSchedule":
        """One layer's bitwidths."""
        return BitSchedule(**{k: getattr(self, k)[idx] for k in _FIELDS},
                           enabled=self.enabled)

    def to(self, device) -> "BitSchedule":
        return BitSchedule(**{k: getattr(self, k).to(device)
                              for k in _FIELDS + ("enabled",)})


def _schedule(w: tuple, a: tuple, g: tuple, enabled: bool) -> BitSchedule:
    """A schedule from per-layer (I, F) lists of weights, acts and grads."""
    t = [torch.as_tensor(np.asarray(v, np.int32)) for v in (*w, *a, *g)]
    return BitSchedule(*t, enabled=torch.tensor(1.0 if enabled else 0.0))


def make_bit_schedule(num_layers: int, weight: tuple = (2, 12),
                      act: tuple = (4, 10), grad: tuple = (2, 12), *,
                      ramp: bool = True, enabled: bool = True
                      ) -> BitSchedule:
    """A per-layer schedule.  ``ramp=True`` applies the paper's observation
    that later layers need more fractional bits: F ramps by +2 over the
    final quarter of the stack, and the last layer gets +1 integer bit
    (the (3,10) / (4,12) tails of Table I)."""

    def per_layer(base_i, base_f):
        i = np.full((num_layers,), base_i, np.int32)
        f = np.full((num_layers,), base_f, np.int32)
        if ramp and num_layers > 1:
            tail = max(1, num_layers // 4)
            f[-tail:] += 2
            i[-1] += 1
        return i, f

    return _schedule(per_layer(*weight), per_layer(*act), per_layer(*grad),
                     enabled)


def schedule_from_formats(formats, *, enabled: bool = True) -> BitSchedule:
    """A schedule from an explicit per-layer list of (I, F) tuples; all
    three tensor classes share the layer's format (as ``paper_schedule``
    and Table I do)."""
    fmt = ([int(p[0]) for p in formats], [int(p[1]) for p in formats])
    return _schedule(fmt, fmt, fmt, enabled)


def paper_schedule(dataset: str, num_layers: int = 5) -> BitSchedule:
    """The per-layer (I,F) design points of Table I of the paper, tiled if
    ``num_layers`` != 5."""
    table = {
        "mnist": [(2, 12), (2, 12), (2, 12), (1, 12), (3, 10)],
        "cifar10": [(2, 10), (2, 11), (1, 10), (1, 13), (2, 13)],
        "svhn": [(1, 12), (2, 12), (2, 12), (2, 11), (4, 12)],
    }
    pts = table[dataset.lower()]
    idx = np.minimum(
        (np.arange(num_layers) * len(pts)) // max(num_layers, 1), len(pts) - 1)
    fmt = ([pts[j][0] for j in idx], [pts[j][1] for j in idx])
    return _schedule(fmt, fmt, fmt, True)


def maybe_quantize(x: torch.Tensor, i_bits, f_bits,
                   enabled: torch.Tensor) -> torch.Tensor:
    """A blend of quantized and passthrough by the runtime flag
    ``enabled`` (0.0/1.0), so toggling it needs no other step object."""
    q = quantize_ste(x, i_bits, f_bits)
    return enabled * q + (1.0 - enabled) * x
