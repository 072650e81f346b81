"""JAX's threefry2x32 PRNG in torch integer ops: the parts of ``jax.random``
the layer engine and the train driver draw from (``key``, ``fold_in``,
``random_bits``, ``uniform`` bit for bit; ``normal`` within a few f32
ulps).

The JAX package has no module to mirror here: this follows
``jax/_src/prng.py::_threefry_random_bits_partitionable`` and
``jax/_src/random.py::_uniform`` (jax 0.9.0, where
``jax_threefry_partitionable`` is True):

  * a key is two uint32 words; ``key(seed)`` is ``[seed >> 32,
    seed & 0xffffffff]``;
  * ``threefry2x32`` is Threefry-2x32 with 20 rounds, in 5 groups of 4
    with rotations (13, 15, 26, 6) and (17, 29, 16, 24) in turn, and a key
    word ``k0 ^ k1 ^ 0x1BD11BDA`` in the schedule;
  * ``fold_in(k, d)`` is ``threefry2x32(k, (0, d))``;
  * the 32 random bits of flat (row-major) index ``i`` are the two words of
    ``threefry2x32(k, (i >> 32, i & 0xffffffff))`` XORed;
  * a uniform f32 in [0, 1) is ``(bits >> 9) | 0x3f800000`` viewed as f32,
    minus 1.0;
  * a standard normal f32 (``jax/_src/random.py::_normal_real``) is
    ``sqrt(2) * erf_inv(u)``, ``u`` that uniform scaled to
    [nextafter(-1, 0), 1) as ``max(lo, f * (hi - lo) + lo)``, and
    ``erf_inv`` the single-precision polynomial of M. Giles,
    "Approximating the erfinv function" (GPU Computing Gems, 2011), as
    XLA expands it, op by op.  The uniform is JAX's bit for bit; the
    polynomial's ``log1p`` and ``sqrt`` are PyTorch's, which round a few
    values otherwise than XLA's: a draw is within 5e-7 of JAX's
    (``tests/test_torch_engine_encdec.py``), and bitwise the same on
    every run of the port.

torch has no uint32 arithmetic, so every word lives in int64 and is masked
to 32 bits after each add and shift.  These are integer ops, so a draw on
the CPU and the same draw on CUDA are equal bit for bit.

A key is an int64 tensor [2] holding the two words.  The noise depends
only on the key, so a run keyed by (step, layer, row) draws the same noise
after a restart.

A fold turns two words into two words, so keys are folded in Python
integers on the host (a fold as device ops would be ~160 tiny kernels);
only the draws run on the device, taking the key's words as scalars (the
per-row form: one small asynchronous copy of the row keys).
"""
from __future__ import annotations

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.key(seed)``'s two words, as an int64 tensor [2]."""
    seed = int(seed)
    return torch.tensor([(seed >> 32) & _MASK, seed & _MASK],
                        dtype=torch.int64, device=device)


def as_key(k) -> torch.Tensor:
    """A port key, or a JAX key's raw ``uint32[2]`` data
    (``jax.random.key_data``) as numpy, as a port key."""
    if not isinstance(k, torch.Tensor):
        k = torch.from_numpy(np.asarray(k).astype(np.int64))
    if tuple(k.shape) != (2,):
        raise ValueError(f"a key is two words, got shape {tuple(k.shape)}")
    return k.to(torch.int64)


def _rotl(v, r: int):
    return ((v << r) & _MASK) | (v >> (32 - r))


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 of the count words (x0, x1) under the key (k0, k1).

    Each argument is an int64 tensor of uint32 values (or a Python int);
    they broadcast.  Returns the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, x1


def _words(k: torch.Tensor):
    return int(k[0]), int(k[1])


def _fold_int(k0: int, k1: int, data: int):
    return threefry2x32(k0, k1, 0, int(data) & _MASK)


def fold_in(k: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in(k, data)``: ``threefry2x32(k, (0, data))``,
    with ``data`` taken as uint32; on the key's device."""
    k = as_key(k)
    return torch.tensor(_fold_int(*_words(k), data), dtype=torch.int64,
                        device=k.device)


def _bits(k0, k1, shape, device) -> torch.Tensor:
    """The partitionable bits of ``shape`` under keys that broadcast
    against a trailing flat axis of ``prod(shape)`` elements."""
    n = int(np.prod(shape, dtype=np.int64))
    i = torch.arange(n, dtype=torch.int64, device=device)
    y0, y1 = threefry2x32(k0, k1, i >> 32, i & _MASK)
    return y0 ^ y1


def random_bits(k: torch.Tensor, shape, device=None) -> torch.Tensor:
    """``jax.random.bits(k, shape, jnp.uint32)`` as int64 values in
    [0, 2^32), on ``device`` (the key's unless named)."""
    k = as_key(k)
    shape = tuple(int(s) for s in shape)
    device = torch.device(device) if device is not None else k.device
    return _bits(*_words(k), shape, device).reshape(shape)


def uniform_block(k: torch.Tensor, shape, start, size,
                  device=None) -> torch.Tensor:
    """The block of ``uniform(k, shape)`` of ``size`` at ``start`` (one
    index a dimension), drawn from its elements' flat indices in ``shape``
    alone: what one rank's shard of a leaf gets of the logical leaf's
    draws (the partitionable bits draw each element from its index)."""
    k = as_key(k)
    device = torch.device(device) if device is not None else k.device
    idx = torch.zeros((), dtype=torch.int64, device=device)
    stride = 1
    for d in reversed(range(len(shape))):
        ar = torch.arange(int(size[d]), dtype=torch.int64, device=device)
        ar = (ar + int(start[d])) * stride
        idx = idx + ar.reshape((-1,) + (1,) * (len(shape) - 1 - d))
        stride *= int(shape[d])
    k0, k1 = _words(k)
    y0, y1 = threefry2x32(k0, k1, idx >> 32, idx & _MASK)
    return _to_uniform(y0 ^ y1)


def _to_uniform(bits: torch.Tensor) -> torch.Tensor:
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0


def uniform(k: torch.Tensor, shape, device=None) -> torch.Tensor:
    """``jax.random.uniform(k, shape, jnp.float32)``: f32 in [0, 1)."""
    return _to_uniform(random_bits(k, shape, device))


def uniform_rows(k: torch.Tensor, shape, offset: int = 0,
                 device=None) -> torch.Tensor:
    """Uniform f32 noise of ``shape`` whose row ``b`` of the leading axis is
    ``uniform(fold_in(k, offset + b), shape[1:])``: the draws of the JAX
    package's ``quant.fixed_point.stochastic_round_batched``."""
    k = as_key(k)
    shape = tuple(int(s) for s in shape)
    device = torch.device(device) if device is not None else k.device
    k0, k1 = _words(k)
    keys = torch.tensor([_fold_int(k0, k1, int(offset) + b)
                         for b in range(shape[0])],
                        dtype=torch.int64).reshape(-1, 2)
    if device.type == "cuda":
        # a copy from pinned memory does not wait for the stream's work
        keys = keys.pin_memory()
    keys = keys.to(device, non_blocking=True)
    bits = _bits(keys[:, :1], keys[:, 1:], shape[1:], device)
    return _to_uniform(bits).reshape(shape)


# M. Giles' single-precision erfinv: the coefficients of p(w) for
# w = -log1p(-x^2) below 5 (in w - 2.5) and from 5 up (in sqrt(w) - 3),
# highest power first, as XLA's ErfInv expands them
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """The inverse error function of f32 ``x`` as XLA computes it (Giles'
    polynomial, each op rounded to f32; +-inf at +-1)."""
    w = -torch.log1p(x * -x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)

    def coef(i):
        return torch.where(lt, torch.tensor(_ERFINV_LT5[i]),
                           torch.tensor(_ERFINV_GE5[i])).to(x.device)
    p = coef(0)
    for i in range(1, len(_ERFINV_LT5)):
        p = coef(i) + p * w
    return torch.where(torch.abs(x) == 1.0, x * float("inf"), p * x)


def normal(k: torch.Tensor, shape, device=None) -> torch.Tensor:
    """``jax.random.normal(k, shape, jnp.float32)``: the uniform in
    [nextafter(-1, 0), 1) from ``k``'s bits, then ``sqrt(2) * erf_inv``
    (module docstring)."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0), dtype=np.float32)
    hi = np.float32(1.0)
    f = uniform(k, shape, device)
    u = torch.maximum(f * float(hi - lo) + float(lo),
                      torch.tensor(float(lo), device=f.device))
    return float(np.float32(np.sqrt(2))) * erf_inv(u)
