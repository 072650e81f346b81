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

    The product runs in float64 on either device: every partial sum is an
    integer of magnitude <= 127^2 * K < 2^53, so it is exact in any
    summation order.  (CUDA has no integer matmul, and the CPU's int32
    matmul is not a BLAS call: 3-5x slower at the engine's shapes.)
    """
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


# ---------------------------------------------------------------------------
# argument checks shared by the kernel wrappers
# ---------------------------------------------------------------------------

def bits_args(bits) -> tuple:
    """An optional (I,F) format as the CUDA launchers take it: (on, I, F)."""
    return (0, 0, 0) if bits is None else (1, int(bits[0]), int(bits[1]))


def check_operands(name: str, datapath: str, tensors, scale):
    """Check the operand dtypes of ``datapath`` (int8 payloads, or f32 for
    emulate).  Returns the int8 datapath's scale as an f32 tensor on the
    operands' device (a Python float becomes one), None for emulate."""
    want = {"int8": torch.int8, "emulate": torch.float32}.get(datapath)
    if want is None:
        raise ValueError(f"{name}: unknown datapath {datapath!r}")
    bad = [t.dtype for t in tensors if t.dtype != want]
    if bad:
        raise TypeError(f"{name}: the {datapath} datapath takes {want} "
                        f"operands, got {bad}")
    if datapath == "emulate":
        return None
    if scale is None:
        raise ValueError(f"{name}: the int8 datapath needs its scale")
    return torch.as_tensor(scale, dtype=torch.float32,
                           device=tensors[0].device)


def cuda_device(name: str, tensors) -> torch.device:
    """The one CUDA device that all of a kernel's operands lie on; raises
    when they are elsewhere or not contiguous (no fallback)."""
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise RuntimeError(f"{name}: operands on "
                           f"{sorted({str(t.device) for t in tensors})}; "
                           "the kernel takes one CUDA device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: operands must be contiguous")
    return dev


_N_SM: dict = {}


def sm_count(dev) -> int:
    """The SM count of CUDA device ``dev`` (the K/token splits' target)."""
    if dev not in _N_SM:
        _N_SM[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
    return _N_SM[dev]


def lr_args(lr, device) -> tuple:
    """A learning rate as the CUDA launchers take it: ``(value, None)`` for
    a Python number, passed by value, or ``(0.0, f32 [1] tensor on the
    device)`` for a tensor, which the kernel reads there (no host sync)."""
    if isinstance(lr, torch.Tensor):
        return 0.0, lr.to(device=device, dtype=torch.float32).reshape(1)
    return float(lr), None
