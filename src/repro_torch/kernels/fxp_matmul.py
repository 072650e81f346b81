"""fxp_matmul: fixed-point (I,F) matmul + fused activation, on Hopper.

Port of ``repro/kernels/fxp_matmul.py::fxp_matmul`` (the TaxoNN PE forward
op ``Y = kq_out(act(kq_a(X) @ kq_w(W)))``).  Two datapaths:

  * ``datapath="emulate"`` -- X, W in f32 or bf16, rounded onto their (I,F)
    grids as they load (``None`` bits = passthrough), f32 multiply-adds, then
    the activation and the optional output rounding.
  * ``datapath="int8"`` -- X, W as int8 payloads, exact int32 accumulation,
    one rescale by the combined scale ``s_x * s_w`` (a device scalar, so no
    host sync), then the activation and the optional output rounding.

The CUDA kernel is ``csrc/fxp_matmul.cu``; ``fxp_matmul_plain`` is its plain
PyTorch version.  ``fxp_matmul`` runs the plain version only for CPU tensors;
a CUDA tensor launches the kernel or raises.  Ragged shapes are masked in
the kernel: no divisibility is required.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch import _build
from repro_torch.kernels import ref
from repro_torch.kernels.common import ACT_CODES

_VP, _I = ctypes.c_void_p, ctypes.c_int
_FN = {}


def _lib():
    if not _FN:
        lib = _build.load("fxp_matmul")
        for name, args in (
                # x, w, y; m, n, k, x_bf16, w_bf16, 3x(on, I, F), act; stream
                ("fxp_matmul_emulate", [_VP] * 3 + [_I] * 15 + [_VP]),
                # x, w, scale, y; m, n, k, (on, I, F) of out, act; stream
                ("fxp_matmul_int8", [_VP] * 4 + [_I] * 7 + [_VP])):
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = args, ctypes.c_int
            _FN[name] = fn
    return _FN


def _bits_args(bits):
    return (0, 0, 0) if bits is None else (1, int(bits[0]), int(bits[1]))


def fxp_matmul_plain(x, w, *, xa_bits=(4, 10), w_bits=(2, 12),
                     out_bits=(4, 10), act="identity", datapath="emulate",
                     scale=None):
    """The kernel's function in plain PyTorch, f32 [M, N]."""
    if datapath == "int8":
        return ref.int8_payload_ref(x, w, scale, out_bits=out_bits, act=act)
    return ref.fxp_matmul_ref(x, w, xa_bits=xa_bits, w_bits=w_bits,
                              out_bits=out_bits, act=act)


def fxp_matmul(x: torch.Tensor, w: torch.Tensor, *,
               xa_bits=(4, 10), w_bits=(2, 12), out_bits=(4, 10),
               act: str = "identity", datapath: str = "emulate",
               scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: [M, K]; w: [K, N]. Returns f32 [M, N].

    emulate: x/w f32 or bf16, rounded in-kernel by (xa_bits, w_bits).
    int8:    x/w int8 payloads; ``scale`` is the combined dequant scale
             s_x * s_w (an f32 scalar tensor or a Python float).
    """
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"fxp_matmul: bad shapes {tuple(x.shape)} @ "
                         f"{tuple(w.shape)}")
    if act not in ACT_CODES:
        raise ValueError(f"fxp_matmul: unknown activation {act!r}")
    if datapath == "int8":
        if x.dtype != torch.int8 or w.dtype != torch.int8:
            raise TypeError(f"int8 datapath needs int8 payloads, got "
                            f"{x.dtype}, {w.dtype}")
        if scale is None:
            raise ValueError("int8 datapath needs the combined scale")
        scale = torch.as_tensor(scale, dtype=torch.float32, device=x.device)
    elif datapath == "emulate":
        for t in (x, w):
            if t.dtype not in (torch.float32, torch.bfloat16):
                raise TypeError(f"emulate datapath takes f32/bf16, got {t.dtype}")
    else:
        raise ValueError(f"unknown datapath {datapath!r}")
    if x.device.type == "cpu" and w.device.type == "cpu":
        return fxp_matmul_plain(x, w, xa_bits=xa_bits, w_bits=w_bits,
                                out_bits=out_bits, act=act,
                                datapath=datapath, scale=scale)
    return _launch(x, w, xa_bits, w_bits, out_bits, act, datapath, scale)


fxp_matmul.launches = 0


def _launch(x, w, xa_bits, w_bits, out_bits, act, datapath, scale):
    if x.device.type != "cuda" or w.device != x.device:
        raise RuntimeError(f"fxp_matmul: operands on {x.device} and "
                           f"{w.device}; the kernel takes one CUDA device")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("fxp_matmul: operands must be contiguous")
    fns = _lib()
    m, k = x.shape
    n = w.shape[1]
    y = torch.empty((m, n), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if datapath == "int8":
        scale = scale.reshape(1).contiguous()
        err = fns["fxp_matmul_int8"](
            x.data_ptr(), w.data_ptr(), scale.data_ptr(), y.data_ptr(),
            m, n, k, *_bits_args(out_bits), ACT_CODES[act], stream)
    else:
        err = fns["fxp_matmul_emulate"](
            x.data_ptr(), w.data_ptr(), y.data_ptr(), m, n, k,
            int(x.dtype == torch.bfloat16), int(w.dtype == torch.bfloat16),
            *_bits_args(xa_bits), *_bits_args(w_bits), *_bits_args(out_bits),
            ACT_CODES[act], stream)
    _build.check(err, "fxp_matmul")
    fxp_matmul.launches += 1
    return y
