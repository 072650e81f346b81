"""bp_gstep: the G-chain step ``G_i = kq_g((G @ Wᵀ) ⊙ f'(Z))``, on Hopper.

Port of ``repro/kernels/bp_gstep.py::bp_gstep`` (paper Eq. 8).  Shapes:
G [T, Dout], W [Din, Dout] (forward orientation), Z [T, Din] or ``None``
(then ``act`` must be "identity": the dense unit's dx = dz @ Wᵀ); the
result is G_i [T, Din] f32.  Two datapaths:

  * ``datapath="emulate"`` -- G, W, Z f32; f32 multiply-adds.
  * ``datapath="int8"`` -- G, W int8 payloads, exact int32 accumulation, one
    rescale by the combined scale ``s_g * s_w`` (a device scalar, so no host
    sync), then the derivation unit and the (I,F) rounding.

The CUDA kernel is ``csrc/bp_gstep.cu``; ``bp_gstep_plain`` is its plain
PyTorch version.  ``bp_gstep`` runs the plain version only for CPU tensors;
a CUDA tensor launches the kernel or raises.  Ragged shapes are masked in
the kernel: no divisibility is required.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch import _build
from repro_torch.kernels import ref
from repro_torch.kernels.common import (ACT_CODES, bits_args,
                                        check_operands, cuda_device)

_VP, _I = ctypes.c_void_p, ctypes.c_int
_FN = {}


def _lib():
    if not _FN:
        lib = _build.load("bp_gstep")
        for name, args in (
                # g, w, z, out; T, Din, Dout, (on, I, F) of g, act; stream
                ("bp_gstep_emulate", [_VP] * 4 + [_I] * 7 + [_VP]),
                # g, w, scale, z, out; T, Din, Dout, (on, I, F), act; stream
                ("bp_gstep_int8", [_VP] * 5 + [_I] * 7 + [_VP])):
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = args, ctypes.c_int
            _FN[name] = fn
    return _FN


def bp_gstep_plain(g, w, z, *, g_bits=(2, 12), act="relu",
                   datapath="emulate", scale=None):
    """The kernel's function in plain PyTorch, f32 [T, Din]."""
    if datapath == "int8":
        return ref.bp_gstep_payload_ref(g, w, z, scale, g_bits=g_bits,
                                        act=act)
    return ref.bp_gstep_ref(g, w, z, g_bits=g_bits, act=act)


def bp_gstep(g: torch.Tensor, w: torch.Tensor, z: Optional[torch.Tensor], *,
             g_bits=(2, 12), act: str = "relu", datapath: str = "emulate",
             scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """g: [T, Dout]; w: [Din, Dout]; z: [T, Din] or None. Returns f32
    [T, Din].

    emulate: g/w/z f32.
    int8:    g/w int8 payloads; ``scale`` is the combined dequant scale
             s_g * s_w (an f32 scalar tensor or a Python float).
    """
    if g.dim() != 2 or w.dim() != 2 or g.shape[1] != w.shape[1]:
        raise ValueError(f"bp_gstep: bad shapes G {tuple(g.shape)}, "
                         f"W {tuple(w.shape)}")
    t, din = g.shape[0], w.shape[0]
    if z is None:
        if act != "identity":
            raise ValueError("bp_gstep: z=None needs act='identity'")
    elif tuple(z.shape) != (t, din) or z.dtype != torch.float32:
        raise ValueError(f"bp_gstep: Z must be f32 [{t}, {din}], got "
                         f"{z.dtype} {tuple(z.shape)}")
    if act not in ACT_CODES:
        raise ValueError(f"bp_gstep: unknown activation {act!r}")
    scale = check_operands("bp_gstep", datapath, (g, w), scale)
    tensors = (g, w) if z is None else (g, w, z)
    if all(x.device.type == "cpu" for x in tensors):
        return bp_gstep_plain(g, w, z, g_bits=g_bits, act=act,
                              datapath=datapath, scale=scale)
    return _launch(g, w, z, g_bits, act, datapath, scale, tensors)


bp_gstep.launches = 0


def _launch(g, w, z, g_bits, act, datapath, scale, tensors):
    dev = cuda_device("bp_gstep", tensors)
    fns = _lib()
    t, dout = g.shape
    din = w.shape[0]
    out = torch.empty((t, din), dtype=torch.float32, device=dev)
    zp = None if z is None else z.data_ptr()
    stream = torch.cuda.current_stream(dev).cuda_stream
    if datapath == "int8":
        scale = scale.reshape(1).contiguous()
        err = fns["bp_gstep_int8"](
            g.data_ptr(), w.data_ptr(), scale.data_ptr(), zp, out.data_ptr(),
            t, din, dout, *bits_args(g_bits), ACT_CODES[act], stream)
    else:
        err = fns["bp_gstep_emulate"](
            g.data_ptr(), w.data_ptr(), zp, out.data_ptr(), t, din, dout,
            *bits_args(g_bits), ACT_CODES[act], stream)
    _build.check(err, "bp_gstep")
    bp_gstep.launches += 1
    return out
