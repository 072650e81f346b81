"""bp_fused_unit: the paper's whole TDM frame in one launch, on Hopper.

Port of ``repro/kernels/bp_fused_unit.py::bp_fused_unit``.  Per hidden layer
i, with G [T, Dout] (dE/dZ_i), the f32 master W [Din, Dout], the layer input
X [T, Din] and the upstream pre-activation Z [T, Din]:

    G_out = kq_g((G @ q_w(W)ᵀ) ⊙ f'(Z))      (Eq. 8)   -> [T, Din]
    W_new = kq_w'(W - lr * XᵀG)             (Eq. 9 + Eq. 1) -> [Din, Dout]

Two datapaths:

  * ``datapath="emulate"`` -- G, X, Z f32; ``q_w`` is the (I,F) rounding
    ``kq`` by ``w_bits``; f32 multiply-adds.
  * ``datapath="int8"`` -- G, X int8 payloads with scales ``g_scale`` and
    ``x_scale`` (device scalars); the kernel quantizes W to int8 on its
    (I,F) grid when ``w_bits`` embeds in 8 bits, else by the absmax of the
    whole W, reduced on the device; exact int32 sums; the products rescale
    by ``s_g * s_w`` and ``s_x * s_g``.

The CUDA kernel (``csrc/bp_fused_unit.cu``) splits the grid over Din row
tiles, so neither output needs a reduction across CTAs; Dout is held whole
by each CTA and may be at most ``MAX_DOUT``.  ``bp_fused_unit_plain`` is its
plain PyTorch version.  ``bp_fused_unit`` runs the plain version only for
CPU tensors; a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch import _build
from repro_torch.kernels import ref
from repro_torch.kernels.common import (ACT_CODES, bits_args, check_operands,
                                        cuda_device, lr_args)
from repro_torch.quant.int8 import int8_spec

MAX_DOUT = 1024           # csrc/bp_fused_unit.cu: MAX_DOUT (shared memory)
_NPART = 64               # csrc/bp_fused_unit.cu: NPART (absmax partials)

_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_FN = {}


def _lib():
    if not _FN:
        lib = _build.load("bp_fused_unit")
        for name, args in (
                # g, w, x, z, lr_ptr; lr; gout, wout; T, Din, Dout,
                # 3x (on, I, F) of g, w, w_out, act; stream
                ("bp_fused_unit_emulate",
                 [_VP] * 5 + [_F] + [_VP] * 2 + [_I] * 13 + [_VP]),
                # g, w, x, z, g_scale, x_scale, lr_ptr; lr; partial;
                # w_exact; w_scale; w_qmin, w_qmax; gout, wout; T, Din, Dout,
                # 2x (on, I, F) of g, w_out, act; stream
                ("bp_fused_unit_int8",
                 [_VP] * 7 + [_F, _VP, _I, _F, _I, _I] + [_VP] * 2
                 + [_I] * 10 + [_VP])):
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = args, ctypes.c_int
            _FN[name] = fn
    return _FN


def _w_spec(w_bits):
    """W's int8 grid: the (I,F) spec when it embeds exactly, else None
    (whole-tensor absmax), as the TPU kernel decides it."""
    spec = int8_spec(*w_bits) if w_bits is not None else None
    return spec if spec is not None and spec.exact else None


def bp_fused_unit_plain(g, w, x, z, lr, *, g_bits=(2, 12), w_bits=(2, 12),
                        w_out_bits=None, act="relu", datapath="emulate",
                        g_scale=None, x_scale=None):
    """The kernel's function in plain PyTorch: (G_out, W_new), both f32."""
    if datapath == "int8":
        return ref.bp_fused_unit_payload_ref(
            g, w, x, z, lr, g_scale, x_scale, g_bits=g_bits, w_bits=w_bits,
            w_out_bits=w_out_bits, act=act)
    return ref.bp_fused_unit_ref(g, w, x, z, lr, g_bits=g_bits, w_bits=w_bits,
                                 w_out_bits=w_out_bits, act=act)


def bp_fused_unit(g: torch.Tensor, w: torch.Tensor, x: torch.Tensor,
                  z: torch.Tensor, lr, *, g_bits=(2, 12), w_bits=(2, 12),
                  w_out_bits=None, act: str = "relu",
                  datapath: str = "emulate",
                  g_scale: Optional[torch.Tensor] = None,
                  x_scale: Optional[torch.Tensor] = None):
    """One TDM frame.  g: [T, Dout]; w: [Din, Dout] f32 master; x, z:
    [T, Din]; lr: float or f32 scalar tensor.  Returns (G_out [T, Din],
    W_new [Din, Dout]), both f32.

    emulate: g/x/z f32.
    int8:    g/x int8 payloads with their scales ``g_scale``/``x_scale``;
             w stays the f32 master and is quantized in the kernel.
    """
    if g.dim() != 2 or w.dim() != 2 or g.shape[1] != w.shape[1]:
        raise ValueError(f"bp_fused_unit: bad shapes G {tuple(g.shape)}, "
                         f"W {tuple(w.shape)}")
    t, din = g.shape[0], w.shape[0]
    for name, a in (("X", x), ("Z", z)):
        if tuple(a.shape) != (t, din):
            raise ValueError(f"bp_fused_unit: {name} must be [{t}, {din}], "
                             f"got {tuple(a.shape)}")
    if w.dtype != torch.float32 or z.dtype != torch.float32:
        raise TypeError(f"bp_fused_unit: W and Z must be f32, got {w.dtype}, "
                        f"{z.dtype}")
    if act not in ACT_CODES:
        raise ValueError(f"bp_fused_unit: unknown activation {act!r}")
    g_scale = check_operands("bp_fused_unit", datapath, (g, x), g_scale)
    if datapath == "int8":
        x_scale = check_operands("bp_fused_unit", datapath, (x,), x_scale)
    tensors = (g, w, x, z)
    if all(a.device.type == "cpu" for a in tensors):
        return bp_fused_unit_plain(g, w, x, z, lr, g_bits=g_bits,
                                   w_bits=w_bits, w_out_bits=w_out_bits,
                                   act=act, datapath=datapath,
                                   g_scale=g_scale, x_scale=x_scale)
    if w.shape[1] > MAX_DOUT:
        raise ValueError(f"bp_fused_unit: Dout {w.shape[1]} > {MAX_DOUT}: "
                         "a CTA holds its rows of W and dW whole in shared "
                         "memory")
    return _launch(g, w, x, z, lr, g_bits, w_bits, w_out_bits, act, datapath,
                   g_scale, x_scale)


bp_fused_unit.launches = 0


def _launch(g, w, x, z, lr, g_bits, w_bits, w_out_bits, act, datapath,
            g_scale, x_scale):
    dev = cuda_device("bp_fused_unit", (g, w, x, z))
    fns = _lib()
    t, dout = g.shape
    din = w.shape[0]
    gout = torch.empty((t, din), dtype=torch.float32, device=dev)
    wout = torch.empty((din, dout), dtype=torch.float32, device=dev)
    lr_val, lr_t = lr_args(lr, dev)
    lr_ptr = None if lr_t is None else lr_t.data_ptr()
    stream = torch.cuda.current_stream(dev).cuda_stream
    if datapath == "int8":
        spec = _w_spec(w_bits)
        partial = None
        if spec is None:
            partial = torch.empty(_NPART, dtype=torch.float32, device=dev)
        g_scale = g_scale.reshape(1).contiguous()
        x_scale = x_scale.reshape(1).contiguous()
        err = fns["bp_fused_unit_int8"](
            g.data_ptr(), w.data_ptr(), x.data_ptr(), z.data_ptr(),
            g_scale.data_ptr(), x_scale.data_ptr(), lr_ptr, lr_val,
            None if partial is None else partial.data_ptr(),
            int(spec is not None), spec.scale if spec else 0.0,
            spec.qmin if spec else 0, spec.qmax if spec else 0,
            gout.data_ptr(), wout.data_ptr(), t, din, dout,
            *bits_args(g_bits), *bits_args(w_out_bits), ACT_CODES[act],
            stream)
    else:
        err = fns["bp_fused_unit_emulate"](
            g.data_ptr(), w.data_ptr(), x.data_ptr(), z.data_ptr(), lr_ptr,
            lr_val, gout.data_ptr(), wout.data_ptr(), t, din, dout,
            *bits_args(g_bits), *bits_args(w_bits), *bits_args(w_out_bits),
            ACT_CODES[act], stream)
    _build.check(err, "bp_fused_unit")
    bp_fused_unit.launches += 1
    return gout, wout
