"""sgd_dw_update: fused ``W_new = kq_w(W - lr * XᵀG)``, on Hopper.

Port of ``repro/kernels/sgd_dw_update.py::sgd_dw_update`` (paper Eq. 9 +
Eq. 1): dW is accumulated over the tokens and folded into the SGD step in
the same launch, so it never reaches device memory.  Shapes: X [T, Din],
G [T, Dout], W [Din, Dout] or ``None`` (the dW-only form ``kq_w(XᵀG)`` of
the dense unit's backward) -> [Din, Dout] f32.  Two datapaths:

  * ``datapath="emulate"`` -- X, G, W f32; f32 multiply-adds.
  * ``datapath="int8"`` -- X, G int8 payloads, exact int32 accumulation, one
    rescale by ``s_x * s_g`` (a device scalar); the f32 master W is updated
    in f32.

``lr`` is a Python float (passed by value) or a tensor (read on the device),
so a step needs no host sync.  The CUDA kernel is ``csrc/sgd_dw_update.cu``;
``sgd_dw_update_plain`` is its plain PyTorch version.  ``sgd_dw_update`` runs
the plain version only for CPU tensors; a CUDA tensor launches the kernel or
raises.  Ragged shapes are masked in the kernel.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch import _build
from repro_torch.kernels import ref
from repro_torch.kernels.common import (bits_args, check_operands,
                                        cuda_device, lr_args)

_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_FN = {}


def _lib():
    if not _FN:
        lib = _build.load("sgd_dw_update")
        for name, args in (
                # x, g, w, lr_ptr; lr; out; T, Din, Dout, (on, I, F); stream
                ("sgd_dw_update_emulate",
                 [_VP] * 4 + [_F, _VP] + [_I] * 6 + [_VP]),
                # x, g, scale, w, lr_ptr; lr; out; T, Din, Dout, (on, I, F);
                # stream
                ("sgd_dw_update_int8",
                 [_VP] * 5 + [_F, _VP] + [_I] * 6 + [_VP])):
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = args, ctypes.c_int
            _FN[name] = fn
    return _FN


def sgd_dw_update_plain(x, g, w, lr, *, w_bits=None, datapath="emulate",
                        scale=None):
    """The kernel's function in plain PyTorch, f32 [Din, Dout]."""
    if datapath == "int8":
        return ref.sgd_dw_update_payload_ref(x, g, w, lr, scale,
                                             w_bits=w_bits)
    return ref.sgd_dw_update_ref(x, g, w, lr, w_bits=w_bits)


def sgd_dw_update(x: torch.Tensor, g: torch.Tensor, w: Optional[torch.Tensor],
                  lr, *, w_bits=None, datapath: str = "emulate",
                  scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: [T, Din]; g: [T, Dout]; w: [Din, Dout] f32 or None; lr: float or
    f32 scalar tensor.  Returns ``kq_w(W - lr * xᵀg)``, or ``kq_w(xᵀg)``
    when ``w`` is None.

    emulate: x/g f32.
    int8:    x/g int8 payloads; ``scale`` is s_x * s_g.
    """
    if x.dim() != 2 or g.dim() != 2 or x.shape[0] != g.shape[0]:
        raise ValueError(f"sgd_dw_update: bad shapes X {tuple(x.shape)}, "
                         f"G {tuple(g.shape)}")
    din, dout = x.shape[1], g.shape[1]
    if w is not None and (tuple(w.shape) != (din, dout)
                          or w.dtype != torch.float32):
        raise ValueError(f"sgd_dw_update: W must be f32 [{din}, {dout}], "
                         f"got {w.dtype} {tuple(w.shape)}")
    scale = check_operands("sgd_dw_update", datapath, (x, g), scale)
    tensors = (x, g) if w is None else (x, g, w)
    if all(t.device.type == "cpu" for t in tensors):
        return sgd_dw_update_plain(x, g, w, lr, w_bits=w_bits,
                                   datapath=datapath, scale=scale)
    return _launch(x, g, w, lr, w_bits, datapath, scale, tensors)


sgd_dw_update.launches = 0


def _launch(x, g, w, lr, w_bits, datapath, scale, tensors):
    dev = cuda_device("sgd_dw_update", tensors)
    fns = _lib()
    t, din = x.shape
    dout = g.shape[1]
    out = torch.empty((din, dout), dtype=torch.float32, device=dev)
    wp = None if w is None else w.data_ptr()
    lr_val, lr_t = lr_args(lr, dev)
    lr_ptr = None if lr_t is None else lr_t.data_ptr()
    stream = torch.cuda.current_stream(dev).cuda_stream
    if datapath == "int8":
        scale = scale.reshape(1).contiguous()
        err = fns["sgd_dw_update_int8"](
            x.data_ptr(), g.data_ptr(), scale.data_ptr(), wp, lr_ptr, lr_val,
            out.data_ptr(), t, din, dout, *bits_args(w_bits), stream)
    else:
        err = fns["sgd_dw_update_emulate"](
            x.data_ptr(), g.data_ptr(), wp, lr_ptr, lr_val, out.data_ptr(),
            t, din, dout, *bits_args(w_bits), stream)
    _build.check(err, "sgd_dw_update")
    sgd_dw_update.launches += 1
    return out
