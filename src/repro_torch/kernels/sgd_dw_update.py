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

The kernel tiles W into 64x128 or 64x64 (emulate) or 64x64 (int8)
outputs.  Where those tiles cannot fill the card, ``_plan`` cuts the token
axis into at most ``MAX_SPLITS`` contiguous runs of token tiles, one CTA
each; the CTAs of an output tile form a thread-block cluster and sum their
partial dWs in run order in shared memory before the update, so the kernel
needs no scratch.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch import _build
from repro_torch.kernels import ref
from repro_torch.kernels.common import (bits_args, check_operands,
                                        cuda_device, lr_args, sm_count,
                                        tuned)

_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_FN = {}

# The CTA tiles: outputs along (Din, Dout) and the CTAs an SM the token
# split aims for.  f32x8: 8x8 outputs a thread, the better ratio of shared
# loads to FMAs where the tiles alone fill the card; f32x4: 4x4 outputs a
# thread, whose smaller CTAs (4 an SM) hide more latency where the split
# has to fill it (the LeNet shapes, faster at batch 128 to 1024 in H100
# sweeps); int8: tensor-core tiles, 2 an SM.
TILE = {"f32x8": (64, 128), "f32x4": (64, 64), "int8": (64, 64)}
CTAS_PER_SM = {"f32x8": 1, "f32x4": 4, "int8": 2}
_MT = {"f32x8": 8, "f32x4": 4}
# tokens per staged tile, and the shortest run a split may have: a shorter
# one costs more in the sum than it saves (int8: at batch 128 one CTA's
# two token tiles beat two CTAs of one in the LeNet step)
BK = {"emulate": 16, "int8": 64}
MIN_SPLIT_TOKENS = {"emulate": 32, "int8": 128}
MAX_SPLITS = 16  # the CTAs of a thread-block cluster on Hopper
# a row is staged in 16-byte pieces when its length is a multiple of these
_VEC_ELEMS = {"emulate": 4, "int8": 16}


def _tiles(kind: str, din: int, dout: int) -> int:
    tm, tn = TILE[kind]
    return -(-din // tm) * -(-dout // tn)


def _plan(t: int, din: int, dout: int, n_sm: int,
          datapath: str = "emulate") -> tuple:
    """One launch: ``(kind, per, s)``, the CTA tile ``kind`` and ``s`` runs
    of ``per`` token tiles (``BK[datapath]`` tokens each), run ``k``
    covering tiles ``[k*per, min((k+1)*per, ceil(t/bk)))``.  emulate takes
    f32x8 where those tiles alone fill the ``n_sm`` SMs, else f32x4.  ``s``
    is as many runs as keep at most ``CTAS_PER_SM[kind]`` CTAs on each SM,
    ``floor(CTAS_PER_SM*n_sm/tiles)`` (one CTA more leaves a few SMs with
    an extra one, and the launch waits for them), but no run shorter than
    ``MIN_SPLIT_TOKENS[datapath]`` and no more than ``MAX_SPLITS``, rounded
    down to a power of two (a cluster of 10 CTAs ran slower than one of 8
    on the H100), then trimmed so that no run is empty."""
    kind = "int8" if datapath == "int8" else (
        "f32x8" if _tiles("f32x8", din, dout) >= n_sm else "f32x4")
    bk = BK[datapath]
    nk = -(-t // bk)
    if nk == 0:
        return kind, 0, 1
    per_min = -(-MIN_SPLIT_TOKENS[datapath] // bk)
    s = max(1, min(nk // per_min,
                   CTAS_PER_SM[kind] * n_sm // _tiles(kind, din, dout),
                   MAX_SPLITS))
    s = 1 << (s.bit_length() - 1)
    per = -(-nk // s)
    return kind, per, -(-nk // per)


def tuned_plan(t: int, din: int, dout: int, n_sm: int,
               datapath: str) -> tuple:
    """``_plan``'s launch through the tune cache (``common.tuned``), keyed
    as the product Xᵀ @ G: m = din, n = dout, k = t."""
    return tuple(tuned("sgd_dw_update", (din, dout, t, datapath), n_sm,
                       lambda: _plan(t, din, dout, n_sm, datapath)))


def _vec(t: torch.Tensor, datapath: str) -> int:
    """1 when each row of ``t`` is 16-byte aligned (16-byte copies)."""
    return int(t.shape[1] % _VEC_ELEMS[datapath] == 0
               and t.data_ptr() % 16 == 0)


def _lib():
    if not _FN:
        lib = _build.load("sgd_dw_update")
        for name, args in (
                # x, g, w, lr_ptr; lr; out; T, Din, Dout, per, S, mt, vx,
                # vg, (on, I, F); stream
                ("sgd_dw_update_emulate",
                 [_VP] * 4 + [_F, _VP] + [_I] * 11 + [_VP]),
                # x, g, scale, w, lr_ptr; lr; out; T, Din, Dout, per, S, vx,
                # vg, (on, I, F); stream
                ("sgd_dw_update_int8",
                 [_VP] * 5 + [_F, _VP] + [_I] * 10 + [_VP])):
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
    """One launch by the tune cache's plan (``tuned_plan``)."""
    dev = cuda_device("sgd_dw_update", tensors)
    fns = _lib()
    t, din = x.shape
    dout = g.shape[1]
    kind, per, s = tuned_plan(t, din, dout, sm_count(dev), datapath)
    out = torch.empty((din, dout), dtype=torch.float32, device=dev)
    wp = None if w is None else w.data_ptr()
    lr_val, lr_t = lr_args(lr, dev)
    lr_ptr = None if lr_t is None else lr_t.data_ptr()
    stream = torch.cuda.current_stream(dev).cuda_stream
    plan = (t, din, dout, per, s, _vec(x, datapath), _vec(g, datapath),
            *bits_args(w_bits))
    if datapath == "int8":
        scale = scale.reshape(1).contiguous()
        err = fns["sgd_dw_update_int8"](
            x.data_ptr(), g.data_ptr(), scale.data_ptr(), wp, lr_ptr, lr_val,
            out.data_ptr(), *plan, stream)
    else:
        err = fns["sgd_dw_update_emulate"](
            x.data_ptr(), g.data_ptr(), wp, lr_ptr, lr_val, out.data_ptr(),
            *plan[:5], _MT[kind], *plan[5:], stream)
    _build.check(err, "sgd_dw_update")
    sgd_dw_update.launches += 1
    return out
