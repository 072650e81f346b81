"""The kernel-backend knob and the dense-unit entry points (port of
``kernels/ops.py``).

``KernelBackend`` selects the datapath of the hot paths: ``"off"`` (plain
PyTorch), ``"emulate"`` (the kernels, f32 emulation) and ``"int8"`` (int8
operands, int32 accumulation).  ``"auto"`` resolves to off on a CPU device
and int8 on CUDA, as the JAX package's auto means int8 off the CPU.
Installed with ``kernel_backend_ctx``; read by ``models.layers`` and
``kernels.decode_prologue``; ``core.lenet`` takes it as an argument.

The ``*_op`` wrappers quantize the int8 datapath's operands here with
``quantize_int8_auto`` (the (I,F) grid when it embeds in 8 bits, absmax
otherwise), as the JAX package does, and hand the payloads to the kernels.
The ``dense_*`` helpers are the dense unit's forward and backward on the
kernels, with per-call absmax scales and no (I,F) rounding.

The JAX package's block tuners and tune cache (``tune_*``) budget a TPU
core's VMEM and fall back to jnp where a shape does not fit; they are not
ported, and nothing gates the kernels here: on CUDA tensors every kernel
launches at any shape (the kernels mask ragged edges).
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Optional

import torch

from repro_torch.kernels.bp_fused_unit import bp_fused_unit
from repro_torch.kernels.bp_gstep import bp_gstep
from repro_torch.kernels.fxp_matmul import fxp_matmul
from repro_torch.kernels.sgd_dw_update import sgd_dw_update
from repro_torch.quant.int8 import quantize_int8_absmax, quantize_int8_auto

KERNEL_BACKENDS = ("off", "emulate", "int8")

_BACKEND: contextvars.ContextVar[str] = contextvars.ContextVar(
    "kernel_backend", default="off")


def resolve_backend(backend: Optional[str], device=None) -> str:
    """Resolve ``None``/"auto": off on a CPU device, int8 on CUDA.  With no
    device given, CUDA is assumed when it is available."""
    if backend is None or backend == "auto":
        if device is None:
            on_cuda = torch.cuda.is_available()
        else:
            on_cuda = torch.device(device).type == "cuda"
        return "int8" if on_cuda else "off"
    if backend not in KERNEL_BACKENDS:
        raise ValueError(
            f"kernel_backend {backend!r} not in {KERNEL_BACKENDS + ('auto',)}")
    return backend


@contextlib.contextmanager
def kernel_backend_ctx(backend: Optional[str], device=None):
    """Install a kernel backend for the enclosed calls."""
    token = _BACKEND.set(resolve_backend(backend, device))
    try:
        yield
    finally:
        _BACKEND.reset(token)


def current_backend() -> str:
    return _BACKEND.get()


def fxp_matmul_op(x, w, *, xa_bits=(4, 10), w_bits=(2, 12), out_bits=(4, 10),
                  act="identity", datapath="emulate"):
    """fxp_matmul with the operand quantization of the int8 datapath done
    here (the (I,F) grid when it embeds in 8 bits, absmax otherwise)."""
    if datapath == "int8":
        qx, sx = quantize_int8_auto(x, xa_bits)
        qw, sw = quantize_int8_auto(w, w_bits)
        return fxp_matmul(qx, qw, out_bits=out_bits, act=act,
                          datapath="int8", scale=sx * sw)
    return fxp_matmul(x, w, xa_bits=xa_bits, w_bits=w_bits,
                      out_bits=out_bits, act=act)


def dense_fwd(x2, w, backend: str):
    """z = x2 @ w at f32 through the selected datapath. x2: [M,K], w: [K,N].

    Returns the raw pre-activation z; the caller applies the activation.
    The emulate path hands bf16 activations to the kernel as they are: it
    widens them to f32 as it loads them, which is exact.
    """
    if backend == "int8":
        qx, sx = quantize_int8_absmax(x2)
        qw, sw = quantize_int8_absmax(w)
        return fxp_matmul(qx, qw, out_bits=None, act="identity",
                          datapath="int8", scale=sx * sw)
    return fxp_matmul(x2, w, xa_bits=None, w_bits=None, out_bits=None,
                      act="identity")


def bp_gstep_op(g, w, z, *, g_bits=(2, 12), act="relu", datapath="emulate",
                g_in_bits=(2, 12), w_bits=(2, 12)):
    """bp_gstep with the int8 operands G (by ``g_in_bits``) and W (by
    ``w_bits``) quantized here."""
    if datapath == "int8":
        qg, sg = quantize_int8_auto(g, g_in_bits)
        qw, sw = quantize_int8_auto(w, w_bits)
        return bp_gstep(qg, qw, z, g_bits=g_bits, act=act, datapath="int8",
                        scale=sg * sw)
    return bp_gstep(g, w, z, g_bits=g_bits, act=act)


def sgd_dw_update_op(x, g, w, lr, *, w_bits=None, datapath="emulate",
                     xa_bits=(4, 10), g_in_bits=(2, 12)):
    """sgd_dw_update with the int8 operands X (by ``xa_bits``) and G (by
    ``g_in_bits``) quantized here; the f32 master W is updated in f32."""
    if datapath == "int8":
        qx, sx = quantize_int8_auto(x, xa_bits)
        qg, sg = quantize_int8_auto(g, g_in_bits)
        return sgd_dw_update(qx, qg, w, lr, w_bits=w_bits, datapath="int8",
                             scale=sx * sg)
    return sgd_dw_update(x, g, w, lr, w_bits=w_bits)


def bp_fused_unit_op(g, w, x, z, lr, *, g_bits=(2, 12), w_bits=(2, 12),
                     w_out_bits=None, act="relu", datapath="emulate",
                     g_in_bits=(2, 12), xa_bits=(4, 10)):
    """One TDM frame; on the int8 datapath G (by ``g_in_bits``) and X (by
    ``xa_bits``) are quantized here and W in the kernel."""
    if datapath == "int8":
        qg, sg = quantize_int8_auto(g, g_in_bits)
        qx, sx = quantize_int8_auto(x, xa_bits)
        return bp_fused_unit(qg, w, qx, z, lr, g_bits=g_bits, w_bits=w_bits,
                             w_out_bits=w_out_bits, act=act, datapath="int8",
                             g_scale=sg, x_scale=sx)
    return bp_fused_unit(g, w, x, z, lr, g_bits=g_bits, w_bits=w_bits,
                         w_out_bits=w_out_bits, act=act)


def dense_bwd_dx(dz, w, backend: str):
    """dx = dz @ wᵀ through bp_gstep's ``z=None`` form.  dz: [M, N];
    w: [K, N] (bp_gstep's G [T, Dout] and W [Din, Dout]) -> [M, K]."""
    if backend == "int8":
        qg, sg = quantize_int8_absmax(dz)
        qw, sw = quantize_int8_absmax(w)
        return bp_gstep(qg, qw, None, g_bits=None, act="identity",
                        datapath="int8", scale=sg * sw)
    return bp_gstep(dz.to(torch.float32), w.to(torch.float32), None,
                    g_bits=None, act="identity")


def dense_bwd_dw(x2, dz, backend: str):
    """dw = x2ᵀ @ dz through sgd_dw_update's dW-only (``w=None``) form.
    x2: [M, K]; dz: [M, N] -> [K, N]."""
    if backend == "int8":
        qx, sx = quantize_int8_absmax(x2)
        qg, sg = quantize_int8_absmax(dz)
        return sgd_dw_update(qx, qg, None, 0.0, datapath="int8",
                             scale=sx * sg)
    return sgd_dw_update(x2.to(torch.float32), dz.to(torch.float32), None,
                         0.0)
