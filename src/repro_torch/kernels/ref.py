"""Plain-PyTorch oracles of every kernel (port of ``kernels/ref.py``).

Each kernel has two oracles: the f32 (I,F)-emulation reference (``*_ref``)
and the int8-datapath reference (``*_int8_ref``), which quantizes the
operands onto their int8 grids (``quantize_int8_auto``), then runs the
payload oracle (``*_payload_ref``): exact int32 products of the payloads and
one rescale, in the JAX package's order of operations.  The payload oracles
are what the kernels' plain versions run on the int8 datapath, where the
wrappers take payloads that are already quantized.

``z=None`` (with ``act="identity"``) skips the derivation unit of
``bp_gstep``; ``w=None`` turns ``sgd_dw_update`` into its dW-only form.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.common import act_deriv, act_fn, int8_dot, maybe_kq
from repro_torch.quant.int8 import quantize_int8_auto


def _f32(t):
    return t.to(torch.float32)


def fxp_matmul_ref(x, w, *, xa_bits=(4, 10), w_bits=(2, 12),
                   out_bits=(4, 10), act="identity"):
    xq = maybe_kq(_f32(x), xa_bits)
    wq = maybe_kq(_f32(w), w_bits)
    return maybe_kq(act_fn(xq @ wq, act), out_bits)


def bp_gstep_ref(g, w, z, *, g_bits=(2, 12), act="relu"):
    gi = _f32(g) @ _f32(w).T
    if z is not None:
        gi = gi * act_deriv(_f32(z), act)
    return maybe_kq(gi, g_bits)


def sgd_dw_update_ref(x, g, w, lr, *, w_bits=None):
    dw = _f32(x).T @ _f32(g)
    if w is None:
        return maybe_kq(dw, w_bits)
    return maybe_kq(_f32(w) - lr * dw, w_bits)


def bp_fused_unit_ref(g, w, x, z, lr, *, g_bits=(2, 12), w_bits=(2, 12),
                      w_out_bits=None, act="relu"):
    """The TDM frame as three sequential ops (Eq. 8 + Eq. 9 + Eq. 1)."""
    gf, wf = _f32(g), _f32(w)
    wq = maybe_kq(wf, w_bits)
    go = maybe_kq((gf @ wq.T) * act_deriv(_f32(z), act), g_bits)
    dw = _f32(x).T @ gf
    return go, maybe_kq(wf - lr * dw, w_out_bits)


# ---------------------------------------------------------------------------
# int8 datapath: payload oracles (what the kernels compute) ...
# ---------------------------------------------------------------------------

def int8_payload_ref(qx, qw, scale, *, out_bits=(4, 10), act="identity"):
    """fxp_matmul on payloads already quantized: exact int32 sums, one
    rescale by the combined scale, the activation, then ``kq_out``.  With
    ``scale`` None, the int32 sums themselves (the int32 mode)."""
    acc = int8_dot(qx, qw)
    if scale is None:
        return acc
    y = acc.to(torch.float32) * scale
    return maybe_kq(act_fn(y, act), out_bits)


def bp_gstep_payload_ref(qg, qw, z, scale, *, g_bits=(2, 12), act="relu"):
    """bp_gstep on payloads: int32 (qG @ qWᵀ), rescale by s_g·s_w, f'(Z).
    With ``scale`` None, the int32 sums themselves (the int32 mode)."""
    acc = int8_dot(qg, qw.T)
    if scale is None:
        return acc
    gi = acc.to(torch.float32) * scale
    if z is not None:
        gi = gi * act_deriv(_f32(z), act)
    return maybe_kq(gi, g_bits)


def sgd_dw_update_payload_ref(qx, qg, w, lr, scale, *, w_bits=None):
    """sgd_dw_update on payloads: dW = int32 (qXᵀ @ qG) · s_x·s_g, then
    ``kq_w(W - lr·dW)`` (or ``kq_w(dW)`` when ``w`` is None)."""
    dw = int8_dot(qx.T, qg).to(torch.float32) * scale
    if w is None:
        return maybe_kq(dw, w_bits)
    return maybe_kq(_f32(w) - lr * dw, w_bits)


def bp_fused_unit_payload_ref(qg, w, qx, z, lr, g_scale, x_scale, *,
                              g_bits=(2, 12), w_bits=(2, 12),
                              w_out_bits=None, act="relu"):
    """The int8 TDM frame on G/X payloads; the f32 master W is quantized
    here as the kernel does (its (I,F) grid when that embeds in 8 bits,
    whole-tensor absmax otherwise)."""
    qw, sw = quantize_int8_auto(w, w_bits)
    go = int8_dot(qg, qw.T).to(torch.float32) * (g_scale * sw)
    go = maybe_kq(go * act_deriv(_f32(z), act), g_bits)
    dw = int8_dot(qx.T, qg).to(torch.float32) * (x_scale * g_scale)
    return go, maybe_kq(_f32(w) - lr * dw, w_out_bits)


# ---------------------------------------------------------------------------
# ... and the int8 oracles of the float operands
# ---------------------------------------------------------------------------

def fxp_matmul_int8_ref(x, w, *, xa_bits=(4, 10), w_bits=(2, 12),
                        out_bits=(4, 10), act="identity"):
    qx, sx = quantize_int8_auto(x, xa_bits)
    qw, sw = quantize_int8_auto(w, w_bits)
    return int8_payload_ref(qx, qw, sx * sw, out_bits=out_bits, act=act)


def bp_gstep_int8_ref(g, w, z, *, g_in_bits=(2, 12), w_bits=(2, 12),
                      g_bits=(2, 12), act="relu"):
    qg, sg = quantize_int8_auto(g, g_in_bits)
    qw, sw = quantize_int8_auto(w, w_bits)
    return bp_gstep_payload_ref(qg, qw, z, sg * sw, g_bits=g_bits, act=act)


def sgd_dw_update_int8_ref(x, g, w, lr, *, xa_bits=(4, 10),
                           g_in_bits=(2, 12), w_bits=None):
    qx, sx = quantize_int8_auto(x, xa_bits)
    qg, sg = quantize_int8_auto(g, g_in_bits)
    return sgd_dw_update_payload_ref(qx, qg, w, lr, sx * sg, w_bits=w_bits)


def bp_fused_unit_int8_ref(g, w, x, z, lr, *, g_in_bits=(2, 12),
                           xa_bits=(4, 10), g_bits=(2, 12), w_bits=(2, 12),
                           w_out_bits=None, act="relu"):
    qg, sg = quantize_int8_auto(g, g_in_bits)
    qx, sx = quantize_int8_auto(x, xa_bits)
    return bp_fused_unit_payload_ref(qg, w, qx, z, lr, sg, sx, g_bits=g_bits,
                                     w_bits=w_bits, w_out_bits=w_out_bits,
                                     act=act)
