"""Plain-PyTorch oracles of ``fxp_matmul`` (port of ``kernels/ref.py``).

``fxp_matmul_ref`` is the f32 (I,F)-emulation reference; ``fxp_matmul_int8_ref``
quantizes both operands onto their int8 grids, then runs ``int8_payload_ref``:
an exact int32 product of the payloads and one rescale.  The training
kernels' oracles come with the training slice.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.common import act_fn, int8_dot, maybe_kq
from repro_torch.quant.int8 import quantize_int8_auto


def fxp_matmul_ref(x, w, *, xa_bits=(4, 10), w_bits=(2, 12),
                   out_bits=(4, 10), act="identity"):
    xq = maybe_kq(x.to(torch.float32), xa_bits)
    wq = maybe_kq(w.to(torch.float32), w_bits)
    return maybe_kq(act_fn(xq @ wq, act), out_bits)


def int8_payload_ref(qx, qw, scale, *, out_bits=(4, 10), act="identity"):
    """The int8 datapath on payloads already quantized: exact int32 sums,
    one rescale by the combined scale, the activation, then ``kq_out``."""
    y = int8_dot(qx, qw).to(torch.float32) * scale
    return maybe_kq(act_fn(y, act), out_bits)


def fxp_matmul_int8_ref(x, w, *, xa_bits=(4, 10), w_bits=(2, 12),
                        out_bits=(4, 10), act="identity"):
    qx, sx = quantize_int8_auto(x, xa_bits)
    qw, sw = quantize_int8_auto(w, w_bits)
    return int8_payload_ref(qx, qw, sx * sw, out_bits=out_bits, act=act)
