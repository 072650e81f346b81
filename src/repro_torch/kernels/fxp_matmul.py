"""fxp_matmul: fixed-point (I,F) matmul + fused activation, on Hopper.

Port of ``repro/kernels/fxp_matmul.py::fxp_matmul`` (the TaxoNN PE forward
op ``Y = kq_out(act(kq_a(X) @ kq_w(W)))``).  Two datapaths:

  * ``datapath="emulate"`` -- X, W in f32 or bf16, rounded onto their (I,F)
    grids as they load (``None`` bits = passthrough), f32 multiply-adds, then
    the activation and the optional output rounding.
  * ``datapath="int8"`` -- X, W as int8 payloads, exact int32 accumulation,
    one rescale by the combined scale ``s_x * s_w`` (a device scalar, so no
    host sync), then the activation and the optional output rounding.
    With ``int32_out`` it stores the int32 sums themselves (no rescale, no
    activation, no rounding): the partial product of a rank whose K is a
    shard, which the caller sums over ranks in int32 and rescales once.

The CUDA kernel is ``csrc/fxp_matmul.cu``; ``fxp_matmul_plain`` is its plain
PyTorch version.  ``fxp_matmul`` runs the plain version only for CPU tensors;
a CUDA tensor launches the kernel or raises.  Ragged shapes are masked in
the kernel: no divisibility is required.

``_plan`` picks the launch.  M <= 16 (every serving call) takes the decode
path: a CTA owns a 64-column strip of Y and streams its W through
shared memory; where the strips cannot give every SM a CTA, K is split
into up to ``PLAN_MAX_SPLITS`` tile-aligned ranges whose CTAs form a
thread-block cluster and sum their partials in shared memory.  Larger M
takes 64x64 output tiles (f32 register tiles, or int8 tensor cores), with
the same K split where the tiles cannot fill the card.  Either way one
launch a product.  ``_launch`` takes its plan from the tune cache
(``tuned_plan``): a cached decision, else ``_plan``'s, recorded.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from repro_torch import _build
from repro_torch.kernels import ref
from repro_torch.kernels.common import (ACT_CODES, bits_args, cuda_device,
                                        sm_count, tuned)

_VP, _I = ctypes.c_void_p, ctypes.c_int
_FN = {}

MAX_SPLITS = 16        # the CTAs of a thread-block cluster on Hopper
# the plans stop at 8: on the H100 a cluster of 16 cost more than the SMs
# it filled (8x2816x1024: 16 strips x 8 splits ran faster than x 16)
PLAN_MAX_SPLITS = 8
DECODE_ROWS = 16       # M up to this takes the decode path (8 or 16 rows)
STRIP = 64             # output columns a CTA, on both paths
TILE_M = 64            # output rows a CTA of the tiled path
# decode: k-rows of W a staged tile, one 8 KB tile of the strip, by the
# element size of W; the staged K range of X (as it is, and k-major) is
# capped at X_SMEM bytes
DECODE_BK = {4: 32, 2: 64, 1: 128}
X_SMEM = 64 * 1024
# tiled: k a staged tile, and the fewest k a split may have (a shorter one
# costs more in the sum than it saves)
TILED_BK = {"emulate": 16, "int8": 64}
MIN_SPLIT_K = {"emulate": 64, "int8": 64}


class Plan(NamedTuple):
    path: str        # "decode" (M <= 16) or "tiled"
    strip: int       # output columns a CTA
    bk: int          # k a staged tile; the splits are whole tiles
    splits: int      # S, a power of two <= MAX_SPLITS: the cluster size
    vx: bool         # rows of X are whole 16-byte pieces (shape only)
    vw: bool         # rows of W likewise


def _pow2_floor(v: int) -> int:
    return 1 << (max(1, v).bit_length() - 1)


def _x_bytes(m: int, k: int, bk: int, splits: int, datapath: str,
             x_bytes: int) -> int:
    """Shared memory of the decode path's staged X in the largest split:
    8 or 16 rows, as they are and k-major (f32, or int8 4 k a word)."""
    rows = 8 if m <= 8 else 16
    k_split = -(-(-(-k // bk)) // splits) * bk     # ceil(ceil(k/bk)/S) tiles
    return k_split * rows * (x_bytes + (1 if datapath == "int8" else 4))


def _plan(m: int, k: int, n: int, n_sm: int, datapath: str = "emulate",
          x_bytes: Optional[int] = None,
          w_bytes: Optional[int] = None) -> Plan:
    """The launch of one product X [m, k] @ W [k, n].

    Decode (m <= ``DECODE_ROWS``): S is the least power of two that gives
    every one of the ``n_sm`` SMs a CTA (strips x S >= n_sm), but at most
    ``PLAN_MAX_SPLITS`` and the number of K tiles; raised further (up to
    ``MAX_SPLITS``) while the split's staged X exceeds ``X_SMEM``.  A
    product whose X cannot fit even then takes the tiled path.  Tiled: S
    keeps at most one CTA an SM over the 64x64 tiles, each split at least
    ``MIN_SPLIT_K`` deep, at most ``PLAN_MAX_SPLITS``, rounded down to a
    power of two.  Split s covers K tiles ``[s*nt//S, (s+1)*nt//S)`` of
    ``nt = ceil(k / bk)`` (``_k_ranges``).  ``x_bytes``/``w_bytes``: the
    element sizes (emulate: 4 for f32, 2 for bf16; int8: 1)."""
    xb = x_bytes or (1 if datapath == "int8" else 4)
    wb = w_bytes or (1 if datapath == "int8" else 4)
    vx, vw = k * xb % 16 == 0, n * wb % 16 == 0
    strips = -(-n // STRIP)
    if m <= DECODE_ROWS:
        bk = DECODE_BK[wb]
        nt = -(-k // bk)
        s = 1
        while 2 * s <= min(PLAN_MAX_SPLITS, nt) and strips * s < n_sm:
            s *= 2
        while (2 * s <= min(MAX_SPLITS, nt)
               and _x_bytes(m, k, bk, s, datapath, xb) > X_SMEM):
            s *= 2
        if _x_bytes(m, k, bk, s, datapath, xb) <= X_SMEM:
            return Plan("decode", STRIP, bk, s, vx, vw)
    bk = TILED_BK[datapath]
    nt = -(-k // bk)
    tiles = -(-m // TILE_M) * strips
    per_min = -(-MIN_SPLIT_K[datapath] // bk)
    s = min(nt // per_min, n_sm // tiles, PLAN_MAX_SPLITS)
    return Plan("tiled", STRIP, bk, _pow2_floor(s), vx, vw)


def tuned_plan(m: int, k: int, n: int, n_sm: int, datapath: str,
               x_bytes: int, w_bytes: int) -> Plan:
    """``_plan``'s launch through the tune cache (``common.tuned``): the
    cached decision for this product, datapath and element sizes, else
    ``_plan``'s for ``n_sm`` SMs, recorded.  The datapath "int32" (the
    int8 product's int32 mode) has entries of its own and the int8
    datapath's plan."""
    dp = "int8" if datapath == "int32" else datapath
    return Plan(*tuned(
        "fxp_matmul", (m, n, k, datapath, x_bytes, w_bytes), n_sm,
        lambda: _plan(m, k, n, n_sm, dp, x_bytes, w_bytes)))


def _k_ranges(plan: Plan, k: int) -> list:
    """The K range ``(lo, hi)`` of each split, in split order."""
    nt = -(-k // plan.bk)
    s = plan.splits
    return [(min(i * nt // s * plan.bk, k), min((i + 1) * nt // s * plan.bk,
                                                 k)) for i in range(s)]


def _lib():
    if not _FN:
        lib = _build.load("fxp_matmul")
        for name, args in (
                # x, w, y; m, n, k, x_bf16, w_bf16, 3x(on, I, F), act,
                # path, S, vx, vw; stream
                ("fxp_matmul_emulate", [_VP] * 3 + [_I] * 19 + [_VP]),
                # x, w, scale, y; m, n, k, (on, I, F) of out, act, path, S,
                # vx, vw, raw; stream
                ("fxp_matmul_int8", [_VP] * 4 + [_I] * 12 + [_VP])):
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = args, ctypes.c_int
            _FN[name] = fn
    return _FN


def fxp_matmul_plain(x, w, *, xa_bits=(4, 10), w_bits=(2, 12),
                     out_bits=(4, 10), act="identity", datapath="emulate",
                     scale=None, int32_out=False):
    """The kernel's function in plain PyTorch, f32 [M, N] (int32 with
    ``int32_out``)."""
    if datapath == "int8":
        return ref.int8_payload_ref(x, w, None if int32_out else scale,
                                    out_bits=out_bits, act=act)
    return ref.fxp_matmul_ref(x, w, xa_bits=xa_bits, w_bits=w_bits,
                              out_bits=out_bits, act=act)


def fxp_matmul(x: torch.Tensor, w: torch.Tensor, *,
               xa_bits=(4, 10), w_bits=(2, 12), out_bits=(4, 10),
               act: str = "identity", datapath: str = "emulate",
               scale: Optional[torch.Tensor] = None,
               int32_out: bool = False) -> torch.Tensor:
    """x: [M, K]; w: [K, N]. Returns f32 [M, N].

    emulate: x/w f32 or bf16, rounded in-kernel by (xa_bits, w_bits).
    int8:    x/w int8 payloads; ``scale`` is the combined dequant scale
             s_x * s_w (an f32 scalar tensor or a Python float).  With
             ``int32_out`` (int8 only; no ``out_bits``, act identity) the
             result is the int32 sums [M, N], and ``scale`` is not read.
    """
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"fxp_matmul: bad shapes {tuple(x.shape)} @ "
                         f"{tuple(w.shape)}")
    if act not in ACT_CODES:
        raise ValueError(f"fxp_matmul: unknown activation {act!r}")
    if int32_out and (datapath != "int8" or out_bits is not None
                      or act != "identity"):
        raise ValueError("fxp_matmul: int32_out takes the int8 datapath, "
                         "no out_bits and the identity activation")
    if datapath == "int8":
        if x.dtype != torch.int8 or w.dtype != torch.int8:
            raise TypeError(f"int8 datapath needs int8 payloads, got "
                            f"{x.dtype}, {w.dtype}")
        if not int32_out:
            if scale is None:
                raise ValueError("int8 datapath needs the combined scale")
            scale = torch.as_tensor(scale, dtype=torch.float32,
                                    device=x.device)
    elif datapath == "emulate":
        for t in (x, w):
            if t.dtype not in (torch.float32, torch.bfloat16):
                raise TypeError(f"emulate datapath takes f32/bf16, got {t.dtype}")
    else:
        raise ValueError(f"unknown datapath {datapath!r}")
    if x.device.type == "cpu" and w.device.type == "cpu":
        return fxp_matmul_plain(x, w, xa_bits=xa_bits, w_bits=w_bits,
                                out_bits=out_bits, act=act,
                                datapath=datapath, scale=scale,
                                int32_out=int32_out)
    return _launch(x, w, xa_bits, w_bits, out_bits, act, datapath, scale,
                   int32_out=int32_out)


fxp_matmul.launches = 0


def _launch(x, w, xa_bits, w_bits, out_bits, act, datapath, scale,
            plan: Optional[Plan] = None, int32_out: bool = False):
    """One launch; ``plan`` defaults to the tune cache's (``tuned_plan``,
    under the datapath "int32" in the int32 mode; a check may pass another
    split count, which bypasses the cache)."""
    dev = cuda_device("fxp_matmul", (x, w))
    fns = _lib()
    m, k = x.shape
    n = w.shape[1]
    if plan is None:
        plan = tuned_plan(m, k, n, sm_count(dev),
                          "int32" if int32_out else datapath,
                          x.element_size(), w.element_size())
    y = torch.empty((m, n), dtype=torch.int32 if int32_out
                    else torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    launch = (int(plan.path == "tiled"), plan.splits,
              int(plan.vx and x.data_ptr() % 16 == 0),
              int(plan.vw and w.data_ptr() % 16 == 0))
    if datapath == "int8":
        # the int32 mode reads no scale: a null pointer
        sp = (0 if int32_out
              else scale.reshape(1).contiguous().data_ptr())
        err = fns["fxp_matmul_int8"](
            x.data_ptr(), w.data_ptr(), sp, y.data_ptr(),
            m, n, k, *bits_args(out_bits), ACT_CODES[act], *launch,
            int(int32_out), stream)
    else:
        err = fns["fxp_matmul_emulate"](
            x.data_ptr(), w.data_ptr(), y.data_ptr(), m, n, k,
            int(x.dtype == torch.bfloat16), int(w.dtype == torch.bfloat16),
            *bits_args(xa_bits), *bits_args(w_bits), *bits_args(out_bits),
            ACT_CODES[act], *launch, stream)
    _build.check(err, "fxp_matmul")
    fxp_matmul.launches += 1
    return y
