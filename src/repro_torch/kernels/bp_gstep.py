"""bp_gstep: the G-chain step ``G_i = kq_g((G @ Wᵀ) ⊙ f'(Z))``, on Hopper.

Port of ``repro/kernels/bp_gstep.py::bp_gstep`` (paper Eq. 8).  Shapes:
G [T, Dout], W [Din, Dout] (forward orientation), Z [T, Din] or ``None``
(then ``act`` must be "identity": the dense unit's dx = dz @ Wᵀ); the
result is G_i [T, Din] f32.  Two datapaths:

  * ``datapath="emulate"`` -- G, W, Z f32; f32 multiply-adds.
  * ``datapath="int8"`` -- G, W int8 payloads, exact int32 accumulation, one
    rescale by the combined scale ``s_g * s_w`` (a device scalar, so no host
    sync), then the derivation unit and the (I,F) rounding.  With
    ``int32_out`` (``z=None``, no ``g_bits``) it stores the int32 sums
    themselves: the partial dx of a rank whose Dout is a shard, which the
    caller sums over ranks in int32 and rescales once.

The CUDA kernel is ``csrc/bp_gstep.cu``; ``bp_gstep_plain`` is its plain
PyTorch version.  ``bp_gstep`` runs the plain version only for CPU tensors;
a CUDA tensor launches the kernel or raises.  Ragged shapes are masked in
the kernel: no divisibility is required.

``_plan`` picks the launch from the shapes alone, one launch a call.
Dout of at least ``SHORT_DOUT`` takes the tiled path: 128x128 output
tiles, G and W streamed through a ring of Dout tiles (int8 on the tensor
cores, f32 as register tiles); where the tiles leave SMs idle, Dout is
split into up to ``MAX_SPLITS`` tile-aligned ranges whose CTAs form a
thread-block cluster and sum their partial tiles in rank order.  A
shorter contraction (the LeNet head's Dout 10) takes the short path: a
CTA of 4, 8 or 16 rows x 64 columns stages its G rows and W rows once and
a thread computes 4 consecutive outputs of a row.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from repro_torch import _build
from repro_torch.kernels import ref
from repro_torch.kernels.common import (ACT_CODES, bits_args,
                                        check_operands, cuda_device,
                                        sm_count, tuned)

_VP, _I = ctypes.c_void_p, ctypes.c_int
_FN = {}

TILE_T, TILE_DIN = 128, 128        # the tiled path's output tile
TILE_K = {"emulate": 32, "int8": 64}   # its Dout a staged tile
SHORT_DOUT = 16                    # Dout below this takes the short path
SHORT_COLS = 64                    # the short path's output columns a CTA
SHORT_ROWS = (16, 8, 4)            # its rows a CTA, most first
MAX_SPLITS = 8                     # Dout splits: a portable cluster
MAX_GRID_Y = 65535                 # CUDA's limit of the Din tiles


class Plan(NamedTuple):
    path: str        # "short" (Dout below SHORT_DOUT) or "tiled"
    rows: int        # output rows (tokens) a CTA
    cols: int        # output columns (Din) a CTA
    grid: tuple      # (token tiles, Din tiles)
    splits: int      # Dout splits of a tile (the cluster size), tiled only
    vec: bool        # rows of G and W are whole 16-byte pieces (shape only)


def _plan(t: int, din: int, dout: int, n_sm: int, datapath: str = "emulate",
          rows: Optional[int] = None, splits: Optional[int] = None) -> Plan:
    """The launch of one call, G [t, dout] and W [din, dout] -> [t, din].

    Dout below ``SHORT_DOUT`` takes the short path with the most
    ``SHORT_ROWS`` rows a CTA whose CTAs still number a third of the
    ``n_sm`` SMs (else the fewest): a CTA stages 64 W rows whatever its
    rows, so more rows stage less a thread and fewer give more CTAs;
    ``rows`` forces one of them.  Otherwise the tiled path, with the most
    splits S (a power of two <= ``MAX_SPLITS``, at most one a Dout tile of
    ``TILE_K[datapath]``) that keep tiles x S within two thirds of the
    SMs (a cluster's CTAs must fit in one GPC; more splits than that ran
    slower on the H100); ``splits`` forces one.  ``vec``: Dout elements
    make whole 16-byte pieces, so that G and W are staged in 16-byte
    copies (the launch also needs aligned bases).
    ``tools/bp_gstep_sweep.py`` times every row and split count."""
    if datapath not in TILE_K:
        raise ValueError(f"bp_gstep: unknown datapath {datapath!r}")
    esz = 1 if datapath == "int8" else 4
    vec = dout * esz % 16 == 0
    if dout < SHORT_DOUT:
        cols, col_tiles = SHORT_COLS, -(-din // SHORT_COLS)
        if rows is None:
            rows = next((r for r in SHORT_ROWS
                         if 3 * -(-t // r) * col_tiles >= n_sm),
                        SHORT_ROWS[-1])
        elif rows not in SHORT_ROWS:
            raise ValueError(f"bp_gstep: short-path rows {rows} not in "
                             f"{SHORT_ROWS}")
        path = "short"
    elif rows not in (None, TILE_T):
        raise ValueError(f"bp_gstep: the tiled path takes {TILE_T} rows")
    else:
        path, rows, cols = "tiled", TILE_T, TILE_DIN
    grid = (-(-t // rows), -(-din // cols))
    if grid[1] > MAX_GRID_Y:
        raise ValueError(f"bp_gstep: Din {din} needs {grid[1]} column "
                         f"tiles, more than {MAX_GRID_Y}")
    nt = -(-dout // TILE_K[datapath])      # at most 1 on the short path
    if splits is None:
        splits = 1
        while (2 * splits <= min(MAX_SPLITS, nt)
               and 3 * 2 * splits * grid[0] * grid[1] <= 2 * n_sm):
            splits *= 2
    elif splits & (splits - 1) or not 1 <= splits <= min(MAX_SPLITS, nt):
        raise ValueError(f"bp_gstep: {splits} splits of {nt} Dout tiles")
    return Plan(path, rows, cols, grid, splits, vec)


def tuned_plan(t: int, din: int, dout: int, n_sm: int,
               datapath: str) -> Plan:
    """``_plan``'s launch through the tune cache (``common.tuned``), keyed
    as the product G @ Wᵀ: m = t, n = din, k = dout.  The datapath "int32"
    (the int8 product's int32 mode) has entries of its own and the int8
    datapath's plan."""
    dp = "int8" if datapath == "int32" else datapath
    plan = tuned("bp_gstep", (t, din, dout, datapath), n_sm,
                 lambda: _plan(t, din, dout, n_sm, dp))
    path, rows, cols, grid, splits, vec = plan
    return Plan(path, rows, cols, tuple(grid), splits, vec)


def _k_ranges(plan: Plan, dout: int, datapath: str) -> list:
    """The Dout range ``(lo, hi)`` of each split, in split order."""
    bk = TILE_K[datapath]
    nt, s = -(-dout // bk), plan.splits
    return [(min(i * nt // s * bk, dout), min((i + 1) * nt // s * bk, dout))
            for i in range(s)]


def _lib():
    if not _FN:
        lib = _build.load("bp_gstep")
        for name, args in (
                # g, w, z, out; T, Din, Dout, (on, I, F) of g, act, path,
                # rows, splits, vec; stream
                ("bp_gstep_emulate", [_VP] * 4 + [_I] * 11 + [_VP]),
                # g, w, scale, z, out; T, Din, Dout, (on, I, F), act, path,
                # rows, splits, vec, raw; stream
                ("bp_gstep_int8", [_VP] * 5 + [_I] * 12 + [_VP])):
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = args, ctypes.c_int
            _FN[name] = fn
    return _FN


def bp_gstep_plain(g, w, z, *, g_bits=(2, 12), act="relu",
                   datapath="emulate", scale=None, int32_out=False):
    """The kernel's function in plain PyTorch, f32 [T, Din] (int32 with
    ``int32_out``)."""
    if datapath == "int8":
        return ref.bp_gstep_payload_ref(g, w, z, None if int32_out else scale,
                                        g_bits=g_bits, act=act)
    return ref.bp_gstep_ref(g, w, z, g_bits=g_bits, act=act)


def bp_gstep(g: torch.Tensor, w: torch.Tensor, z: Optional[torch.Tensor], *,
             g_bits=(2, 12), act: str = "relu", datapath: str = "emulate",
             scale: Optional[torch.Tensor] = None,
             int32_out: bool = False) -> torch.Tensor:
    """g: [T, Dout]; w: [Din, Dout]; z: [T, Din] or None. Returns f32
    [T, Din].

    emulate: g/w/z f32.
    int8:    g/w int8 payloads; ``scale`` is the combined dequant scale
             s_g * s_w (an f32 scalar tensor or a Python float).  With
             ``int32_out`` (int8, ``z=None``, no ``g_bits``) the result is
             the int32 sums [T, Din], and ``scale`` is not read.
    """
    if int32_out and (datapath != "int8" or z is not None
                      or g_bits is not None):
        raise ValueError("bp_gstep: int32_out takes the int8 datapath, "
                         "z=None and no g_bits")
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
    scale = check_operands("bp_gstep", datapath, (g, w), scale,
                           need_scale=not int32_out)
    tensors = (g, w) if z is None else (g, w, z)
    if all(x.device.type == "cpu" for x in tensors):
        return bp_gstep_plain(g, w, z, g_bits=g_bits, act=act,
                              datapath=datapath, scale=scale,
                              int32_out=int32_out)
    return _launch(g, w, z, g_bits, act, datapath, scale, tensors,
                   int32_out=int32_out)


bp_gstep.launches = 0


def _launch(g, w, z, g_bits, act, datapath, scale, tensors,
            plan: Optional[Plan] = None, int32_out: bool = False):
    """One launch; ``plan`` defaults to the tune cache's (``tuned_plan``,
    under the datapath "int32" in the int32 mode; a check may force
    another row count of the short path or split count of the tiled, which
    bypasses the cache)."""
    dev = cuda_device("bp_gstep", tensors)
    fns = _lib()
    t, dout = g.shape
    din = w.shape[0]
    if plan is None:
        plan = tuned_plan(t, din, dout, sm_count(dev),
                          "int32" if int32_out else datapath)
    out = torch.empty((t, din), dtype=torch.int32 if int32_out
                      else torch.float32, device=dev)
    zp = None if z is None else z.data_ptr()
    stream = torch.cuda.current_stream(dev).cuda_stream
    launch = (int(plan.path == "tiled"), plan.rows, plan.splits,
              int(plan.vec and g.data_ptr() % 16 == 0
                  and w.data_ptr() % 16 == 0))
    if datapath == "int8":
        # the int32 mode reads no scale: a null pointer
        sp = (0 if int32_out
              else scale.reshape(1).contiguous().data_ptr())
        err = fns["bp_gstep_int8"](
            g.data_ptr(), w.data_ptr(), sp, zp, out.data_ptr(),
            t, din, dout, *bits_args(g_bits), ACT_CODES[act], *launch,
            int(int32_out), stream)
    else:
        err = fns["bp_gstep_emulate"](
            g.data_ptr(), w.data_ptr(), zp, out.data_ptr(), t, din, dout,
            *bits_args(g_bits), ACT_CODES[act], *launch, stream)
    _build.check(err, "bp_gstep")
    bp_gstep.launches += 1
    return out
