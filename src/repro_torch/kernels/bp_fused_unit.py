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

The CUDA kernel (``csrc/bp_fused_unit.cu``) tiles W over both axes: a CTA
owns ``TI`` Din rows x ``TO`` Dout columns, keeps its dW in registers for
the whole token loop and writes W_new itself, so dW never reaches device
memory.  Its G_out is a partial sum over its Dout slice: the ``cluster``
CTAs of neighbouring slices sum their partials in shared memory (a
thread-block cluster), and where Dout needs more slices than a cluster
holds, the ``chunks`` clusters write their sums to scratch that a second
launch adds in order.  ``_plan`` picks the cluster size and the chunk
count; any Dout fits.  ``bp_fused_unit_plain`` is its plain PyTorch
version.  ``bp_fused_unit`` runs the plain version only for CPU tensors; a
CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from repro_torch import _build
from repro_torch.kernels import ref
from repro_torch.kernels.common import (ACT_CODES, bits_args, check_operands,
                                        cuda_device, lr_args, sm_count,
                                        tuned)
from repro_torch.quant.int8 import int8_spec

# csrc/bp_fused_unit.cu's constants
TI = 16                   # Din rows a CTA
TO = 32                   # Dout columns a CTA (a slice)
BT = 64                   # tokens a block
MAX_CLUSTER = 8           # Dout slices a cluster (the portable size)
SMEM_MAX = 232448         # shared memory a CTA may have on Hopper
# Where the token loop is longer than CLUSTER_MAX_T, the Dout slices skip
# the cluster and write their partial G_out to scratch for the second
# launch: on the H100 the cluster's barrier cost ~0.9 us a 64-token block
# more than that path, which pays one launch (crossover ~4 blocks), as
# long as the scratch stays under SCRATCH_MAX bytes.
CLUSTER_MAX_T = 4 * BT
SCRATCH_MAX = 64 << 20
_NPART = 64               # absmax partials
_THREADS = 128
_NS = 4                   # ring stages
_LDN, _LDT, _GP = TO + 16, BT + 16, BT + 4   # tile row pitches
# a row is copied in 16-byte pieces when its length is a multiple of these
_VEC_ELEMS = {"emulate": 4, "int8": 16}


class Plan(NamedTuple):
    """One launch of ``TI`` x ``TO`` tiles: ``cluster`` Dout slices summed
    in a cluster; ``chunks`` clusters along Dout, whose sums a second
    launch adds (``scratch`` elements, [chunks, T, Din], when ``chunks >
    1``); ``grid`` (Dout slices, Din tiles); ``smem`` bytes a CTA."""

    cluster: int
    chunks: int
    grid: tuple
    smem: int
    scratch: int

    @property
    def ctas(self) -> int:
        return self.grid[0] * self.grid[1]


def _smem(datapath: str) -> int:
    """Shared memory of one CTA (``I8`` / ``Emu`` in the .cu): a ring of
    ``_NS`` token blocks (G, X and Z's share), the transposed tiles, q_w(W)
    and the three inbox buffers."""
    if datapath == "int8":
        stage = BT * _LDN + BT * (TI + 16) + 4 * BT * TI
        return (_NS * stage + TO * _LDT + TI * _LDT + TI * _LDN
                + 3 * 4 * BT * TI + 4 * (_THREADS // 32))
    stage = BT * TO + 2 * BT * TI
    return 4 * (_NS * stage + TO * _GP + TO * TI + 3 * BT * TO)


def _plan(t: int, din: int, dout: int, n_sm: int, datapath: str = "emulate",
          cluster: Optional[int] = None) -> Plan:
    """The cluster size and Dout chunking of one frame.  ``cluster`` is
    the number of Dout slices, rounded up to a power of two, at most
    ``MAX_CLUSTER``; wider Douts take ``ceil(slices / cluster)`` chunks.  A
    token loop longer than ``CLUSTER_MAX_T`` takes no cluster (one slice a
    chunk) while the scratch of the chunk sums stays under
    ``SCRATCH_MAX``.  The tiles are fixed: 16 x 32 gives 128 CTAs at
    LeNet's 256 x 256 for the ``n_sm`` = 132 SMs of an H100, and 32-row
    tiles ran slower at every width measured (256, 2048, 2816).  Any power
    of two up to ``MAX_CLUSTER`` may be forced as ``cluster``, as the
    card's edge checks do."""
    slices = -(-dout // TO)
    if cluster is None:
        cluster = min(MAX_CLUSTER, 1 << max(slices - 1, 0).bit_length())
        if t > CLUSTER_MAX_T and 4 * slices * t * din <= SCRATCH_MAX:
            cluster = 1
    if not (1 <= cluster <= MAX_CLUSTER and cluster & (cluster - 1) == 0):
        raise ValueError(f"bp_fused_unit: no plan with cluster={cluster}")
    chunks = -(-slices // cluster)
    return Plan(cluster, chunks, (chunks * cluster, -(-din // TI)),
                _smem(datapath), chunks * t * din if chunks > 1 else 0)


def tuned_plan(t: int, din: int, dout: int, n_sm: int,
               datapath: str) -> Plan:
    """``_plan``'s launch through the tune cache (``common.tuned``)."""
    cluster, chunks, grid, smem, scratch = tuned(
        "bp_fused_unit", (t, din, dout, datapath), n_sm,
        lambda: _plan(t, din, dout, n_sm, datapath))
    return Plan(cluster, chunks, tuple(grid), smem, scratch)


def _vec(t: torch.Tensor, datapath: str) -> int:
    """1 when each row of ``t`` is 16-byte aligned (16-byte copies)."""
    return int(t.shape[1] % _VEC_ELEMS[datapath] == 0
               and t.data_ptr() % 16 == 0)


_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_FN = {}


def _lib():
    if not _FN:
        lib = _build.load("bp_fused_unit")
        for name, args in (
                # g, w, x, z, lr_ptr; lr; gout, wout, scratch; T, Din, Dout,
                # C, chunks, vg, vx, vz, 3x (on, I, F) of g, w, w_out, act;
                # stream
                ("bp_fused_unit_emulate",
                 [_VP] * 5 + [_F] + [_VP] * 3 + [_I] * 18 + [_VP]),
                # g, w, x, z, g_scale, x_scale, lr_ptr; lr; partial;
                # w_exact; w_scale; w_qmin, w_qmax; gout, wout, scratch; T,
                # Din, Dout, C, chunks, vg, vx, vz, 2x (on, I, F) of g,
                # w_out, act; stream
                ("bp_fused_unit_int8",
                 [_VP] * 7 + [_F, _VP, _I, _F, _I, _I] + [_VP] * 3
                 + [_I] * 15 + [_VP])):
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
    return _launch(g, w, x, z, lr, g_bits, w_bits, w_out_bits, act, datapath,
                   g_scale, x_scale)


bp_fused_unit.launches = 0


def _launch(g, w, x, z, lr, g_bits, w_bits, w_out_bits, act, datapath,
            g_scale, x_scale, plan: Optional[Plan] = None):
    """Launch the kernel by the tune cache's plan (``tuned_plan``), or by
    ``plan`` where one is given (which bypasses the cache)."""
    dev = cuda_device("bp_fused_unit", (g, w, x, z))
    fns = _lib()
    t, dout = g.shape
    din = w.shape[0]
    if plan is None:
        plan = tuned_plan(t, din, dout, sm_count(dev), datapath)
    gout = torch.empty((t, din), dtype=torch.float32, device=dev)
    wout = torch.empty((din, dout), dtype=torch.float32, device=dev)
    scratch = None
    if plan.scratch:
        scratch = torch.empty(plan.scratch, device=dev, dtype=(
            torch.int32 if datapath == "int8" else torch.float32))
    lr_val, lr_t = lr_args(lr, dev)
    lr_ptr = None if lr_t is None else lr_t.data_ptr()
    stream = torch.cuda.current_stream(dev).cuda_stream
    shape = (None if scratch is None else scratch.data_ptr(), t, din, dout,
             plan.cluster, plan.chunks, _vec(g, datapath),
             _vec(x, datapath), _vec(z, "emulate"))
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
            gout.data_ptr(), wout.data_ptr(), *shape,
            *bits_args(g_bits), *bits_args(w_out_bits), ACT_CODES[act],
            stream)
    else:
        err = fns["bp_fused_unit_emulate"](
            g.data_ptr(), w.data_ptr(), x.data_ptr(), z.data_ptr(), lr_ptr,
            lr_val, gout.data_ptr(), wout.data_ptr(), *shape,
            *bits_args(g_bits), *bits_args(w_bits), *bits_args(w_out_bits),
            ACT_CODES[act], stream)
    _build.check(err, "bp_fused_unit")
    bp_fused_unit.launches += 1
    return gout, wout
