"""Fused decode prologue: RMSNorm + QKV projection + RoPE in one call.

Port of ``repro/kernels/decode_prologue.py``.  For the decode slot batch
``x [B, 1, D]`` it computes, in the compute dtype of ``x``, exactly what
``layers.apply_norm`` + ``layers._project_qkv`` compute: the RMSNorm of each
row (rounded to the compute dtype), the three projections against the f32
master weights cast to the compute dtype, the QKV biases, and the
half-rotation RoPE of q and k (v is never rotated).

The int8 datapath quantizes the weights per tensor (absmax) outside the
kernels, once per call, as the JAX package does; the kernels quantize each
normed row by its absmax, multiply at int32 and rescale once.

The CUDA kernel is ``csrc/decode_prologue.cu``; ``prologue_plain`` is its
plain PyTorch version.  It computes the RMSNorm in the rows kernel's own
order (thread-strided quads summed by fused multiply-adds, then each
warp's butterfly, then the warps in order) and divides where the kernel
divides, so on the int8 datapath, whose sums are exact, it equals the
kernel bit for bit on any device.  ``fused_prologue`` runs the plain version only for
CPU tensors; a CUDA tensor launches the kernel or raises.

``_plan`` picks the launch.  The q, k and v projections are one space of
``H + 2*Hkv`` heads; a CTA owns a strip of up to ``PAIRS`` rotation pairs
(j, j + hd/2) of one head, so RoPE stays inside it.  Where the strips
cannot give every SM a CTA, D is split into up to ``MAX_SPLITS``
tile-aligned ranges whose CTAs form a thread-block cluster and sum their
partials in shared memory.  Rows go 8 or 16 a pass, so B <= 16 reads W
once.  A small first launch norms (and int8: quantizes) the rows once,
k-major, into scratch; the main launch streams them through one ring with
W and is its programmatic dependent.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from repro_torch import _build
from repro_torch.kernels import ops as kops
from repro_torch.kernels.common import int8_dot, sm_count, tuned
from repro_torch.quant.int8 import quantize_int8, quantize_int8_absmax

_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_FN = {}

# csrc/decode_prologue.cu's constants
PAIRS = 32                # rotation pairs a strip (64 columns)
STRIP = 2 * PAIRS
MAX_SPLITS = 8            # the portable thread-block cluster size
# k-rows of W a ring stage (8 KB of the strip) by the element size of W, and
# the bytes a staged row of W is padded to
TILE_K = {4: 32, 1: 128}
_PITCH = {4: STRIP * 4 + 16, 1: STRIP + 16}
_STAGES = 4
# the rows kernel's block: threads, and warps of 32
THREADS, WARPS = 256, 8


class Plan(NamedTuple):
    """One launch: ``grid`` (strips, passes, splits) of 256-thread CTAs;
    ``splits`` CTAs along D form a cluster; ``rows`` (8 or 16) a pass;
    ``bk`` k-rows a W tile (the splits are whole tiles); ``smem`` bytes a
    CTA; ``w_piece`` bytes a W copy that the head's halves allow (16, 4, or
    1 for int8), before the bases' alignment is checked."""

    strips: int
    passes: int
    splits: int
    rows: int
    bk: int
    smem: int
    w_piece: int

    @property
    def grid(self) -> tuple:
        return (self.strips, self.passes, self.splits)

    @property
    def ctas(self) -> int:
        return self.strips * self.passes * self.splits


def _strips(h: int, hkv: int, hd: int) -> list:
    """Strip s of the grid as ``(kind, head, j0, np)``: projection (0 q,
    1 k, 2 v), head, first pair and pairs; it owns columns ``j0 .. j0+np``
    and ``hd/2 + j0 .. hd/2 + j0+np`` of the head."""
    half = hd // 2
    out = []
    for kind, nh in enumerate((h, hkv, hkv)):
        for head in range(nh):
            for j0 in range(0, half, PAIRS):
                out.append((kind, head, j0, min(PAIRS, half - j0)))
    return out


def _k_ranges(plan: Plan, d: int) -> list:
    """The D range ``(lo, hi)`` of each split, in split order."""
    nt = -(-d // plan.bk)
    s = plan.splits
    return [(min(i * nt // s * plan.bk, d), min((i + 1) * nt // s * plan.bk,
                                                 d)) for i in range(s)]


def _smem(rows: int, bk: int, wb: int, xc_bytes: int) -> int:
    """Shared memory of one CTA (``Smem::TOTAL`` in the .cu): a ring of
    stages that each hold W's tile and the normed rows' tile (``xc_bytes``
    a value) for the same ``bk`` k-rows; the cluster's inbox; the rows'
    activation scales."""
    stage = bk * _PITCH[wb] + bk * rows * xc_bytes
    return _STAGES * stage + rows * STRIP * 4 + rows * 4


def _plan(b: int, d: int, h: int, hkv: int, hd: int, n_sm: int,
          datapath: str = "int8", x_bytes: int = 2,
          splits: Optional[int] = None) -> Plan:
    """The launch of one prologue: B rows of width D against H + 2*Hkv heads
    of ``hd``.  Rows go ``rows`` = 8 (B <= 8) or 16 a pass.  S is the least
    power of two that gives every one of the ``n_sm`` SMs a CTA, at most
    ``MAX_SPLITS`` and the number of W tiles.  The normed rows stream
    through the ring with W, so no D is too wide.  ``x_bytes``: the
    compute dtype's size (4 f32, 2 bf16).  ``splits`` forces S (any power
    of two up to ``MAX_SPLITS`` and the tiles), as the card's edge checks
    do."""
    if hd <= 0 or hd % 2:
        raise ValueError(f"decode_prologue: head dim {hd} is not even")
    wb = 1 if datapath == "int8" else 4
    bk = TILE_K[wb]
    nt = -(-d // bk)
    strips = (h + 2 * hkv) * -(-(hd // 2) // PAIRS)
    piece = next(p for p in (16, 4, 1) if (hd // 2) * wb % p == 0)
    rows = 8 if b <= 8 else 16
    passes = -(-b // rows)
    if splits is None:
        s = 1
        while 2 * s <= min(MAX_SPLITS, nt) and strips * passes * s < n_sm:
            s *= 2
    elif 1 <= splits <= min(MAX_SPLITS, nt) and splits & (splits - 1) == 0:
        s = splits
    else:
        raise ValueError(f"decode_prologue: no plan with {splits} splits of "
                         f"{nt} tiles")
    smem = _smem(rows, bk, wb, 1 if datapath == "int8" else x_bytes)
    return Plan(strips, passes, s, rows, bk, smem, piece)


def tuned_plan(b: int, d: int, h: int, hkv: int, hd: int, n_sm: int,
               datapath: str, x_bytes: int) -> Plan:
    """``_plan``'s launch through the tune cache (``common.tuned``)."""
    return Plan(*tuned(
        "decode_prologue", (b, d, h, hkv, hd, datapath, x_bytes), n_sm,
        lambda: _plan(b, d, h, hkv, hd, n_sm, datapath, x_bytes)))


def _lib():
    if not _FN:
        fn = _build.load("decode_prologue").decode_prologue_launch
        # x, nscale, wq, wk, wv, wscale, bq, bk, bv, pos, q, k, v;
        # B, D, H, Hkv, hd, use_rope; theta, eps; x_bf16, int8, S, rows, vx,
        # wp; xp, sx; stream
        fn.argtypes = ([_VP] * 13 + [_I] * 6 + [_F, _F] + [_I] * 6
                       + [_VP] * 3)
        fn.restype = ctypes.c_int
        _FN["launch"] = fn
    return _FN["launch"]


# ---------------------------------------------------------------------------
# Plain PyTorch version (the row math of the JAX package's _prologue_rows*)
# ---------------------------------------------------------------------------

def _div(a: torch.Tensor, b: float) -> torch.Tensor:
    """a / b rounded once (PyTorch's CUDA division by a Python number
    multiplies by its reciprocal instead)."""
    return a / torch.full_like(a, b)


def _fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor
           ) -> torch.Tensor:
    """``fmaf(a, b, c)``: a * b + c rounded to f32 once.  In f64 the
    product of two f32 is exact; the sum is rounded to odd (TwoSum's
    remainder moves an even result one ulp towards it), which a rounding
    to nearest f32 then turns into the correctly rounded f32 result."""
    p, c = a.double() * b.double(), c.double()
    s = p + c
    z = s - p
    err = (p - (s - z)) + (c - z)
    even = (s.view(torch.int64) & 1) == 0
    away = torch.where(err > 0, torch.full_like(s, float("inf")),
                       torch.full_like(s, -float("inf")))
    return torch.where((err != 0) & even, torch.nextafter(s, away),
                       s).to(torch.float32)


def _rms_rows(x2, nscale, eps: float):
    """Each row's RMSNorm as the rows kernel computes it: thread t of
    THREADS sums the squares of its quads (elements 4t .. 4t+3, then every
    4*THREADS on) by fused multiply-adds; each warp adds its 32 lanes by
    the xor butterfly (offsets 16, 8, 4, 2, 1; lane 0's sums); the warps'
    sums are added in order; then 1 / sqrt(sum / D + eps), and
    (x * inv) * scale rounded to the compute dtype."""
    dtype = x2.dtype
    xf = x2.to(torch.float32)
    rows, d = xf.shape
    quads = torch.nn.functional.pad(xf, (0, -d % (4 * THREADS))).reshape(
        rows, -1, THREADS, 4)
    ss = torch.zeros((rows, THREADS), dtype=torch.float32, device=xf.device)
    for j in range(quads.shape[1]):
        for i in range(4):
            v = quads[:, j, :, i]
            ss = _fma32(v, v, ss)
    lanes = ss.reshape(rows, WARPS, 32)
    while lanes.shape[-1] > 1:
        half = lanes.shape[-1] // 2
        lanes = lanes[..., :half] + lanes[..., half:]
    total = lanes[:, 0, 0]
    for w in range(1, WARPS):
        total = total + lanes[:, w, 0]
    inv = torch.reciprocal(torch.sqrt(_div(total, d) + eps))
    return ((xf * inv[:, None]) * nscale).to(dtype)


def _rope_rows(x3, positions, theta: float):
    """Half-rotation RoPE of [R, H, hd] rows at positions [R]."""
    hd = x3.shape[-1]
    half = hd // 2
    freqs = 1.0 / (theta ** _div(torch.arange(0, half, dtype=torch.float32,
                                              device=x3.device), half))
    angles = positions[..., None].to(torch.float32) * freqs
    cos = torch.cos(angles)[:, None, :]
    sin = torch.sin(angles)[:, None, :]
    x1, x2 = torch.chunk(x3.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x3.dtype)


def _finish(q, k, v, biases, positions, *, use_rope, theta, dt):
    if biases is not None:
        bq, bk, bv = biases
        q = q + bq.to(dt)
        k = k + bk.to(dt)
        v = v + bv.to(dt)
    if use_rope:
        q = _rope_rows(q, positions, theta)
        k = _rope_rows(k, positions, theta)
    return q, k, v


def prologue_plain(x2, nscale, wq2, wk2, wv2, biases, positions, *,
                   wscales=None, use_rope: bool, theta: float, eps: float,
                   h: int, hkv: int, hd: int):
    """The kernel's function in plain PyTorch.  ``wscales`` [3] marks the
    int8 datapath (w*2 are then int8 payloads)."""
    dt = x2.dtype
    xn = _rms_rows(x2, nscale, eps)
    if wscales is None:
        q = (xn @ wq2.to(dt)).reshape(-1, h, hd)
        k = (xn @ wk2.to(dt)).reshape(-1, hkv, hd)
        v = (xn @ wv2.to(dt)).reshape(-1, hkv, hd)
    else:
        xf = xn.to(torch.float32)
        amax = torch.amax(torch.abs(xf), dim=-1)
        sx = torch.where(amax > 0, _div(amax, 127.0), torch.ones_like(amax))
        qx = quantize_int8(xf, sx[:, None])

        def proj(qw, sw, heads):
            acc = int8_dot(qx, qw).to(torch.float32)
            return (acc * (sx[:, None] * sw)).to(dt).reshape(-1, heads, hd)
        q = proj(wq2, wscales[0], h)
        k = proj(wk2, wscales[1], hkv)
        v = proj(wv2, wscales[2], hkv)
    return _finish(q, k, v, biases, positions, use_rope=use_rope,
                   theta=theta, dt=dt)


# ---------------------------------------------------------------------------
# The wrapper
# ---------------------------------------------------------------------------

def fused_prologue(x2, nscale, wq2, wk2, wv2, biases, positions, *,
                   wscales: Optional[torch.Tensor] = None, use_rope: bool,
                   theta: float, eps: float, h: int, hkv: int, hd: int):
    """x2 [B, D] in the compute dtype (f32 or bf16); w*2 [D, heads*hd] f32
    masters, or int8 payloads with ``wscales`` [3] f32; biases None or
    (bq [H,hd], bk, bv [Hkv,hd]) f32; positions [B] int32.
    Returns q [B,H,hd], k [B,Hkv,hd], v [B,Hkv,hd] in the compute dtype."""
    stat = dict(use_rope=use_rope, theta=theta, eps=eps, h=h, hkv=hkv, hd=hd)
    if x2.device.type == "cpu":
        return prologue_plain(x2, nscale, wq2, wk2, wv2, biases, positions,
                              wscales=wscales, **stat)
    return _launch(x2, nscale, wq2, wk2, wv2, biases, positions, wscales,
                   **stat)


fused_prologue.launches = 0


def _launch(x2, nscale, wq2, wk2, wv2, biases, positions, wscales, *,
            use_rope, theta, eps, h, hkv, hd, plan: Optional[Plan] = None):
    """One launch; ``plan`` defaults to the tune cache's (``tuned_plan``; a
    check may force another split count, which bypasses the cache)."""
    dev = x2.device
    if dev.type != "cuda":
        raise RuntimeError(f"decode_prologue: no kernel for {dev}")
    if x2.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"decode_prologue: compute dtype {x2.dtype}")
    b, d = x2.shape
    int8 = wscales is not None
    wdt = torch.int8 if int8 else torch.float32
    tensors = [x2, nscale, wq2, wk2, wv2, positions]
    if biases is not None:
        tensors += list(biases)
    if int8:
        tensors.append(wscales)
    for t in tensors:
        if t.device != dev or not t.is_contiguous():
            raise ValueError("decode_prologue: operands must be contiguous "
                             f"on {dev}")
    if (wq2.shape != (d, h * hd) or wk2.shape != (d, hkv * hd)
            or wv2.shape != (d, hkv * hd)
            or {wq2.dtype, wk2.dtype, wv2.dtype} != {wdt}):
        raise ValueError("decode_prologue: weight shapes/dtypes do not match")
    if nscale.dtype != torch.float32 or positions.dtype != torch.int32:
        raise TypeError("decode_prologue: nscale f32 and positions int32")
    if biases is not None and any(bb.dtype != torch.float32 for bb in biases):
        raise TypeError("decode_prologue: biases must be f32")
    if plan is None:
        plan = tuned_plan(b, d, h, hkv, hd, sm_count(dev),
                          "int8" if int8 else "emulate", x2.element_size())
    # scratch: the normed rows, k-major by pass and whole W tiles (int8
    # payloads or the compute dtype), and their activation scales
    rows_p = plan.passes * plan.rows
    xp = torch.empty((rows_p * -(-d // plan.bk) * plan.bk,),
                     dtype=torch.int8 if int8 else x2.dtype, device=dev)
    sx = torch.empty((rows_p,), dtype=torch.float32, device=dev)
    q = torch.empty((b, h, hd), dtype=x2.dtype, device=dev)
    k = torch.empty((b, hkv, hd), dtype=x2.dtype, device=dev)
    v = torch.empty((b, hkv, hd), dtype=x2.dtype, device=dev)
    bq, bk, bv = (None, None, None) if biases is None else (
        bb.data_ptr() for bb in biases)
    # 16-byte pieces of x and nscale; W's copies as wide as its bases allow
    vx = int(d * x2.element_size() % 16 == 0 and x2.data_ptr() % 16 == 0
             and nscale.data_ptr() % 16 == 0)
    wp = plan.w_piece
    while any(w.data_ptr() % wp for w in (wq2, wk2, wv2)):
        wp = 4 if wp == 16 else 1
    err = _lib()(
        x2.data_ptr(), nscale.data_ptr(), wq2.data_ptr(), wk2.data_ptr(),
        wv2.data_ptr(), wscales.data_ptr() if int8 else None, bq, bk, bv,
        positions.data_ptr(), q.data_ptr(), k.data_ptr(), v.data_ptr(),
        b, d, h, hkv, hd, int(use_rope), float(theta), float(eps),
        int(x2.dtype == torch.bfloat16), int(int8), plan.splits, plan.rows,
        vx, wp, xp.data_ptr(), sx.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "decode_prologue")
    fused_prologue.launches += 1
    return q, k, v


# ---------------------------------------------------------------------------
# Public entry (geometry gates kept from the JAX package)
# ---------------------------------------------------------------------------

def prologue_supported(cfg) -> bool:
    """rmsnorm front, standard GQA/MHA heads (no MLA), aligned head dim."""
    return (cfg.norm_kind == "rmsnorm" and not cfg.use_mla
            and cfg.num_heads > 0 and cfg.head_dim % 8 == 0
            and cfg.d_model % 8 == 0)


def prologue_active(cfg, x) -> bool:
    """Supported geometry, a kernel backend installed, one token per row."""
    return (prologue_supported(cfg) and kops.current_backend() != "off"
            and x.shape[1] == 1)


def decode_prologue(norm_params, attn_params, x, cfg, positions):
    """Fused RMSNorm + QKV + RoPE for one decode token per slot.

    x: [B, 1, D]; positions: [B] int32.  Returns (q [B,1,H,hd],
    k [B,1,Hkv,hd], v [B,1,Hkv,hd]).
    """
    b, t, d = x.shape
    if t != 1:
        raise ValueError(f"decode_prologue takes one token per row: {x.shape}")
    wq, wk, wv = attn_params["wq"], attn_params["wk"], attn_params["wv"]
    _, h, hd = wq.shape
    hkv = wk.shape[1]
    wq2 = wq.reshape(d, h * hd)
    wk2 = wk.reshape(d, hkv * hd)
    wv2 = wv.reshape(d, hkv * hd)
    nscale = norm_params["scale"]
    biases = None
    if cfg.qkv_bias:
        biases = (attn_params["bq"], attn_params["bk"], attn_params["bv"])
    stat = dict(use_rope=bool(cfg.use_rope), theta=float(cfg.rope_theta),
                eps=float(cfg.norm_eps), h=h, hkv=hkv, hd=hd)
    wscales = None
    if kops.current_backend() == "int8":
        # per-tensor weight quantization, once per call, outside the kernel
        (wq2, swq), (wk2, swk), (wv2, swv) = (
            quantize_int8_absmax(w) for w in (wq2, wk2, wv2))
        wscales = torch.stack([swq, swk, swv])
    q, k, v = fused_prologue(x[:, 0, :].contiguous(), nscale, wq2, wk2, wv2,
                             biases, positions.to(torch.int32),
                             wscales=wscales, **stat)
    return q[:, None], k[:, None], v[:, None]
