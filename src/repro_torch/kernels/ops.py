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

The tuners (``tune_blocks``, ``tune_fused``, ``tune_paged``,
``tune_prologue``) and the tune cache keep the JAX package's names and
lifecycle: prime at driver start-up from the run's shapes
(``train_tune_shapes``, ``serve_tune_shapes``), ``tune_cache_snapshot()``
into the checkpoint's and the serve snapshot's ``extra``,
``load_tune_cache()`` on restore (no-clobber, ``restored:`` provenance),
``dump_tune_cache()``/``REPRO_TUNE_CACHE`` for a file.  The JAX tuners
budget a TPU core's VMEM and send a shape that does not fit to jnp; here
nothing gates the kernels (every shape launches, the kernels mask ragged
edges), so a decision is the launch each kernel's own ``_plan`` picks for
the card's SM count: the K or token split, whose f32 partial sums set the
emulate datapath's bits.  The cache (``kernels.common``) is keyed without
the SM count, so a resumed run replays the original run's splits on any
card.  ``resolve_double_buffer`` has no counterpart: each CUDA kernel
keeps its own ``cp.async`` ring.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Optional

import torch

from repro_torch.kernels import bp_fused_unit as _FU
from repro_torch.kernels import bp_gstep as _GS
from repro_torch.kernels import decode_prologue as _DP
from repro_torch.kernels import fxp_matmul as _FM
from repro_torch.kernels import paged_attention as _PA
from repro_torch.kernels import sgd_dw_update as _SD
from repro_torch.kernels.bp_fused_unit import bp_fused_unit
from repro_torch.kernels.bp_gstep import bp_gstep
from repro_torch.kernels.common import (TUNE_KINDS, clear_tune_cache,
                                        default_sm_count, dump_tune_cache,
                                        foreign_tune_entries, load_tune_cache,
                                        tune_cache_snapshot, tune_cache_stats,
                                        tune_key)
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


# ---------------------------------------------------------------------------
# The tuners and the priming of the tune cache
# ---------------------------------------------------------------------------

def _datapath(itemsize: int) -> str:
    return "int8" if itemsize == 1 else "emulate"


def _resolve(kind: str, key: tuple, n_sm: int):
    """The decision of ``kind`` for a cache key (``TUNE_KINDS`` fields),
    through the kernel's own ``tuned_plan``."""
    if kind == "fxp_matmul":
        m, n, k, dp, xb, wb = key
        return _FM.tuned_plan(m, k, n, n_sm, dp, xb, wb)
    if kind == "bp_gstep":
        m, n, k, dp = key
        return _GS.tuned_plan(m, n, k, n_sm, dp)
    if kind == "sgd_dw_update":
        m, n, k, dp = key
        return _SD.tuned_plan(k, m, n, n_sm, dp)
    if kind == "bp_fused_unit":
        return _FU.tuned_plan(*key[:3], n_sm, key[3])
    if kind == "decode_prologue":
        b, d, h, hkv, hd, dp, xb = key
        return _DP.tuned_plan(b, d, h, hkv, hd, n_sm, dp, xb)
    if kind == "paged_attention":
        return _PA.tuned_chunks(*key, n_sm)
    raise KeyError(f"no tune-cache kind {kind!r}; the kinds are "
                   f"{tuple(TUNE_KINDS)}")


def tune_blocks(m: int, n: int, k: int, itemsize: int = 4, *,
                kernel: str = "fxp_matmul", x_itemsize: Optional[int] = None,
                n_sm: Optional[int] = None):
    """The launch of the product [m, k] @ [k, n] by ``kernel``:
    ``fxp_matmul`` (X @ W, the forward), ``bp_gstep`` (G @ Wᵀ: m tokens,
    k = Dout, n = Din) or ``sgd_dw_update`` (Xᵀ @ G: m = Din, k tokens,
    n = Dout).  ``itemsize`` 1 is the int8 datapath, else emulate with W's
    element size (``x_itemsize`` X's, default the same; bp_gstep and
    sgd_dw_update take f32).  ``n_sm`` defaults to the card's SM count
    (``common.DEFAULT_SM_COUNT`` without one).  Decisions persist in the
    tune cache; restored entries win."""
    key = (int(m), int(n), int(k), _datapath(itemsize))
    if kernel == "fxp_matmul":
        key += (int(x_itemsize or itemsize), int(itemsize))
    elif kernel not in ("bp_gstep", "sgd_dw_update"):
        raise ValueError(f"tune_blocks: no matmul kernel {kernel!r}")
    return _resolve(kernel, key, n_sm or default_sm_count())


def tune_fused(t: int, din: int, dout: int, itemsize: int = 4, *,
               n_sm: Optional[int] = None):
    """bp_fused_unit's plan (cluster, Dout chunks) of a TDM frame."""
    return _resolve("bp_fused_unit",
                    (int(t), int(din), int(dout), _datapath(itemsize)),
                    n_sm or default_sm_count())


def tune_paged(num_blocks: int, block_size: int, max_blocks_per_seq: int,
               kv_heads: int, head_dim: int, groups: int,
               itemsize: int = 4, *, n_sm: Optional[int] = None) -> int:
    """paged_attention's chunk count for a pool of ``num_blocks`` blocks of
    ``block_size`` tokens whose tables hold ``max_blocks_per_seq`` blocks;
    ``itemsize`` is the pool's element size."""
    key = (num_blocks, block_size, max_blocks_per_seq, kv_heads, head_dim,
           groups, itemsize)
    return _resolve("paged_attention", tuple(int(v) for v in key),
                    n_sm or default_sm_count())


def tune_prologue(d: int, h: int, hkv: int, hd: int, itemsize: int = 4, *,
                  rows: int = 1, x_itemsize: int = 2,
                  n_sm: Optional[int] = None):
    """decode_prologue's plan for ``rows`` decode rows of width ``d``;
    ``itemsize`` is the weight payload's size (1 on the int8 datapath),
    ``x_itemsize`` the compute dtype's."""
    key = (int(rows), int(d), int(h), int(hkv), int(hd),
           _datapath(itemsize), int(x_itemsize))
    return _resolve("decode_prologue", key, n_sm or default_sm_count())


def prime_tune_cache(shapes: dict, *, n_sm: Optional[int] = None) -> dict:
    """Derive and cache the decisions a run will need (call at driver
    start-up, after any checkpoint restore: restored entries are cache
    hits and are not re-derived).  ``shapes`` maps a kind of
    ``TUNE_KINDS`` to its cache keys (``train_tune_shapes``,
    ``serve_tune_shapes``).  Returns {snapshot key: decision}."""
    n_sm = n_sm or default_sm_count()
    return {tune_key(kind, tuple(key)): _resolve(kind, tuple(key), n_sm)
            for kind, keys in shapes.items() for key in keys}


def _dtype_bytes(name: str) -> int:
    return torch.empty((), dtype=getattr(torch, name)).element_size()


def _unit_products(cfg) -> list:
    """The dense units of one of ``cfg``'s transformer blocks:
    ``(din, dout, w_bytes)`` with W's element size on the emulate datapath
    (the f32 masters; the output projection's W is cast to the compute
    dtype).  MLA, the experts and the Mamba layers are plain products."""
    xb = _dtype_bytes(cfg.compute_dtype)
    d = int(cfg.d_model)
    out = []
    if cfg.num_heads and not cfg.use_mla:
        hw = int((cfg.padded_heads or cfg.num_heads) * cfg.head_dim)
        kvw = int(cfg.num_kv_heads * cfg.head_dim)
        out += [(d, hw, 4), (d, kvw, 4), (hw, d, xb)]
    if cfg.d_ff and cfg.family != "moe":
        out += _mlp_products(cfg)
    return out


def _mlp_products(cfg) -> list:
    d, ff = int(cfg.d_model), int(cfg.d_ff)
    return [(d, ff, 4), (ff, d, 4)]


def _engine_keys(t: int, products, xb: int) -> dict:
    """The cache keys of dense_fwd / dense_bwd_dx / dense_bwd_dw at ``t``
    tokens for each product, on both datapaths."""
    keys = {"fxp_matmul": [], "bp_gstep": [], "sgd_dw_update": []}
    for din, dout, wb in products:
        for dp, xbytes, wbytes in (("int8", 1, 1), ("emulate", xb, wb)):
            keys["fxp_matmul"].append((t, dout, din, dp, xbytes, wbytes))
            keys["bp_gstep"].append((t, din, dout, dp))
            keys["sgd_dw_update"].append((din, dout, t, dp))
    return keys


def train_tune_shapes(cfg, global_batch: int, seq_len: int) -> dict:
    """The ``prime_tune_cache`` shape set of a train run: what the
    engine's dense units launch (``dense_fwd``, ``dense_bwd_dx``,
    ``dense_bwd_dw``) for each distinct product of ``cfg``'s units at
    t = batch x seq tokens (a vlm's patches count; an encoder's units run
    at batch x ``encoder_seq``), on both datapaths."""
    b = int(global_batch)
    t = b * (int(seq_len)
             + (int(cfg.num_patches) if cfg.family == "vlm" else 0))
    xb = _dtype_bytes(cfg.compute_dtype)
    stacks = [(t, _unit_products(cfg))]
    if cfg.family == "encdec":
        stacks.append((b * int(cfg.encoder_seq), _unit_products(cfg)))
    shapes: dict = {}
    for tt, products in stacks:
        for kind, keys in _engine_keys(tt, products, xb).items():
            shapes.setdefault(kind, {}).update(dict.fromkeys(keys))
    return {kind: list(keys) for kind, keys in shapes.items()}


def serve_tune_shapes(cfg, *, num_blocks: int, block_size: int,
                      max_blocks_per_seq: int, cache_itemsize: int = 4,
                      num_slots: int = 1) -> dict:
    """The ``prime_tune_cache`` shape set of the paged serving path: the
    paged-attention chunking for the pool, the decode prologue and the
    decode rows' MLP products at M = ``num_slots``, on both datapaths."""
    d = int(cfg.d_model)
    h = int(cfg.padded_heads or cfg.num_heads)
    hkv = int(cfg.num_kv_heads)
    hd = int(cfg.head_dim)
    xb = _dtype_bytes(cfg.compute_dtype)
    m = int(num_slots)
    shapes = {
        "paged_attention": [(int(num_blocks), int(block_size),
                             int(max_blocks_per_seq), hkv, hd,
                             max(1, h // max(hkv, 1)), int(cache_itemsize))],
        "decode_prologue": [(m, d, h, hkv, hd, "int8", xb),
                            (m, d, h, hkv, hd, "emulate", xb)],
        "fxp_matmul": []}
    if cfg.d_ff and cfg.family != "moe":
        for din, dout, wb in _mlp_products(cfg):
            shapes["fxp_matmul"] += [(m, dout, din, "int8", 1, 1),
                                     (m, dout, din, "emulate", xb, wb)]
    return shapes


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


def dense_fwd(x2, w, backend: str, *, rx=None, rw=None):
    """z = x2 @ w at f32 through the selected datapath. x2: [M,K], w: [K,N].

    Returns the raw pre-activation z; the caller applies the activation.
    The emulate path hands bf16 activations to the kernel as they are: it
    widens them to f32 as it loads them, which is exact.  ``rx``/``rw``
    (int8 only): the absmax reductions of an operand that is one rank's
    shard (``quant.int8.absmax_scale``'s ``reduce``).
    """
    if backend == "int8":
        qx, sx = quantize_int8_absmax(x2, rx)
        qw, sw = quantize_int8_absmax(w, rw)
        return fxp_matmul(qx, qw, out_bits=None, act="identity",
                          datapath="int8", scale=sx * sw)
    return fxp_matmul(x2, w, xa_bits=None, w_bits=None, out_bits=None,
                      act="identity")


def dense_fwd_partial(x2, w, backend: str, *, rx=None, rw=None):
    """A rank's share of z = x2 @ w where K is sharded over ranks:
    (int32 sums, the combined scale) on the int8 datapath (fxp_matmul's
    int32 mode; sum them over the ranks in int32, then ``rescale_int32``),
    (f32 partial z, None) on emulate.  The absmax reductions as in
    ``dense_fwd``."""
    if backend == "int8":
        qx, sx = quantize_int8_absmax(x2, rx)
        qw, sw = quantize_int8_absmax(w, rw)
        return fxp_matmul(qx, qw, out_bits=None, act="identity",
                          datapath="int8", int32_out=True), sx * sw
    return dense_fwd(x2, w, backend), None


def rescale_int32(acc, scale):
    """An int32 sum through the int8 epilogue's one f32 multiply (the
    kernels' ``(float)v * scale``): bitwise what a kernel that summed all
    of K itself stores; with ``scale`` None, ``acc`` itself (emulate)."""
    if scale is None:
        return acc
    return acc.to(torch.float32) * scale


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


def dense_bwd_dx(dz, w, backend: str, *, rdz=None, rw=None):
    """dx = dz @ wᵀ through bp_gstep's ``z=None`` form.  dz: [M, N];
    w: [K, N] (bp_gstep's G [T, Dout] and W [Din, Dout]) -> [M, K].
    ``rdz``/``rw``: absmax reductions as in ``dense_fwd``."""
    if backend == "int8":
        qg, sg = quantize_int8_absmax(dz, rdz)
        qw, sw = quantize_int8_absmax(w, rw)
        return bp_gstep(qg, qw, None, g_bits=None, act="identity",
                        datapath="int8", scale=sg * sw)
    return bp_gstep(dz.to(torch.float32), w.to(torch.float32), None,
                    g_bits=None, act="identity")


def dense_bwd_dx_partial(dz, w, backend: str, *, rdz=None, rw=None):
    """A rank's share of dx = dz @ wᵀ where N is sharded over ranks:
    (int32 sums, the combined scale) on int8 (bp_gstep's int32 mode),
    (f32 partial dx, None) on emulate; as ``dense_fwd_partial``."""
    if backend == "int8":
        qg, sg = quantize_int8_absmax(dz, rdz)
        qw, sw = quantize_int8_absmax(w, rw)
        return bp_gstep(qg, qw, None, g_bits=None, act="identity",
                        datapath="int8", int32_out=True), sg * sw
    return dense_bwd_dx(dz, w, backend), None


def dense_bwd_dw(x2, dz, backend: str, *, rx=None, rdz=None):
    """dw = x2ᵀ @ dz through sgd_dw_update's dW-only (``w=None``) form.
    x2: [M, K]; dz: [M, N] -> [K, N].  ``rx``/``rdz``: absmax reductions
    as in ``dense_fwd``."""
    if backend == "int8":
        qx, sx = quantize_int8_absmax(x2, rx)
        qg, sg = quantize_int8_absmax(dz, rdz)
        return sgd_dw_update(qx, qg, None, 0.0, datapath="int8",
                             scale=sx * sg)
    return sgd_dw_update(x2.to(torch.float32), dz.to(torch.float32), None,
                         0.0)
