"""Paged-attention decode over a block pool that stays in device memory.

Port of ``repro/kernels/paged_attention.py``.  For one layer and one decode
token per slot: gather each slot's blocks through its block table,
dequantize int8 rows by their per-token scale, expand the GQA heads, softmax
over key positions ``kpos <= lens[b]`` and take the weighted sum of V.

The CUDA kernel is ``csrc/paged_attention.cu``; ``paged_attention_plain`` is
its plain PyTorch version (the JAX package's ``_ref`` math: f32 scores, P
cast to the compute dtype before P.V).  ``paged_attention`` runs the plain
version only for CPU tensors; a CUDA tensor launches the kernel or raises.

The kernel splits each slot's positions into chunks of ``CHUNK`` (``_chunks``)
and runs two launches per call over (slot, KV head, chunk): scores with
per-chunk softmax stats, then P.V per chunk, summed by the last chunk's CTA.
Its scratch (``_scratch_shapes``, one allocation a call) comes from here,
and so does one zeroed int32 ticket counter per (slot, KV head), kept
across calls for each (device, stream) (the kernel leaves it zero again):
calls on one stream run in order, so they never share a ticket, and calls
on two streams get two buffers.  The kernel takes ``hd`` a multiple of 8
and pool bases aligned to 8 elements (at most 16 bytes); it refuses
anything else.  The chunk count is the call's tune-cache decision
(``tuned_chunks``); the kernel's CHUNK is compiled in, so a cached count
that disagrees with it is refused.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch import _build
from repro_torch.kernels.common import sm_count, tuned

NEG_INF = -1e30  # matches models.layers.NEG_INF

_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_FN = {}
_KV_KIND = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_COUNTERS = {}

CHUNK = 64  # positions per CTA (csrc/paged_attention.cu)


def _lib():
    if not _FN:
        fn = _build.load("paged_attention").paged_attention_launch
        # q, kp, vp, ks, vs, tables, lens, probs, stats, part, counters, out;
        # B, H, Hkv, hd, bs, M, S; scale; q_bf16, kv_kind; stream
        fn.argtypes = [_VP] * 12 + [_I] * 7 + [_F] + [_I, _I] + [_VP]
        fn.restype = ctypes.c_int
        _FN["launch"] = fn
    return _FN["launch"]


def _chunks(m: int, bs: int) -> list:
    """The positions ``[0, m*bs)`` of a slot's table cut into the kernel's
    chunks, in order: ``[(start, stop), ...]``, CHUNK positions each but
    the last."""
    n = m * bs
    return [(s, min(s + CHUNK, n)) for s in range(0, n, CHUNK)]


def tuned_chunks(n: int, bs: int, m: int, hkv: int, hd: int, groups: int,
                 item: int, n_sm: int) -> int:
    """The chunk count of a call through the tune cache (``common.tuned``),
    keyed as the JAX package's paged tuner: pool blocks, block size,
    blocks a slot, KV heads, head dim, groups and the pool's element size.
    Raises where a cached count is not the kernel's (``_chunks``)."""
    s = tuned("paged_attention", (n, bs, m, hkv, hd, groups, item), n_sm,
              lambda: len(_chunks(m, bs)))
    if s != len(_chunks(m, bs)):
        raise ValueError(f"paged_attention: a tune-cache decision of {s} "
                         f"chunks for {m} blocks of {bs}; the kernel takes "
                         f"{len(_chunks(m, bs))}")
    return s


def _scratch_shapes(b: int, h: int, hd: int, m: int, bs: int) -> dict:
    """The f32 scratch one call uses, in this order in one allocation: the
    scores, each chunk's softmax stats (max, sum of exp) and each chunk's
    P.V.  The chunk count is ``len(_chunks(m, bs))``."""
    s = -(-m * bs // CHUNK)
    return {"probs": (b, h, m * bs), "stats": (b, h, s, 2),
            "part": (b, h, s, hd)}


def _counters(dev, stream: int, n: int) -> torch.Tensor:
    """At least ``n`` zeroed int32 ticket counters for calls on ``stream``
    of ``dev``; the kernel returns each to zero, so they are zeroed once,
    when first allocated."""
    buf = _COUNTERS.get((dev, stream))
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=dev)
        _COUNTERS[(dev, stream)] = buf
    return buf


def _expand_heads(k, groups: int):
    """[B, T, Hkv, hd] -> [B, T, Hkv*groups, hd] (GQA repeat)."""
    if groups == 1:
        return k
    b, t, hkv, hd = k.shape
    return k[:, :, :, None, :].expand(b, t, hkv, groups, hd).reshape(
        b, t, hkv * groups, hd)


def gather_kv(pool_l: dict, tables, dt):
    """Each slot's blocks in table order -> K, V [B, M*bs, Hkv, hd] in dt."""
    tables = tables.long()
    kk = pool_l["k"][tables]
    vv = pool_l["v"][tables]
    b, m, bs, hkv, hd = kk.shape
    kk = kk.reshape(b, m * bs, hkv, hd)
    vv = vv.reshape(b, m * bs, hkv, hd)
    if "k_scale" in pool_l:
        ks = pool_l["k_scale"][tables].reshape(b, m * bs)
        vs = pool_l["v_scale"][tables].reshape(b, m * bs)
        kk = kk.to(dt) * ks[..., None, None].to(dt)
        vv = vv.to(dt) * vs[..., None, None].to(dt)
    else:
        kk = kk.to(dt)
        vv = vv.to(dt)
    return kk, vv


def attend(q, kk, vv, qpos, groups: int, scale: float):
    """Masked softmax attention: q [B,C,H,hd]; kk/vv [B,T,Hkv,hd] in the
    compute dtype; qpos [B,C] (kpos <= qpos attends).  Returns [B,C,H,hd]."""
    dt = q.dtype
    kk = _expand_heads(kk, groups)
    vv = _expand_heads(vv, groups)
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32),
                     kk.to(torch.float32)) * scale
    kpos = torch.arange(kk.shape[1], device=q.device)
    ok = kpos[None, None, :] <= qpos[:, :, None]               # [B, C, T]
    s = s + torch.where(ok, 0.0, NEG_INF)[:, None]
    p = torch.softmax(s, dim=-1).to(dt)
    return torch.einsum("bhqk,bkhd->bqhd", p, vv)


def paged_attention_plain(q, pool_l: dict, tables, lens, *, groups: int,
                          scale: float):
    """The kernel's function in plain PyTorch: q [B,H,hd] -> [B,H,hd]."""
    kk, vv = gather_kv(pool_l, tables, q.dtype)
    return attend(q[:, None], kk, vv, lens[:, None], groups, scale)[:, 0]


def paged_attention(q, pool_l: dict, tables, lens, *, groups: int,
                    scale: float):
    """Paged-attention decode for one layer.

    q: [B, H, hd] (post-rope query of the incoming token); pool_l: one
    layer's pool leaves ({"k","v"[,"k_scale","v_scale"]}, k/v [N,bs,Hkv,hd]);
    tables: [B, M] int32; lens: [B] int32, the incoming token's position.
    """
    if q.device.type == "cpu":
        return paged_attention_plain(q, pool_l, tables, lens, groups=groups,
                                     scale=scale)
    return _launch(q, pool_l, tables, lens, groups, scale)


paged_attention.launches = 0


def _launch(q, pool_l, tables, lens, groups, scale):
    dev = q.device
    if dev.type != "cuda":
        raise RuntimeError(f"paged_attention: no kernel for {dev}")
    b, h, hd = q.shape
    kp, vp = pool_l["k"], pool_l["v"]
    n, bs, hkv, hd2 = kp.shape
    m = tables.shape[1]
    int8 = "k_scale" in pool_l
    if (hd2 != hd or h != hkv * groups or vp.shape != kp.shape
            or vp.dtype != kp.dtype or kp.dtype not in _KV_KIND
            or (kp.dtype == torch.int8) != int8
            or q.dtype not in (torch.float32, torch.bfloat16)):
        raise ValueError("paged_attention: q/pool shapes or dtypes disagree")
    if tables.dtype != torch.int32 or lens.dtype != torch.int32 \
            or tables.shape[0] != b or lens.shape != (b,):
        raise ValueError("paged_attention: tables [B,M] and lens [B] int32")
    tensors = [q, kp, vp, tables, lens]
    if int8:
        tensors += [pool_l["k_scale"], pool_l["v_scale"]]
    for t in tensors:
        if t.device != dev or not t.is_contiguous():
            raise ValueError("paged_attention: operands must be contiguous "
                             f"on {dev}")
    out = torch.empty_like(q)
    tuned_chunks(n, bs, m, hkv, hd, groups, kp.element_size(), sm_count(dev))
    shapes = _scratch_shapes(b, h, hd, m, bs)
    n_probs, n_stats, n_part = (math.prod(v) for v in shapes.values())
    scratch = torch.empty(n_probs + n_stats + n_part, dtype=torch.float32,
                          device=dev)
    ptr = scratch.data_ptr()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib()(
        q.data_ptr(), kp.data_ptr(), vp.data_ptr(),
        pool_l["k_scale"].data_ptr() if int8 else None,
        pool_l["v_scale"].data_ptr() if int8 else None,
        tables.data_ptr(), lens.data_ptr(), ptr, ptr + 4 * n_probs,
        ptr + 4 * (n_probs + n_stats),
        _counters(dev, stream, b * hkv).data_ptr(), out.data_ptr(),
        b, h, hkv, hd, bs, m, shapes["stats"][2], float(scale),
        int(q.dtype == torch.bfloat16), _KV_KIND[kp.dtype], stream)
    _build.check(err, "paged_attention")
    paged_attention.launches += 1
    return out
