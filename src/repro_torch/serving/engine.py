"""Serving engine (port of ``serving/engine.py``): prefill + one-token
decode against contiguous per-slot caches for the dense, moe, ssm and
hybrid families, and the paged KV pool for the dense and moe families
without a sliding window.

Contiguous caches, stacked on leading layer axes, with the JAX package's
keys, shapes and dtypes, {"caches": ..., "pos": int32 scalar}:

  dense, moe : {"k", "v": [L, B, len, kv_heads, head_dim]}, a ring of
           len = min(swa_window, max_len) slots under a sliding window
  MLA    : {"ckv": [L, B, max_len, kv_lora_rank],
            "kpe": [L, B, max_len, qk_rope_dim]} (the latents and the
           shared rope key; no ring)
  ssm    : {"h": [L, B, H, N, P] f32, "conv": [L, B, K-1, d_inner + 2N]}
           (O(1) in the context)
  hybrid : {"attn": {"k", "v": [G, B, len, kv_heads, head_dim]},
            "mamba": {"h": [G, K, B, H, N, P] f32,
                      "conv": [G, K, B, K-1, d_inner + 2N]}}
           (the weight-tied block keeps one KV cache per application)

``pos`` is ONE position for the whole slot batch, as in the JAX package:
``decode_step`` writes every slot's token at ``pos`` and attends over
positions <= ``pos``, so the batch is well defined only for equal-length
prompts admitted together (the scheduler's contiguous mode); the Mamba
step ignores it.  ``pos`` stays a host tensor, the caches live on the
device and ``decode_step`` writes them IN PLACE; ``merge_slot`` writes a
one-row prefill's caches into a slot, on each leaf's batch axis.
``prefill`` installs ``kernel_backend or "auto"`` (int8 on CUDA) around
the prompt's forward; ``decode_step`` runs under the caller's backend.
The other families' caches (cross-attention, patches) wait for ROADMAP
A9e and raise.

The pool stores every layer's K/V in fixed-size blocks on a leading block
axis: [L, N_blocks, block, kv_heads, head_dim].  A request owns an ordered
block table (host side, see ``serving.paging``); the token at absolute
position p lives in table[p // block] at offset p % block.  Block 0 is the
reserved null block: masked-out slots write there and nothing reads it
unmasked.  ``cache_dtype=torch.int8`` stores int8 payloads with a per-token
absmax scale ([L, N, block] f32), so stored bytes do not depend on chunking
and prefix sharing reuses blocks exactly.

Unlike the JAX package, whose jitted steps return a new pool and donate the
old one, the port updates the pool IN PLACE: pool writes are ``index_put_``
into the layer's view of the pool tensors, and the functions return the
same pool dict they were given.  The layer scan is a Python loop.  The JAX
engine's ``_pool_gather`` is ``kernels.paged_attention.gather_kv`` here,
shared with the plain version of the paged-attention kernel.
"""
from __future__ import annotations

import torch

from typing import Optional

from repro_torch import resolve_device
from repro_torch.kernels import decode_prologue as DP
from repro_torch.kernels import paged_attention as PA
from repro_torch.kernels.ops import kernel_backend_ctx
from repro_torch.models import blocks as B
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.models import ssm as S
from repro_torch.models.config import ModelConfig

# ---------------------------------------------------------------------------
# Contiguous cache: init, decode step, prefill
# ---------------------------------------------------------------------------

def _stacked_zeros(one: dict, lead: tuple, device) -> dict:
    """Zeros on ``device`` shaped ``lead`` + each leaf of the one-layer
    template ``one`` (made on the meta device: shapes and dtypes only)."""
    return {k: torch.zeros(lead + tuple(v.shape), dtype=v.dtype,
                           device=device) for k, v in one.items()}


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int,
                      cache_dtype=torch.bfloat16, device=None) -> dict:
    """The zeroed contiguous decode state on ``device`` (CUDA unless the
    caller names another)."""
    device = resolve_device(device)
    B.require_ported(cfg)
    if cfg.family == "ssm":
        caches = _stacked_zeros(S.init_mamba_cache(cfg, batch, cache_dtype,
                                                   "meta"),
                                (cfg.num_layers,), device)
    elif cfg.family == "hybrid":
        G, K = lm.hybrid_groups(cfg)
        caches = {
            "attn": _stacked_zeros(L.init_kv_cache(cfg, batch, max_len,
                                                   cache_dtype, "meta"),
                                   (G,), device),
            "mamba": _stacked_zeros(S.init_mamba_cache(cfg, batch,
                                                       cache_dtype, "meta"),
                                    (G, K), device)}
    else:
        caches = _stacked_zeros(B.init_block_cache(cfg, batch, max_len,
                                                   cache_dtype, "meta"),
                                (cfg.num_layers,), device)
    return {"caches": caches, "pos": torch.zeros((), dtype=torch.int32)}


def _cache_at(caches: dict, at) -> dict:
    """One block's caches: views of the stacked leaves at ``at``, a cache
    index of ``lm.walk_stack``."""
    tree, i = at
    return {k: t[i] for k, t in (caches if tree is None
                                 else caches[tree]).items()}


def _slot_write(dst: dict, src: dict, i: int, axis: int) -> None:
    for k, t in dst.items():
        if isinstance(t, dict):
            _slot_write(t, src[k], i, axis)
        else:
            t.select(axis, i).copy_(src[k].select(axis, 0))


def merge_slot(cfg: ModelConfig, caches: dict, one: dict, i: int) -> dict:
    """Write a one-row prefill's caches ``one`` into slot ``i`` of the
    batched ``caches``, in place, on each leaf's batch axis: axis 1 of the
    [L, B, ...] and [G, B, ...] leaves, axis 2 of the hybrid's
    [G, K, B, ...] Mamba leaves.  (The JAX scheduler's ``merge`` writes
    ``dst[:, i]`` on every leaf, which on the hybrid's Mamba leaves is
    layer ``i`` of each group, broadcast over the batch: ROADMAP, "Facts
    about the reference".)"""
    if cfg.family == "hybrid":
        _slot_write(caches["attn"], one["attn"], i, 1)
        _slot_write(caches["mamba"], one["mamba"], i, 2)
    else:
        _slot_write(caches, one, i, 1)
    return caches


@torch.no_grad()
def decode_step(params, cfg: ModelConfig, state: dict, tokens):
    """One decode step. tokens: [B, 1] int32.  Returns (logits [B, V] f32,
    state), the caches written in place and ``pos`` advanced by one."""
    dt = lm.compute_dtype(cfg)
    pos = int(state["pos"])
    caches = state["caches"]
    x = _embed_tokens(params, cfg, tokens, dt)
    for kind, p, at in lm.walk_stack(params, cfg):
        step = (B.transformer_block_decode if kind == "attn"
                else B.mamba_block_decode)
        x, _ = step(p, x, cfg, _cache_at(caches, at), pos)
    logits = _logits(params, cfg, x)[:, 0, :]
    return logits, {"caches": caches,
                    "pos": torch.tensor(pos + 1, dtype=torch.int32)}


def prefill(params, cfg: ModelConfig, batch: dict, max_len: int,
            cache_dtype=torch.bfloat16, kernel_backend: Optional[str] = None):
    """Run the full-context forward, returning (last_logits [B, V] f32,
    decode state).  ``kernel_backend`` selects the dense-unit datapath of
    the prefill matmuls (None = "auto": off on the CPU, int8 on CUDA)."""
    device = params["embed"].device
    with kernel_backend_ctx(kernel_backend or "auto", device):
        return _prefill_impl(params, cfg, batch, max_len, cache_dtype)


@torch.no_grad()
def _prefill_impl(params, cfg: ModelConfig, batch: dict, max_len: int,
                  cache_dtype=torch.bfloat16):
    B.require_ported(cfg)
    device = params["embed"].device
    batch = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
    x, positions = lm.embed_input(params, cfg, batch)
    b, t = x.shape[0], x.shape[1]
    caches = init_decode_state(cfg, b, max_len, cache_dtype,
                               device)["caches"]
    for kind, p, at in lm.walk_stack(params, cfg):
        if kind == "attn":
            x, c = B.transformer_block_prefill(p, x, cfg, positions,
                                               max_len, cache_dtype)
        else:
            x, c = B.mamba_block_prefill(p, x, cfg, positions, cache_dtype)
        for k, dst in _cache_at(caches, at).items():
            dst.copy_(c[k])
    logits = _logits(params, cfg, x)[:, -1, :]
    return logits, {"caches": caches,
                    "pos": torch.tensor(t, dtype=torch.int32)}


def greedy_generate(params, cfg: ModelConfig, batch: dict, max_len: int,
                    num_steps: int, cache_dtype=torch.bfloat16,
                    kernel_backend: Optional[str] = None) -> torch.Tensor:
    """Prefill + greedy decode loop (the reference serving driver).
    Returns the generated tokens [B, num_steps] int32."""
    logits, state = prefill(params, cfg, batch, max_len, cache_dtype,
                            kernel_backend=kernel_backend)
    out = []
    tok = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
    for _ in range(num_steps):
        out.append(tok)
        logits, state = decode_step(params, cfg, state, tok)
        tok = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
    return torch.cat(out, dim=1)


# ---------------------------------------------------------------------------
# Paged KV pool
# ---------------------------------------------------------------------------

PAGED_FAMILIES = ("dense", "moe", "vlm")


def paged_supported(cfg: ModelConfig) -> bool:
    """Paged decode covers the GQA-KV attention families (the port serves
    dense and moe so); MLA latents, SWA rings, SSM state and
    cross-attention keep the contiguous path, as in the JAX package."""
    return (cfg.family in PAGED_FAMILIES and not cfg.use_mla
            and cfg.swa_window is None)


def init_paged_state(cfg: ModelConfig, num_blocks: int, block_size: int,
                     cache_dtype=torch.bfloat16, device=None) -> dict:
    """The zeroed paged KV pool on ``device`` (CUDA unless the caller names
    another: ``resolve_device``)."""
    device = resolve_device(device)
    if not paged_supported(cfg):
        raise ValueError(f"paged KV unsupported for {cfg.family} "
                         f"(mla={cfg.use_mla}, swa={cfg.swa_window})")
    shape = (cfg.num_layers, num_blocks, block_size, cfg.num_kv_heads,
             cfg.head_dim)
    if cache_dtype == torch.int8:
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(shape[:3], dtype=torch.float32,
                                       device=device),
                "v_scale": torch.zeros(shape[:3], dtype=torch.float32,
                                       device=device)}
    return {"k": torch.zeros(shape, dtype=cache_dtype, device=device),
            "v": torch.zeros(shape, dtype=cache_dtype, device=device)}


def quant_kv_rows(x: torch.Tensor):
    """Per-token int8 absmax: x [R, H, D] -> (int8 [R, H, D], scale [R]).

    scale = max(|row|, 1e-8)/127 over both the head and head_dim axes,
    payload = clip(round(x/scale), -127, 127), rounding half to even.
    """
    xf = x.to(torch.float32)
    amax = torch.amax(torch.abs(xf), dim=(1, 2))
    scale = torch.clamp_min(amax, 1e-8) / 127.0
    q = torch.clamp(torch.round(xf / scale[:, None, None]), -127, 127)
    return q.to(torch.int8), scale


def _pool_update(pool_l: dict, k, v, tables, qpos) -> dict:
    """Write [B, C] new tokens' K/V into one layer's blocks, in place.

    Distinct (slot, position) pairs hit distinct rows, except masked slots,
    whose tables are all-null: their rows collide on block 0, which is never
    read unmasked.
    """
    bs = pool_l["k"].shape[1]
    bids = torch.gather(tables.long(), 1, (qpos // bs).long()).reshape(-1)
    offs = (qpos % bs).reshape(-1).long()
    kr = k.reshape((-1,) + k.shape[2:])
    vr = v.reshape((-1,) + v.shape[2:])
    if "k_scale" in pool_l:
        qk, sk = quant_kv_rows(kr)
        qv, sv = quant_kv_rows(vr)
        pool_l["k"].index_put_((bids, offs), qk)
        pool_l["v"].index_put_((bids, offs), qv)
        pool_l["k_scale"].index_put_((bids, offs), sk)
        pool_l["v_scale"].index_put_((bids, offs), sv)
    else:
        pool_l["k"].index_put_((bids, offs), kr.to(pool_l["k"].dtype))
        pool_l["v"].index_put_((bids, offs), vr.to(pool_l["v"].dtype))
    return pool_l


def _paged_attention(params, h, cfg: ModelConfig, pool_l: dict, tables,
                     qpos, attn_impl):
    """Attention over paged KV.  h: [B, C, D]; qpos: [B, C] absolute
    positions.  Writes the C new tokens' K/V, then attends over each slot's
    blocks with kpos <= qpos masking."""
    q, k, v = L._project_qkv(params, h, cfg, qpos)
    return _paged_attention_tail(params, q, k, v, h.dtype, cfg, pool_l,
                                 tables, qpos, attn_impl)


def _paged_attention_tail(params, q, k, v, dt, cfg: ModelConfig,
                          pool_l: dict, tables, qpos, attn_impl):
    """Pool write + gather/kernel attention + output projection: everything
    after the prologue, shared by the unfused path and the fused
    decode-prologue kernel."""
    _pool_update(pool_l, k, v, tables, qpos)
    groups = q.shape[2] // cfg.num_kv_heads
    scale = cfg.head_dim ** -0.5
    if attn_impl == "kernel" and q.shape[1] == 1:
        out = PA.paged_attention(q[:, 0].contiguous(), pool_l, tables,
                                 qpos[:, 0].contiguous(), groups=groups,
                                 scale=scale)[:, None]
    else:
        kk, vv = PA.gather_kv(pool_l, tables, dt)
        out = PA.attend(q, kk, vv, qpos, groups, scale)
    y = torch.einsum("bthk,hkd->btd", out, L._masked_wo(params, cfg, dt))
    return y, pool_l


def _paged_block(p, x, cfg: ModelConfig, pool_l: dict, tables, qpos,
                 attn_impl, prologue: bool = False):
    if prologue and DP.prologue_active(cfg, x):
        # fused RMSNorm + QKV + rope prologue in front of the paged pool
        # write and the paged-attention kernel
        q, k, v = DP.decode_prologue(p["attn_norm"], p["attn"], x, cfg,
                                     qpos[:, 0])
        attn_out, pool_l = _paged_attention_tail(
            p["attn"], q, k, v, x.dtype, cfg, pool_l, tables, qpos,
            attn_impl)
    else:
        h = L.apply_norm(p["attn_norm"], x, cfg)
        attn_out, pool_l = _paged_attention(p["attn"], h, cfg, pool_l,
                                            tables, qpos, attn_impl)
    x = x + attn_out
    h = L.apply_norm(p["mlp_norm"], x, cfg)
    return x + B.ffn(p, h, cfg)[0], pool_l


def _embed_tokens(params, cfg: ModelConfig, tokens, dt):
    x = params["embed"][tokens.long()].to(dt)
    if cfg.scale_embed:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=dt, device=x.device)
    return x


def _layers(params, cfg: ModelConfig, pool: dict, x, tables, qpos, attn_impl,
            prologue: bool):
    for i in range(cfg.num_layers):
        pool_l = {k: t[i] for k, t in pool.items()}
        x, _ = _paged_block(lm.layer_params(params["blocks"], i), x, cfg,
                            pool_l, tables, qpos, attn_impl,
                            prologue=prologue)
    return x


def _logits(params, cfg: ModelConfig, x):
    x = L.apply_norm(params["final_norm"], x, cfg)
    w = lm.head_weight(params, cfg)
    return (x @ w.to(x.dtype)).to(torch.float32)


@torch.no_grad()
def paged_decode_step(params, cfg: ModelConfig, pool: dict, tables, seq_lens,
                      tokens, attn_impl=None):
    """One decode step over the slot batch against the paged pool.

    tokens: [B, 1] int32; tables: [B, M] int32 block tables (null rows for
    empty slots); seq_lens: [B] int32, the incoming token's write position.
    attn_impl: None/"ref" = the plain gather path, "kernel" = the paged
    attention kernel.  Returns (logits [B, V] f32, pool), the pool updated
    in place.
    """
    if not paged_supported(cfg):
        raise ValueError(f"paged decode unsupported for {cfg.family}")
    dt = lm.compute_dtype(cfg)
    x = _embed_tokens(params, cfg, tokens, dt)
    qpos = seq_lens.to(torch.int32)[:, None]
    x = _layers(params, cfg, pool, x, tables, qpos, attn_impl, prologue=True)
    return _logits(params, cfg, x)[:, 0, :], pool


@torch.no_grad()
def paged_prefill_chunk(params, cfg: ModelConfig, pool: dict, table, tokens,
                        start: int):
    """Prefill ``tokens`` [1, C] at absolute positions start..start+C-1.

    Each chunk attends over the pool contents written so far (earlier
    chunks, reused prefix blocks) plus its own causally masked K/V.
    Returns (last-token logits [1, V], pool), the pool updated in place.
    """
    if not paged_supported(cfg):
        raise ValueError(f"paged prefill unsupported for {cfg.family}")
    dt = lm.compute_dtype(cfg)
    c = tokens.shape[1]
    qpos = (int(start) + torch.arange(c, dtype=torch.int32,
                                      device=tokens.device))[None, :]
    x = _embed_tokens(params, cfg, tokens, dt)
    x = _layers(params, cfg, pool, x, table, qpos, "ref", prologue=False)
    return _logits(params, cfg, x)[:, -1, :], pool
