"""Serving engine of the dense family (port of ``serving/engine.py``):
prefill + one-token decode against a contiguous per-slot KV cache, and the
paged KV pool.

Contiguous cache: every layer's K/V ring buffers stacked on a leading
layer axis, {"caches": {"k", "v": [L, B, len, kv_heads, head_dim]},
"pos": int32 scalar}.  ``pos`` is ONE position for the whole slot batch,
as in the JAX package: ``decode_step`` writes every slot's token at
``pos`` and attends over positions <= ``pos``, so the batch is well
defined only for equal-length prompts admitted together (the scheduler's
contiguous mode).  ``pos`` stays a host tensor, the caches live on the
device and ``decode_step`` writes them IN PLACE.  ``prefill`` installs
``kernel_backend or "auto"`` (int8 on CUDA) around the prompt's forward;
``decode_step`` runs under the caller's backend.  The other families'
caches (MLA latents, SSM state, hybrid groups, cross-attention) and SWA
rings wait for ROADMAP A9 and raise.

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
from repro_torch.models.config import ModelConfig

# ---------------------------------------------------------------------------
# Contiguous cache: init, decode step, prefill
# ---------------------------------------------------------------------------

def require_dense(cfg: ModelConfig) -> None:
    """Raise unless the port serves ``cfg``: the dense family, with no MLA
    and no sliding window (the rest waits for ROADMAP A9)."""
    B._dense_only(cfg)
    if cfg.swa_window is not None:
        raise NotImplementedError(
            f"{cfg.name}: sliding-window (ring) caches are not ported yet "
            f"(ROADMAP A9)")


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int,
                      cache_dtype=torch.bfloat16, device=None) -> dict:
    """The zeroed contiguous decode state on ``device`` (CUDA unless the
    caller names another)."""
    device = resolve_device(device)
    require_dense(cfg)
    one = B.init_block_cache(cfg, batch, max_len, cache_dtype, device)
    caches = {k: torch.zeros((cfg.num_layers,) + v.shape, dtype=v.dtype,
                             device=device) for k, v in one.items()}
    return {"caches": caches, "pos": torch.zeros((), dtype=torch.int32)}


@torch.no_grad()
def decode_step(params, cfg: ModelConfig, state: dict, tokens):
    """One decode step. tokens: [B, 1] int32.  Returns (logits [B, V] f32,
    state), the caches written in place and ``pos`` advanced by one."""
    dt = lm.compute_dtype(cfg)
    pos = int(state["pos"])
    caches = state["caches"]
    x = _embed_tokens(params, cfg, tokens, dt)
    for i in range(cfg.num_layers):
        x, _ = B.transformer_block_decode(
            lm.layer_params(params["blocks"], i), x, cfg,
            {k: t[i] for k, t in caches.items()}, pos)
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
    require_dense(cfg)
    device = params["embed"].device
    batch = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
    x, positions = lm.embed_input(params, cfg, batch)
    t = x.shape[1]
    layers = []
    for i in range(cfg.num_layers):
        x, c = B.transformer_block_prefill(
            lm.layer_params(params["blocks"], i), x, cfg, positions, max_len,
            cache_dtype)
        layers.append(c)
    caches = {k: torch.stack([c[k] for c in layers]) for k in layers[0]}
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
    """Paged decode covers the GQA-KV attention families; MLA latents, SWA
    rings, SSM state and cross-attention keep the contiguous path."""
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
    if cfg.family != "dense":
        raise NotImplementedError(f"{cfg.family} MLP is not ported yet")
    return x + L.mlp(p["mlp"], h, cfg), pool_l


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
