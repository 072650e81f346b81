"""Model assembly (port of ``models/lm.py``): parameters, the embedding,
the layer stacks, the encoder, the chunked cross-entropy head and the loss
of every family.

  dense/moe : embed -> L x transformer_block -> norm -> CE head
  vlm       : [patch_embeds @ mm_proj ; text embeds] -> dense stack
              (loss on the text positions only)
  ssm       : embed -> L x mamba_block -> norm -> CE head
  hybrid    : embed -> G x (shared transformer block ; K x mamba_block)
              -> ...
  encdec    : frames + sinusoid -> enc stack (non-causal) -> enc_norm;
              tokens + sinusoid -> dec stack (cross = encoder output)
              -> norm -> CE head

Parameters are a nested dict of tensors in the JAX package's layout: the
``blocks`` (and encdec's ``enc_blocks``) leaves are stacked on a leading
layer axis, so ``wq`` is [L, D, H, hd] and a moe block's experts
``moe/w_gate`` [L, E, D, F]; the hybrid's Mamba leaves are [G, K, ...]
and its one weight-tied ``shared_attn`` block is unstacked; a vlm holds
``mm_proj`` [D, D], an encdec ``enc_norm`` beside its stacks.
``params_from_numpy`` carries a JAX parameter pytree across (given as
numpy arrays, e.g. ``jax.tree.map(np.asarray, params)``).  JAX's layer
``xscan`` is a Python loop here.  A block with ``use_mla``
(deepseek-v2-lite) holds MLA's ``attn`` leaves (``wq`` [L, D, H, dn+dr],
``w_dkv`` [L, D, r], ...).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.utils.checkpoint

from repro_torch import resolve_device
from repro_torch.dist.api import (constrain, model_axis_index_ctx,
                                  model_axis_size_ctx, perf_opt)
from repro_torch.dist.collectives import current_mesh, dense_pmax
from repro_torch.dist.sharding import MODEL, _param_spec, model_dim
from repro_torch.models import blocks as B
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.util.tree import tree_map


def _stacked_init(n: int, init_fn) -> dict:
    """``n`` draws of ``init_fn()`` stacked on a new leading axis.  Each
    draw is copied into the stacked leaves as it is made, so at most one
    layer exists beside the stack (four mixtral-8x7b layers are 23 GB of
    f32)."""
    out = None
    for i in range(n):
        one = init_fn()
        if out is None:
            out = tree_map(lambda a: a.new_empty((n,) + tuple(a.shape)), one)
        tree_map(lambda dst, src: dst[i].copy_(src), out, one)
        del one
    return out


def init_params(cfg: ModelConfig, seed: int = 0, device=None) -> dict:
    """Random f32 master weights, drawn from a ``torch.Generator`` on
    ``device`` seeded with ``seed`` (CUDA unless the caller names another;
    raises when CUDA is absent).  On the "meta" device, the leaves' shapes
    only (what ``dist.sharding.param_pspecs`` places)."""
    B.require_ported(cfg)
    dev = resolve_device(device)
    if dev.type == "meta":
        gen = L.MetaDraws()
    else:
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
    D, V = cfg.d_model, cfg.vocab_size
    params = {"embed": L._randn(gen, (V, D), D ** -0.5),
              "final_norm": L.init_norm(D, cfg, gen.device)}
    if not cfg.tie_embeddings:
        params["lm_head"] = L._randn(gen, (D, V), D ** -0.5)
    if cfg.family in ("dense", "moe", "vlm"):
        params["blocks"] = _stacked_init(
            cfg.num_layers, lambda: B.init_transformer_block(gen, cfg))
        if cfg.family == "vlm":
            params["mm_proj"] = L._randn(gen, (D, D), D ** -0.5)
    elif cfg.family == "encdec":
        params["enc_blocks"] = _stacked_init(
            cfg.num_encoder_layers,
            lambda: B.init_transformer_block(gen, cfg))
        params["enc_norm"] = L.init_norm(D, cfg, gen.device)
        params["blocks"] = _stacked_init(
            cfg.num_layers, lambda: B.init_decoder_block(gen, cfg))
    elif cfg.family == "ssm":
        params["blocks"] = _stacked_init(
            cfg.num_layers, lambda: B.init_mamba_block(gen, cfg))
    else:  # hybrid
        G, K = hybrid_groups(cfg)
        params["blocks"] = _stacked_init(G, lambda: _stacked_init(
            K, lambda: B.init_mamba_block(gen, cfg)))
        params["shared_attn"] = B.init_transformer_block(gen, cfg)
    return params


# How each family's main stack consumes operands that are not the layer's
# own parameters or the flowing activation (the JAX package's contract for
# its stage-sharded pipeline; the port's single-device engine passes the
# "weights" and "activation" kinds as ``core.taxonn``'s shared operand):
#   "none"       self-contained per-layer bodies (dense/moe/vlm/ssm)
#   "weights"    a weight-tied block applied by every unit (the hybrid's
#                shared attention block)
#   "activation" a full-batch activation fanned out to every layer
#                (encdec's encoder output)
SHARED_OPERAND_KIND = {
    "dense": "none", "moe": "none", "vlm": "none", "ssm": "none",
    "hybrid": "weights", "encdec": "activation",
}


def hybrid_groups(cfg: ModelConfig) -> tuple:
    """Zamba2-style grouping: the shared block applied every
    ``attn_every`` Mamba layers -> (G groups, K layers a group)."""
    K = cfg.attn_every
    assert cfg.num_layers % K == 0, (cfg.num_layers, K)
    return cfg.num_layers // K, K


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32


def head_weight(params, cfg: ModelConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        return params["embed"].T  # [D, V]
    return params["lm_head"]


def params_from_numpy(tree, device=None):
    """The JAX parameter pytree (numpy leaves) as the port's dict of tensors,
    with the same keys, shapes, dtypes and layout, on ``device`` (CUDA
    unless the caller names another: ``resolve_device``)."""
    device = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, copy=True)).to(device)


def layer_params(blocks: dict, i) -> dict:
    """Layer ``i``'s parameters: views into the stacked ``blocks`` leaves.
    ``i`` is an int, or ``(g, k)`` for a hybrid's [G, K, ...] leaves."""
    return {k: layer_params(v, i) if isinstance(v, dict) else v[i]
            for k, v in blocks.items()}


# ---------------------------------------------------------------------------
# Training: embedding, stack, chunked CE head, loss
# ---------------------------------------------------------------------------

AUX_COEF = 0.01  # MoE load-balance coefficient (the dense aux is zero)


def _sinusoid(t: int, d: int, offset=0, device=None) -> torch.Tensor:
    """Sinusoidal positions [t, d] f32 of positions offset..offset+t-1:
    sin on the even columns, cos on the odd, angle pos / 10000^(i/d)."""
    pos = (torch.arange(t, dtype=torch.float32, device=device)
           + offset)[:, None]
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=device)[None, :]
    angle = pos / torch.pow(torch.tensor(10_000.0, device=device), dim / d)
    pe = torch.zeros((t, d), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(angle)
    pe[:, 1::2] = torch.cos(angle)
    return pe


def _vocab_shard(cfg: ModelConfig):
    """This rank's coordinate on the ambient mesh's "model" axis where
    that axis (m > 1) shards the vocabulary (``dist.sharding._param_spec``
    of the [V, D] table; the [D, V] head follows the same rule), else
    None."""
    m = model_axis_size_ctx()
    if m <= 1 or model_dim(_param_spec(
            [], "embed", (cfg.vocab_size, cfg.d_model), m)) is None:
        return None
    return model_axis_index_ctx()


def _lookup(table: torch.Tensor, tokens: torch.Tensor, cfg: ModelConfig,
            dt) -> torch.Tensor:
    """``table.to(dt)[tokens]``; with the vocabulary split over the model
    axis, the local rows looked up, the rest zero, summed over the group
    (one rank holds each token's row, so the sum is exact)."""
    shard = _vocab_shard(cfg)
    if shard is None:
        return table.to(dt)[tokens]
    rows = table.shape[0]
    local = tokens - shard * rows
    mine = (local >= 0) & (local < rows)
    x = table.to(dt)[torch.clamp(local, 0, rows - 1)]
    x = torch.where(mine[..., None], x, torch.zeros((), dtype=dt,
                                                    device=x.device))
    return L.reduce_from_model(x)


def embed_input(params, cfg: ModelConfig, batch: dict):
    """Returns (x0 [B, T, D] in the compute dtype, positions [B, T]).  A
    vlm's T counts its ``patch_embeds`` (projected by ``mm_proj``) before
    the text; an encdec's decoder input carries the sinusoid.  Under a
    model axis the table holds this rank's rows of the vocabulary
    (``_lookup``)."""
    dt = compute_dtype(cfg)
    tokens = batch["tokens"].long()
    # cast BEFORE the gather: with a vocab-sharded table the lookup's sum
    # then runs at compute precision, as in the JAX package
    x = _lookup(params["embed"], tokens, cfg, dt)
    if cfg.scale_embed:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    if cfg.family == "vlm":
        patches = batch["patch_embeds"].to(dt) @ params["mm_proj"].to(dt)
        x = torch.cat([patches, x], dim=1)
    if cfg.family == "encdec":
        x = x + _sinusoid(x.shape[1], cfg.d_model, device=x.device).to(dt)
    b, t = x.shape[0], x.shape[1]
    positions = torch.arange(t, device=x.device).expand(b, t)
    return constrain(x, "btd"), positions


def block_fn(kind: str):
    """The training block of ``kind``: "attn" (the transformer block),
    "mamba", or "dec" (the decoder block, which also takes the encoder's
    output)."""
    return {"attn": B.transformer_block, "mamba": B.mamba_block,
            "dec": B.decoder_block}[kind]


def stack_units(cfg: ModelConfig) -> int:
    """Units of the main stack: layers, or the hybrid's groups."""
    return hybrid_groups(cfg)[0] if cfg.family == "hybrid" else cfg.num_layers


def unit_blocks(unit, cfg: ModelConfig, shared=None):
    """One unit of the main stack in order: (kind, block params, k) per
    block, kind "attn" (the transformer block), "mamba" or "dec" (the
    encdec's decoder block).  A dense, moe, vlm, ssm or encdec unit is one
    layer (k None); a hybrid unit is a group, whose parameters are
    [K, ...]: the weight-tied ``shared`` block (k None), then Mamba layer
    k for each k."""
    if cfg.family != "hybrid":
        kind = {"ssm": "mamba", "encdec": "dec"}.get(cfg.family, "attn")
        yield kind, unit, None
        return
    yield "attn", shared, None
    for k in range(hybrid_groups(cfg)[1]):
        yield "mamba", layer_params(unit, k), k


def walk_stack(params, cfg: ModelConfig):
    """The main stack in order: one (kind, block params, cache index) per
    block application (``unit_blocks`` of each unit).  The cache index
    names the block's slice of the stacked decode caches: (None, i) in the
    dense, moe, vlm, ssm and encdec (decoder) stacks; in the hybrid's, ("attn", g) for the g-th
    application of the weight-tied shared block and ("mamba", (g, k)) for
    Mamba layer k of group g."""
    hybrid = cfg.family == "hybrid"
    for i in range(stack_units(cfg)):
        for kind, p, k in unit_blocks(layer_params(params["blocks"], i), cfg,
                                      params.get("shared_attn")):
            at = (("attn", i) if k is None else ("mamba", (i, k))) \
                if hybrid else (None, i)
            yield kind, p, at


def apply_stack(params, cfg: ModelConfig, x: torch.Tensor,
                positions: torch.Tensor, enc_out=None):
    """The main stack, block by block (an encdec's decoder blocks over
    ``enc_out``). Returns (x_final, aux_sum)."""
    if cfg.family == "encdec":
        assert enc_out is not None
    extra = (enc_out,) if cfg.family == "encdec" else ()
    auxs = []
    for kind, p, _ in walk_stack(params, cfg):
        x, aux = block_fn(kind)(p, x, cfg, positions, *extra)
        auxs.append(aux)
    return x, torch.sum(torch.stack(auxs))


def encode(params, cfg: ModelConfig, frames: torch.Tensor) -> torch.Tensor:
    """The Whisper encoder over precomputed (stub) frame embeddings
    [B, S, D]: the sinusoid added in the compute dtype, the non-causal
    transformer blocks, ``enc_norm``."""
    dt = compute_dtype(cfg)
    x = frames.to(dt) + _sinusoid(frames.shape[1], cfg.d_model,
                                  device=frames.device).to(dt)
    b, s = x.shape[0], x.shape[1]
    positions = torch.arange(s, device=x.device).expand(b, s)
    for i in range(cfg.num_encoder_layers):
        x, _ = B.transformer_block(layer_params(params["enc_blocks"], i), x,
                                   cfg, positions, causal=False)
    return L.apply_norm(params["enc_norm"], x, cfg)


def ce_loss_head(params, cfg: ModelConfig, x: torch.Tensor,
                 labels: torch.Tensor):
    """Chunked CE over the sequence axis; labels [B, T], -1 = ignore."""
    return ce_from_weight(head_weight(params, cfg), cfg, x, labels)


def _ce_chunk(xch, lch, w, ce_bf16=False):
    """(sum of per-token CE, count of valid tokens) of one chunk.
    ``ce_bf16`` (the §Perf option): the logits stay in the compute dtype,
    max and exp in it too, the sum of exps accumulated in f32."""
    raw = xch @ w.to(xch.dtype)
    logits = constrain(raw if ce_bf16 else raw.to(torch.float32), "btv")
    m = torch.amax(logits, dim=-1, keepdim=True)
    sumexp = torch.sum(torch.exp(logits - m), dim=-1, dtype=torch.float32)
    lse = torch.log(sumexp) + m[..., 0].to(torch.float32)
    tgt = torch.gather(logits, -1,
                       torch.clamp_min(lch, 0)[..., None])[..., 0]
    valid = (lch >= 0).to(torch.float32)
    return (torch.sum((lse - tgt.to(torch.float32)) * valid),
            torch.sum(valid))


def _ce_chunk_tp(xch, lch, w, first, ce_bf16=False, mesh=None):
    """``_ce_chunk`` with the vocabulary split over the model axis of
    ``mesh``: ``w`` holds this rank's vocab columns from ``first`` on.
    The local logits' max goes through a MAX over the group (held
    constant, as the shift-invariant softmax allows), the local sum of
    exps and the masked target pick through a SUM: the [B, C, V] logits
    are never gathered.  The SUM reassociates the f32 sum of exps, so the
    loss and its gradient sit a few ulps from the one-rank chunk's.  The
    mesh is an argument: the backward recomputes the chunk on autograd's
    own thread on CUDA, where the ambient mesh is not set."""
    raw = xch @ w.to(xch.dtype)
    logits = constrain(raw if ce_bf16 else raw.to(torch.float32), "btv")
    m = dense_pmax(torch.amax(logits.detach(), dim=-1, keepdim=True)
                   .to(torch.float32), MODEL, mesh=mesh).to(logits.dtype)
    sumexp = L.reduce_from_model(
        torch.sum(torch.exp(logits - m), dim=-1, dtype=torch.float32), mesh)
    lse = torch.log(sumexp) + m[..., 0].to(torch.float32)
    cols = torch.arange(logits.shape[-1], device=logits.device) + first
    mask = cols == torch.clamp_min(lch, 0)[..., None]
    tgt = L.reduce_from_model(torch.sum(
        torch.where(mask, logits, torch.zeros((), dtype=logits.dtype,
                                              device=logits.device))
        .to(torch.float32), dim=-1), mesh)
    valid = (lch >= 0).to(torch.float32)
    return torch.sum((lse - tgt) * valid), torch.sum(valid)


def ce_from_weight(w: torch.Tensor, cfg: ModelConfig, x: torch.Tensor,
                   labels: torch.Tensor):
    """CE head given an explicit [D, V] output weight (the engine
    differentiates the head on its own).  Chunked over T by
    ``cfg.logit_chunk``; each chunk runs under activation checkpointing, so
    its [B, C, V] logits exist only while that chunk runs, forward or
    backward.  Under a model axis that splits the vocabulary ``w`` holds
    this rank's columns and the head is vocab-parallel (``_ce_chunk_tp``;
    x's gradient summed over the group).  Returns (loss, metrics)."""
    bsz, t, _ = x.shape
    ce_bf16 = perf_opt("ce_bf16")
    shard = _vocab_shard(cfg)
    if shard is not None:
        x = L.copy_to_model(x)
        chunk = _ce_chunk_tp
        extra = (shard * w.shape[1], ce_bf16, current_mesh())
    else:
        chunk, extra = _ce_chunk, (ce_bf16,)
    c = min(cfg.logit_chunk, t)
    n = (t + c - 1) // c
    pad = n * c - t
    labels = labels.long()
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, pad))
        labels = torch.nn.functional.pad(labels, (0, pad), value=-1)
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(n):
        s, k = torch.utils.checkpoint.checkpoint(
            chunk, x[:, i * c:(i + 1) * c], labels[:, i * c:(i + 1) * c],
            w, *extra, use_reentrant=False)
        tot, cnt = tot + s, cnt + k
    loss = tot / torch.clamp_min(cnt, 1.0)
    return loss, {"loss": loss, "tokens": cnt}


def loss_fn(params, cfg: ModelConfig, batch: dict):
    """The autodiff path's training loss (the baseline that the TaxoNN
    engine is validated against; a vlm's loss over its text positions
    only).  Returns (total, metrics)."""
    enc_out = (encode(params, cfg, batch["frames"])
               if cfg.family == "encdec" else None)
    x, positions = embed_input(params, cfg, batch)
    x, aux = apply_stack(params, cfg, x, positions, enc_out)
    x = L.apply_norm(params["final_norm"], x, cfg)
    if cfg.family == "vlm":
        x = x[:, batch["patch_embeds"].shape[1]:, :]
    loss, metrics = ce_loss_head(params, cfg, x, batch["labels"])
    metrics["aux"] = aux
    return loss + AUX_COEF * aux, metrics


def forward_hidden(params, cfg: ModelConfig, batch: dict) -> torch.Tensor:
    """Forward to the final hidden states (after the final norm)."""
    enc_out = (encode(params, cfg, batch["frames"])
               if cfg.family == "encdec" else None)
    x, positions = embed_input(params, cfg, batch)
    x, _ = apply_stack(params, cfg, x, positions, enc_out)
    return L.apply_norm(params["final_norm"], x, cfg)


def last_token_logits(params, cfg: ModelConfig, batch: dict) -> torch.Tensor:
    x = forward_hidden(params, cfg, batch)
    w = head_weight(params, cfg)
    return (x[:, -1, :] @ w.to(x.dtype)).to(torch.float32)
