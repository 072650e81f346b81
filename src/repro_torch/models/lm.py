"""Model assembly of the dense, moe (with MLA or GQA), ssm and hybrid
families (port of
those families of ``models/lm.py``): parameters, the embedding, the layer
stack, the chunked cross-entropy head and the loss.

  dense/moe : embed -> L x transformer_block -> norm -> CE head
  ssm       : embed -> L x mamba_block -> norm -> CE head
  hybrid    : embed -> G x (shared transformer block ; K x mamba_block)
              -> ...

Parameters are a nested dict of tensors in the JAX package's layout: the
``blocks`` leaves are stacked on a leading layer axis, so ``wq`` is
[L, D, H, hd] and a moe block's experts ``moe/w_gate`` [L, E, D, F]; the
hybrid's Mamba leaves are [G, K, ...] and its one weight-tied
``shared_attn`` block is unstacked.  ``params_from_numpy``
carries a JAX parameter pytree across (given as numpy arrays, e.g.
``jax.tree.map(np.asarray, params)``).  JAX's layer ``xscan`` is a Python
loop here.  A block with ``use_mla`` (deepseek-v2-lite) holds MLA's
``attn`` leaves (``wq`` [L, D, H, dn+dr], ``w_dkv`` [L, D, r], ...).  vlm
and encdec raise (ROADMAP A9e).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.utils.checkpoint

from repro_torch import resolve_device
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
    raises when CUDA is absent)."""
    B.require_ported(cfg)
    gen = torch.Generator(device=resolve_device(device))
    gen.manual_seed(int(seed))
    D, V = cfg.d_model, cfg.vocab_size
    params = {"embed": L._randn(gen, (V, D), D ** -0.5),
              "final_norm": L.init_norm(D, cfg, gen.device)}
    if not cfg.tie_embeddings:
        params["lm_head"] = L._randn(gen, (D, V), D ** -0.5)
    if cfg.family in ("dense", "moe"):
        params["blocks"] = _stacked_init(
            cfg.num_layers, lambda: B.init_transformer_block(gen, cfg))
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
# its stage-sharded pipeline; the port's engine covers "none" and
# "weights"):
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


def embed_input(params, cfg: ModelConfig, batch: dict):
    """Returns (x0 [B, T, D] in the compute dtype, positions [B, T])."""
    tokens = batch["tokens"].long()
    x = params["embed"].to(compute_dtype(cfg))[tokens]
    if cfg.scale_embed:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    b, t = x.shape[0], x.shape[1]
    positions = torch.arange(t, device=x.device).expand(b, t)
    return x, positions


def block_fn(kind: str):
    """The training block of ``kind`` ("attn" or "mamba")."""
    return B.transformer_block if kind == "attn" else B.mamba_block


def stack_units(cfg: ModelConfig) -> int:
    """Units of the main stack: layers, or the hybrid's groups."""
    return hybrid_groups(cfg)[0] if cfg.family == "hybrid" else cfg.num_layers


def unit_blocks(unit, cfg: ModelConfig, shared=None):
    """One unit of the main stack in order: (kind, block params, k) per
    block, kind "attn" (the transformer block) or "mamba".  A dense, moe
    or ssm unit is one layer (k None); a hybrid unit is a group, whose
    parameters are [K, ...]: the weight-tied ``shared`` block (k None),
    then Mamba layer k for each k."""
    if cfg.family != "hybrid":
        yield ("mamba" if cfg.family == "ssm" else "attn"), unit, None
        return
    yield "attn", shared, None
    for k in range(hybrid_groups(cfg)[1]):
        yield "mamba", layer_params(unit, k), k


def walk_stack(params, cfg: ModelConfig):
    """The main stack in order: one (kind, block params, cache index) per
    block application (``unit_blocks`` of each unit).  The cache index
    names the block's slice of the stacked decode caches: (None, i) in the
    dense, moe and ssm stacks; in the hybrid's, ("attn", g) for the g-th
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
                positions: torch.Tensor):
    """The main stack, block by block. Returns (x_final, aux_sum)."""
    auxs = []
    for kind, p, _ in walk_stack(params, cfg):
        x, aux = block_fn(kind)(p, x, cfg, positions)
        auxs.append(aux)
    return x, torch.sum(torch.stack(auxs))


def ce_loss_head(params, cfg: ModelConfig, x: torch.Tensor,
                 labels: torch.Tensor):
    """Chunked CE over the sequence axis; labels [B, T], -1 = ignore."""
    return ce_from_weight(head_weight(params, cfg), cfg, x, labels)


def _ce_chunk(xch, lch, w):
    """(sum of per-token CE, count of valid tokens) of one chunk."""
    logits = (xch @ w.to(xch.dtype)).to(torch.float32)
    m = torch.amax(logits, dim=-1, keepdim=True)
    sumexp = torch.sum(torch.exp(logits - m), dim=-1, dtype=torch.float32)
    lse = torch.log(sumexp) + m[..., 0]
    tgt = torch.gather(logits, -1, torch.clamp_min(lch, 0)[..., None])[..., 0]
    valid = (lch >= 0).to(torch.float32)
    return torch.sum((lse - tgt) * valid), torch.sum(valid)


def ce_from_weight(w: torch.Tensor, cfg: ModelConfig, x: torch.Tensor,
                   labels: torch.Tensor):
    """CE head given an explicit [D, V] output weight (the engine
    differentiates the head on its own).  Chunked over T by
    ``cfg.logit_chunk``; each chunk runs under activation checkpointing, so
    its [B, C, V] logits exist only while that chunk runs, forward or
    backward.  Returns (loss, metrics)."""
    bsz, t, _ = x.shape
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
            _ce_chunk, x[:, i * c:(i + 1) * c], labels[:, i * c:(i + 1) * c],
            w, use_reentrant=False)
        tot, cnt = tot + s, cnt + k
    loss = tot / torch.clamp_min(cnt, 1.0)
    return loss, {"loss": loss, "tokens": cnt}


def loss_fn(params, cfg: ModelConfig, batch: dict):
    """The autodiff path's training loss (the baseline that the TaxoNN
    engine is validated against).  Returns (total, metrics)."""
    x, positions = embed_input(params, cfg, batch)
    x, aux = apply_stack(params, cfg, x, positions)
    x = L.apply_norm(params["final_norm"], x, cfg)
    loss, metrics = ce_loss_head(params, cfg, x, batch["labels"])
    metrics["aux"] = aux
    return loss + AUX_COEF * aux, metrics


def forward_hidden(params, cfg: ModelConfig, batch: dict) -> torch.Tensor:
    """Forward to the final hidden states (after the final norm)."""
    x, positions = embed_input(params, cfg, batch)
    x, _ = apply_stack(params, cfg, x, positions)
    return L.apply_norm(params["final_norm"], x, cfg)


def last_token_logits(params, cfg: ModelConfig, batch: dict) -> torch.Tensor:
    x = forward_hidden(params, cfg, batch)
    w = head_weight(params, cfg)
    return (x[:, -1, :] @ w.to(x.dtype)).to(torch.float32)
