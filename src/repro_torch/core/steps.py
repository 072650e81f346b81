"""Train/eval step builders: the TaxoNN engine against the autodiff baseline
(port of ``core/steps.py``: every family, single device).

``make_train_step(cfg, policy, optim_cfg, options, device=None)`` returns

    step(params, opt_state, batch, hyper, bits, rng=None)
        -> (params, opt_state, metrics)

engine="taxonn"   -- the paper's unrolled G-chain with per-layer fused
                     updates (``core.taxonn``)
engine="autodiff" -- autograd over the whole loss and one optimizer apply
                     (the "conventional accelerator" baseline, and the
                     engine's correctness oracle)

``bits`` is a dict of BitSchedules keyed by stack name ("blocks", and
"enc_blocks" for encdec); they are runtime data, so one step object serves
every schedule.  A moe layer's
body returns its load-balance aux; the engine seeds it with ``AUX_COEF *
grad_scale`` in each layer's VJP, so its gradient reaches the router and
the layer input through the routing probabilities (the pick fractions
are constant), and the engine quantizes the router [D, E] and the expert
stacks [E, D, F] in the layer's weight format as every leaf of two or more
dimensions.  The hybrid's
engine unit is a group (the shared block, then K Mamba layers), so its
schedule has one entry a group; the weight-tied ``shared_attn`` block is
the engine's shared operand, quantized with each group's weight format,
its gradient summed over the groups and applied once after the reverse
loop with its own optimizer state.  The encoder-decoder runs its encoder
stack through the engine first (``_enc_body``, its own schedule
"enc_blocks"), quantizes the encoder's output once in the last encoder
unit's activation format and hands it to every decoder unit as the
unquantized shared operand; the decoder's summed dS goes back through
``enc_norm`` into the encoder's reverse loop, whose layer keys are the
decoder's (the same ``rng``, as JAX passes it to both).  A vlm's
``mm_proj`` is a boundary leaf, its patch rows are dropped after the
final norm.  The step is
functional: it returns new parameter and state trees and leaves its inputs
as they were.  It runs on CUDA unless ``device`` names another device, and
raises when CUDA is absent (``repro_torch.resolve_device``).  ``rng`` keys
the engine's stochastic rounding (``QuantPolicy.stochastic``): a port key
(``util.prng``) or a JAX key's raw ``uint32[2]`` data as numpy, so both
packages fold the same key stream; the autodiff step accepts it and
ignores it, as JAX's does.  ``StepOptions.bit_anneal`` (or the policy's)
ramps the F bits with the step (``search.anneal``): the taxonn step
applies the ramp to ``bits`` at ``hyper.step``, the autodiff step accepts
it and ignores it, and the returned step exposes it as ``.bit_anneal``.
``QuantPolicy.compress_dw``, ``dw_psum_axes`` and ``dw_num_replicas``
reach the engine's dW reduction with the policy (``core.taxonn``);
``StepOptions.overlap`` and ``transport`` override the policy's
``overlap`` and ``dw_transport`` (the overlapped reduce and its
transports, ``dist.async_collectives``); ``pipeline_stages > 1`` runs the
stack stage-sharded over the mesh's "pipe" ranks (``dist.pipeline``).
Under an ambient mesh whose "model" axis has more than one rank
(``dist.mesh_ctx``) the step is tensor-parallel: ``params`` and
``opt_state`` are this rank's shards (``dist.sharding.shard_tree`` of
``param_pspecs`` and ``opt_pspecs``), the layers run on them with the
model group's collectives (``models.layers``, ``models.lm``), the updates
are each shard's slice of the logical update, and ``grad_norm`` counts
each shard once over the group.  It takes the dense family; the others,
``compress_dw``, ``overlap="on"`` and the pipeline raise under a model
axis (ROADMAP A11.3c), and the multi-rank train driver is ROADMAP
A11.3b.
``capture_resume_extra`` and ``apply_resume_extra`` carry the train
driver's resume payload, the transport decisions among it; the noise and
the anneal depend only on the step, so the payload needs no PRNG state,
and the anneal spec rides along only to guard against resuming under
another ramp.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Optional

import torch

from repro_torch import resolve_device
from repro_torch.core.taxonn import (QuantPolicy, _blend_quant,
                                     _num_units, _quantize_shared,
                                     apply_stacked_updates, backward_stack,
                                     default_bits_for, forward_stack,
                                     grad_tap, grad_tap_stochastic,
                                     quantize_weight_tree)
from repro_torch.dist.async_collectives import (load_transport_cache,
                                                transport_cache_snapshot)
from repro_torch.dist.api import model_axis_size_ctx
from repro_torch.dist.collectives import current_mesh, dense_psum
from repro_torch.dist.sharding import MODEL, model_dim, param_pspecs
from repro_torch.dist.pipeline import get_schedule, pipeline_apply
from repro_torch.kernels.ops import (current_backend, foreign_tune_entries,
                                     kernel_backend_ctx, load_tune_cache,
                                     resolve_backend, tune_cache_snapshot)
from repro_torch.models import blocks as B
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.models.config import ModelConfig
from repro_torch.optim import Hyper, OptimizerConfig, apply_update
from repro_torch.optim import init_opt_state
from repro_torch.quant.fixed_point import maybe_quantize
from repro_torch.search.anneal import AnnealSchedule
from repro_torch.util import prng
from repro_torch.util.tree import tree_leaves, tree_map, tree_unflatten

AUX_COEF = lm.AUX_COEF


STACK_KEYS = ("blocks", "enc_blocks")
SHARED_KEYS = ("shared_attn",)


# ---------------------------------------------------------------------------
# Train state
# ---------------------------------------------------------------------------

def boundary_keys(params: dict):
    return tuple(k for k in params
                 if k not in STACK_KEYS and k not in SHARED_KEYS)


def init_train_state(params: dict, optim_cfg: OptimizerConfig) -> dict:
    """Optimizer state grouped like the params' top level, so the engine
    can slice each stack's state per layer."""
    return {k: init_opt_state(v, optim_cfg) for k, v in params.items()}


def num_scan_units(cfg: ModelConfig) -> int:
    """Engine-visible units in the main stack (the hybrid's are groups)."""
    B.require_ported(cfg)
    return lm.stack_units(cfg)


def default_bits(cfg: ModelConfig, enabled: bool = True) -> dict:
    bits = {"blocks": default_bits_for(num_scan_units(cfg), enabled)}
    if cfg.family == "encdec":
        bits["enc_blocks"] = default_bits_for(cfg.num_encoder_layers,
                                              enabled)
    return bits


# ---------------------------------------------------------------------------
# Resume-state capture: everything a bitwise restart needs beyond params
# ---------------------------------------------------------------------------

RESUME_SCHEMA = 1


def capture_resume_extra(cfg: ModelConfig, step: int, *, loader=None,
                         user_extra: Optional[dict] = None,
                         anneal=None) -> dict:
    """The checkpoint ``extra`` payload that makes a restart BITWISE: the
    data-pipeline step, so the step-indexed loader replays the exact batch
    stream (the lr schedule is a function of the step too), the transport
    cache (``dist.async_collectives.transport_cache_snapshot``), so that
    the resumed backward loop keeps the killed run's collective schedule
    and so its reduction order, and the kernel tune cache
    (``kernels.ops.tune_cache_snapshot``), so that the resumed run
    launches the original run's splits on any card.  The keys are the JAX
    package's.  ``anneal`` (a
    spec or an ``AnnealSchedule``) is recorded as its canonical spec: the
    annealed bits are a function of the step, so resume is bitwise
    anyway, and the spec only guards against resuming under another ramp.
    Everything is msgpack-scalar/str, so it rides the checkpoint manifest
    unchanged."""
    extra = {
        "resume_schema": RESUME_SCHEMA,
        "arch": cfg.name,
        "family": cfg.family,
        "data_step": int(step),
        "transport_cache": transport_cache_snapshot(),
        "tune_cache": tune_cache_snapshot(),
    }
    if anneal is not None:
        extra["bit_anneal"] = AnnealSchedule.parse(anneal).spec
    if loader is not None:
        extra["loader"] = {"served": int(loader.served),
                           "skips": int(loader.skips),
                           "stale_drops": int(loader.stale_drops)}
    if user_extra:
        extra.update(user_extra)
    return extra


def apply_resume_extra(extra: dict, cfg: ModelConfig, ckpt_step: int, *,
                       anneal=None) -> int:
    """Validate a checkpoint's resume payload and return the data step to
    resume from (the checkpoint step for a payload from before the schema,
    whose save convention was step == next data step).

    A checkpoint of another arch is refused: restoring qwen state into
    gemma is silent corruption the shape check alone may not catch.  The
    payload's transport decisions (``load_transport_cache``; the keys are
    both packages') and tune-cache decisions (``load_tune_cache``) are
    installed, existing entries winning; a JAX-written payload's tune-cache
    kinds are counted and skipped.  A payload annealed under another spec
    than
    ``anneal`` is refused; a spec on one side only warns, since the
    effective bits change at the restart boundary."""
    extra = extra or {}
    arch = extra.get("arch")
    if arch is not None and arch != cfg.name:
        raise ValueError(
            f"checkpoint was written by arch {arch!r}; refusing to resume "
            f"it as {cfg.name!r}")
    ckpt_anneal = extra.get("bit_anneal")
    cur_anneal = (AnnealSchedule.parse(anneal).spec if anneal is not None
                  else None)
    if ckpt_anneal is not None and cur_anneal is not None \
            and ckpt_anneal != cur_anneal:
        raise ValueError(
            f"checkpoint was annealed under {ckpt_anneal!r}; resuming with "
            f"{cur_anneal!r} would change the bit ramp mid-run (pass the "
            f"same --bit-anneal spec to resume)")
    if (ckpt_anneal is None) != (cur_anneal is None):
        warnings.warn(
            f"bit-anneal mismatch at resume: checkpoint={ckpt_anneal!r} "
            f"current={cur_anneal!r} — the effective bit schedule changes "
            f"at the restart boundary", RuntimeWarning, stacklevel=2)
    cache = extra.get("transport_cache")
    if cache:
        n = load_transport_cache(cache)
        if n:
            print(f"[train] restored {n} transport-cache decision(s) from "
                  f"checkpoint", flush=True)
    tune = extra.get("tune_cache")
    if tune:
        n = load_tune_cache(tune)
        skipped = foreign_tune_entries(tune)
        if n or skipped:
            print(f"[train] restored {n} tune-cache decision(s) from "
                  f"checkpoint" + (f"; skipped {skipped} of the JAX "
                                   f"package's" if skipped else ""),
                  flush=True)
    return int(extra.get("data_step", ckpt_step))


# ---------------------------------------------------------------------------
# The stack body and the boundary (embed / head) functions
# ---------------------------------------------------------------------------

def _make_body(cfg: ModelConfig, positions, moe_aux_parts: bool = False):
    """body(params_slice, x, bits_l, *shared) -> (y, aux): the blocks of one
    unit (``lm.unit_blocks``), their aux summed.  The hybrid's unit is a
    group, the shared block then its K Mamba layers; an encdec's is a
    decoder block, whose shared operand is the encoder's output.  With
    ``moe_aux_parts`` a moe unit's aux is its statistics ``{"frac",
    "p"}`` (``blocks.transformer_block``)."""
    B.require_ported(cfg)
    hybrid = cfg.family == "hybrid"
    parts = {"moe_aux_parts": True} if moe_aux_parts else {}

    def body(p, x, b_l, *shared):
        aux = None
        for kind, bp, _ in lm.unit_blocks(p, cfg, *(shared if hybrid
                                                     else ())):
            x, a = lm.block_fn(kind)(bp, x, cfg, positions,
                                     *(() if hybrid else shared),
                                     **(parts if kind == "attn" else {}))
            aux = a if aux is None else aux + a
        return x, aux
    return body


def _enc_body(cfg: ModelConfig, positions):
    """The encoder's unit: one non-causal transformer block."""
    def body(p, x, b_l):
        return B.transformer_block(p, x, cfg, positions, causal=False)
    return body


def _embed_fn(cfg: ModelConfig, batch, policy: QuantPolicy, bits0):
    """x0 from the boundary params; the embedding is quantized with the
    first layer's weight format."""
    def f(bnd):
        emb = bnd["embed"]
        if policy.quantize_weights:
            emb = quantize_weight_tree(emb, bits0["w_i"], bits0["w_f"],
                                       bits0["enabled"], True)
        p = {"embed": emb}
        if cfg.family == "vlm":
            p["mm_proj"] = bnd["mm_proj"]
        x0, _ = lm.embed_input(p, cfg, batch)
        return x0
    return f


def _head_fn(cfg: ModelConfig, batch, policy: QuantPolicy, bits_last):
    """(loss, metrics) from the boundary params and the stack's output; the
    head weight (the tied embedding's transpose) is quantized with the last
    layer's weight format.  A vlm's patch rows are dropped after the final
    norm."""
    np_off = batch["patch_embeds"].shape[1] if cfg.family == "vlm" else 0

    def f(bnd, xf):
        x = L.apply_norm(bnd["final_norm"], xf, cfg)
        if np_off:
            x = x[:, np_off:, :]
        w = bnd["embed"].T if cfg.tie_embeddings else bnd["lm_head"]
        if policy.quantize_weights:
            w = quantize_weight_tree(w, bits_last["w_i"], bits_last["w_f"],
                                     bits_last["enabled"], True)
        return lm.ce_from_weight(w, cfg, x, batch["labels"])
    return f


def _bits_edge(bits, idx) -> dict:
    return {"w_i": bits.w_i[idx], "w_f": bits.w_f[idx],
            "a_i": bits.a_i[idx], "a_f": bits.a_f[idx],
            "g_i": bits.g_i[idx], "g_f": bits.g_f[idx],
            "enabled": bits.enabled}


def _grad_leaves(outputs, tree, seeds):
    """Autograd of ``outputs`` (seeded by ``seeds``) into every leaf of
    ``tree``, zeros where a leaf is not reached, as a tree."""
    leaves = tree_leaves(tree)
    grads = torch.autograd.grad(outputs, leaves, seeds, allow_unused=True)
    return tree_unflatten(tree, [torch.zeros_like(w) if g is None else g
                                 for g, w in zip(grads, leaves)])


# (cfg, model size) -> the parameters' specs
_SPECS: dict = {}


def _step_specs(cfg: ModelConfig):
    """The parameters' specs under a model axis of more than one rank (the
    step's leaves are then shards), else None: ``param_pspecs`` of the
    logical shapes, from an initialization on the meta device."""
    m = model_axis_size_ctx()
    if m <= 1:
        return None
    if (cfg, m) not in _SPECS:
        _SPECS[(cfg, m)] = param_pspecs(
            cfg, lm.init_params(cfg, device="meta"), current_mesh())
    return _SPECS[(cfg, m)]


def check_model_axis(cfg: ModelConfig, policy: QuantPolicy,
                     pipeline_stages: Optional[int] = None) -> None:
    """Raise, by name, for what the step cannot yet run under a model axis
    of more than one rank (ROADMAP A11.3c), rather than run it replicated
    in silence."""
    m = model_axis_size_ctx()
    if m <= 1:
        return
    refused = []
    if cfg.family != "dense":
        refused.append(f"the {cfg.family} family")
    if policy.compress_dw:
        refused.append("compress_dw (the codec's absmax blocks of a shard "
                       "are not the logical leaf's)")
    if policy.overlap == "on":
        refused.append("overlap='on'")
    if pipeline_stages and int(pipeline_stages) > 1:
        refused.append("pipeline_stages > 1")
    if refused:
        raise NotImplementedError(
            f"under a model axis of {m} ranks the step runs the dense "
            f"family only; {', '.join(refused)}: ROADMAP A11.3c")


def _sq_sums(tree, specs, like: torch.Tensor) -> torch.Tensor:
    """The squared sum of a gradient tree, each shard's squares (``specs``
    naming shards) summed over the model group."""
    if specs is None:
        return _sq_sum(tree, like)
    sqs = tree_map(lambda g: torch.sum(torch.square(g.to(torch.float32))),
                   tree)
    shards = tree_map(lambda sp: model_dim(sp) is not None, specs)
    rep = torch.zeros((), dtype=torch.float32, device=like.device)
    sh = torch.zeros((), dtype=torch.float32, device=like.device)
    for sq, sharded in zip(tree_leaves(sqs), tree_leaves(shards)):
        if sharded:
            sh = sh + sq
        else:
            rep = rep + sq
    return rep + dense_psum(sh, MODEL)


def _requires_grad(tree):
    return tree_map(lambda w: w.detach().requires_grad_(), tree)


def _sq_sum(tree, like: torch.Tensor) -> torch.Tensor:
    total = torch.zeros((), dtype=torch.float32, device=like.device)
    for g in tree_leaves(tree):
        total = total + torch.sum(torch.square(g.to(torch.float32)))
    return total


# ---------------------------------------------------------------------------
# Stage-sharded stack execution through dist.pipeline
# ---------------------------------------------------------------------------

def pipeline_exec_capabilities(cfg: ModelConfig,
                               policy: QuantPolicy) -> dict:
    """What the stage-sharded pipeline path can execute, per feature.

    Every entry maps a requirement of this (cfg, policy) combination to
    whether the pipeline path supports it: every family of the JAX
    package's six (their shared operands replicated or sliced per stage,
    moe's aux statistics recombined after the drain) and every
    QuantPolicy feature.  The map lets ``_check_pipeline_exec`` detect a
    missing capability instead of keeping a family allowlist, and lets
    callers (tests, the train driver) ask instead of parsing error text.
    """
    known = cfg.family in lm.SHARED_OPERAND_KIND
    return {
        f"family:{cfg.family}": known,
        "stochastic": True,        # per-(layer, batch-row) noise keys
        "quantize_updates": True,  # in the stacked update tail
        "compress_dw": True,       # per-layer codec in the update tail
        "overlap": True,           # the update tail's overlapped reduce
    }


def _check_pipeline_exec(cfg: ModelConfig, policy: QuantPolicy,
                         num_stages: int) -> None:
    """Build-time validation for executing the stack through dist.pipeline."""
    caps = pipeline_exec_capabilities(cfg, policy)
    active = [f"family:{cfg.family}"]
    active += [f for f in ("stochastic", "quantize_updates", "compress_dw")
               if getattr(policy, f)]
    if policy.overlap == "on":
        active.append("overlap")
    missing = [f for f in active if not caps.get(f, False)]
    if missing:
        raise NotImplementedError(
            f"pipeline execution (pipeline_stages={num_stages} > 1) does "
            f"not support {missing} for this configuration")
    n = num_scan_units(cfg)
    if n % num_stages:
        raise ValueError(
            f"num_layers={n} does not divide into pipeline_stages="
            f"{num_stages} equal stages")


def _pipeline_stack_forward(body, stacked, bits, policy: QuantPolicy,
                            x0: torch.Tensor, sched, num_stages: int,
                            num_microbatches: int, mesh, shared=(),
                            shared_kind: str = "none",
                            moe_experts: Optional[int] = None, rng=None):
    """Run the blocks stack stage-sharded through ``dist.pipeline``, under
    autograd.

    The stack's [L, ...] leaves reshape to [S, L/S, ...] stages (so do the
    bits and the unit index) and the batch splits into M microbatches;
    ``pipeline_apply`` runs them under ``sched``, with the stages placed on
    the "pipe" dimension of ``mesh`` where it has one.  Each stage runs its
    layers in a Python loop with the engine's forward quantization, and a
    ``grad_tap`` at every layer input quantizes the cotangent, so autograd
    through this function is the engine's G-chain, up to JAX's activation
    STE: G passes the activation quantizer's mask, zero where an
    activation saturates its format, where the engine's reverse loop
    differentiates at the quantized input.  Each layer runs under
    ``torch.utils.checkpoint`` (not reentrant): its input is kept and the
    layer recomputed in the backward, the engine's cached-X_i memory
    discipline.  The kernel backend of the forward is installed again
    around the recompute, which on CUDA runs on autograd's own thread.
    The stack's weights are quantized once a step, each layer in its own
    weight format (``_quantize_stack``): the JAX package quantizes them in
    each layer call, once a microbatch, to the same values, and the STE
    passes the microbatches' summed gradient where it passed each one.
    Unlike the engine's reverse loop the whole stacked dW exists at once:
    stage-sharding trades the paper's one-layer gradient residency for the
    pipe dimension's parallelism.

    Shared operands (``shared_kind``, ``models.lm.SHARED_OPERAND_KIND``):

    * ``"weights"`` (the hybrid's weight-tied block): each layer quantizes
      ``shared`` with its own (I,F), as the engine does; its gradient is
      summed over the stages (``pipeline_apply``'s ``shared``).
    * ``"activation"`` (encdec's encoder output): each stage slices the
      rows of the microbatch it is processing (the microbatch index rides
      the value), and the slices' gradients add back into the full batch.

    moe's load-balance aux is bilinear in two batch means, so each unit
    writes its per-microbatch statistics in its own row of the value
    (``moe_experts`` set) and they are averaged over the M microbatches
    after the drain before ``moe_aux_from_stats``: the engine's full-batch
    aux and gradient.  Other families add their scalar aux and divide by M.

    With ``policy.stochastic`` and an ``rng`` key, the taps round
    stochastically with layer key ``fold_in(rng, unit)`` and row offset
    ``m * mb``: the engine's full-batch draws.

    Returns ``(y [B, ...], aux_sum scalar)``.
    """
    n_units = _num_units(stacked)
    bsz = x0.shape[0]
    S, M = num_stages, num_microbatches
    # batch % M is checked by the caller (the step's pipeline branch)
    lps, mbsz = n_units // S, bsz // M
    enabled = bits.enabled
    use_stoch = (policy.quantize_grads and policy.stochastic
                 and rng is not None)
    keys = ([prng.fold_in(rng, u) for u in range(n_units)] if use_stoch
            else None)
    backend = current_backend()
    if policy.quantize_weights:
        stacked = _quantize_stack(stacked, bits)
    stage_p = tree_map(lambda a: a.reshape((S, lps) + a.shape[1:]), stacked)
    stage_b = {k: getattr(bits, k).reshape(S, lps)
               for k in ("w_i", "w_f", "a_i", "a_f", "g_i", "g_f")}
    stage_l = torch.arange(n_units).reshape(S, lps)          # unit index

    def layer(carry, p_l, b_l, u, m, sh):
        with kernel_backend_ctx(backend):
            hh = carry["h"]
            if policy.quantize_grads:
                hh = (grad_tap_stochastic(hh, b_l["g_i"], b_l["g_f"],
                                          enabled, keys[u], m * mbsz)
                      if use_stoch else
                      grad_tap(hh, b_l["g_i"], b_l["g_f"], enabled))
            hq = (_blend_quant(hh, b_l["a_i"], b_l["a_f"], enabled)
                  if policy.quantize_acts else hh)
            sq = (_quantize_shared(sh, b_l, enabled, policy)
                  if shared_kind == "weights" else sh)
            y, aux_l = body(p_l, hq, b_l, *sq)
        new = dict(carry, h=y)
        if moe_experts:
            # this unit's statistics land in its own row; the other units'
            # rows (written by other stages) pass through
            for k in ("frac", "p"):
                new[k] = torch.cat([carry[k][:u], aux_l[k][None],
                                    carry[k][u + 1:]])
        else:
            new["aux"] = carry["aux"] + aux_l
        return new

    def stage_body(bundle, val, *sh):
        p_s, b_s, l_s = bundle
        m = int(val["m"])
        if shared_kind == "activation":
            sh = tuple(tree_map(lambda a: a.narrow(0, m * mbsz, mbsz), t)
                       for t in sh)
        carry = {k: v for k, v in val.items() if k != "m"}
        layers = list(zip(*(torch.unbind(a) for a in tree_leaves(p_s))))
        for j in range(lps):
            carry = torch.utils.checkpoint.checkpoint(
                layer, carry, tree_unflatten(p_s, list(layers[j])),
                {k: v[j] for k, v in b_s.items()}, int(l_s[j]), m, sh,
                use_reentrant=False, preserve_rng_state=False)
        return dict(carry, m=val["m"])

    f32 = dict(dtype=torch.float32, device=x0.device)
    val0 = {"h": x0.reshape((M, mbsz) + x0.shape[1:]),
            "m": torch.arange(M)}
    if moe_experts:
        val0["frac"] = torch.zeros((M, n_units, moe_experts), **f32)
        val0["p"] = torch.zeros((M, n_units, moe_experts), **f32)
    else:
        val0["aux"] = torch.zeros((M,), **f32)
    out = pipeline_apply((stage_p, stage_b, stage_l), val0, stage_body, mesh,
                         schedule=sched, shared=shared)
    y = out["h"].reshape((bsz,) + out["h"].shape[2:])
    if moe_experts:
        # the full-batch statistics are the means of the microbatches'; the
        # bilinear recombination after the mean is the engine's aux
        frac = torch.mean(out["frac"], dim=0)                  # [L, E]
        probs_mean = torch.mean(out["p"], dim=0)               # [L, E]
        aux_sum = torch.sum(torch.stack([
            L.moe_aux_from_stats(frac[u], probs_mean[u])
            for u in range(n_units)]))
    else:
        aux_sum = torch.sum(out["aux"]) / M
    return y, aux_sum


def _quantize_stack(stacked, bits):
    """``quantize_weight_tree`` of every unit's slice in that unit's weight
    format, over the whole [L, ...] stack at once (the bits broadcast
    over each leaf's unit axis); a leaf whose unit slice is a vector stays
    as it is, as ``quantize_weight_tree`` keeps it."""
    def q(a):
        if a.dim() < 3:
            return a
        shape = (-1,) + (1,) * (a.dim() - 1)
        return maybe_quantize(a, bits.w_i.reshape(shape),
                              bits.w_f.reshape(shape), bits.enabled)
    return tree_map(q, stacked)


def _pipeline_metrics(pipeline_schedule, pipeline_stages, num_microbatches):
    """Resolve the pipeline knob into (Schedule | None, metric dict).

    The schedule is validated when the step is built (unknown names and
    uneven virtual-stage counts fail then, not mid-training), and its
    tick-table estimates go into every step's metrics, so that the
    bubble/memory tradeoff shows in the training logs.
    """
    if pipeline_schedule is None:
        return None, {}
    sched = get_schedule(pipeline_schedule)
    S = int(pipeline_stages) if pipeline_stages else 1
    M = int(num_microbatches) if num_microbatches else 1
    sched.validate(S, M)
    plan = sched.plan(S, M)
    return sched, {
        "pipe_bubble": torch.tensor(plan.bubble, dtype=torch.float32),
        "pipe_ticks": torch.tensor(plan.num_ticks, dtype=torch.int32),
        "pipe_peak_mb": torch.tensor(plan.peak_activation_microbatches,
                                     dtype=torch.int32),
    }


# ---------------------------------------------------------------------------
# The train step
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class StepOptions:
    """Everything that selects how a train step executes.  ``None`` for
    ``kernel_backend``, ``overlap``, ``transport`` or ``bit_anneal``
    defers to the policy, and for the ``pipeline_*`` fields means the
    feature is off; ``bit_anneal`` takes a spec string (normalised to an
    ``AnnealSchedule``) or an ``AnnealSchedule``.  Seed one from a
    policy's knobs and override with ``StepOptions.from_policy(policy,
    overlap="on")``."""

    engine: str = "taxonn"
    kernel_backend: Optional[str] = None
    pipeline_schedule: Any = None
    pipeline_stages: Optional[int] = None
    num_microbatches: Optional[int] = None
    overlap: Optional[str] = None
    transport: Optional[str] = None
    bit_anneal: Any = None  # spec str | AnnealSchedule | None

    def __post_init__(self):
        if self.engine not in ("taxonn", "autodiff"):
            raise ValueError(f"engine must be 'taxonn' or 'autodiff', "
                             f"got {self.engine!r}")
        if isinstance(self.bit_anneal, str):
            object.__setattr__(self, "bit_anneal",
                               AnnealSchedule.parse(self.bit_anneal))
        elif (self.bit_anneal is not None
              and not isinstance(self.bit_anneal, AnnealSchedule)):
            raise ValueError(
                f"bit_anneal must be an anneal spec string or an "
                f"AnnealSchedule, got {type(self.bit_anneal).__name__}")
        if self.kernel_backend not in (None, "off", "emulate", "int8", "auto"):
            raise ValueError(f"kernel_backend must be 'off', 'emulate', "
                             f"'int8' or 'auto', got {self.kernel_backend!r}")
        if self.overlap not in (None, "off", "on"):
            raise ValueError(f"overlap must be 'off' or 'on', "
                             f"got {self.overlap!r}")
        if self.transport not in (None, "auto", "ring", "psum", "scatter"):
            raise ValueError(f"transport must be 'auto', 'ring', 'psum' or "
                             f"'scatter', got {self.transport!r}")

    @classmethod
    def from_policy(cls, policy: QuantPolicy, **overrides) -> "StepOptions":
        """Seed the execution knobs from the policy's own fields (what
        ``make_train_step`` would resolve to anyway), then apply
        ``overrides``."""
        base = dict(kernel_backend=policy.kernel_backend,
                    overlap=policy.overlap, transport=policy.dw_transport,
                    bit_anneal=policy.bit_anneal)
        base.update(overrides)
        return cls(**base)

    def replace(self, **kw) -> "StepOptions":
        return dataclasses.replace(self, **kw)


def make_train_step(cfg: ModelConfig, policy: Optional[QuantPolicy] = None,
                    optim_cfg: Optional[OptimizerConfig] = None,
                    options: Optional[StepOptions] = None, *, device=None):
    """Build the train step described by ``options`` (a ``StepOptions``)
    for ``device`` (CUDA unless named).  ``kernel_backend`` "auto" means
    int8 on CUDA and off on the CPU.  ``overlap`` ("off" | "on") and
    ``transport`` ("auto" | "ring" | "psum" | "scatter") override the
    policy's ``overlap`` and ``dw_transport``: the overlapped dW reduce of
    the engine's backward loop and the wire it rides (``core.taxonn``,
    ``dist.async_collectives``; prime the autotuner's measured decisions
    with ``prime_transport_cache`` before the first step, which only reads
    the cache or the model).

    ``pipeline_schedule`` ("gpipe" | "1f1b" | "interleaved" or a
    ``dist.pipeline.Schedule``) declares the schedule the step runs under
    with ``pipeline_stages`` stages and the batch split into
    ``num_microbatches`` microbatches.  It is validated here and its
    tick-table estimates (``pipe_bubble``, ``pipe_ticks``,
    ``pipe_peak_mb``) go into every step's metrics, on both engines.  With
    ``pipeline_stages > 1`` the TaxoNN engine's blocks stack executes
    stage-sharded through ``dist.pipeline.pipeline_apply``
    (``_pipeline_stack_forward``; the stages on the "pipe" dimension of
    the ambient mesh, ``dist.mesh_ctx``, where it has one); with one stage
    the schedule is a cost model only and the step is the engine's.  The
    returned step exposes the schedule as ``.pipeline_schedule``.  (The
    JAX package's legacy per-knob keywords are not ported.)"""
    options = options or StepOptions()
    dev = resolve_device(device)
    B.require_ported(cfg)
    policy = policy or QuantPolicy.off()
    if options.overlap is not None:
        policy = dataclasses.replace(policy, overlap=options.overlap)
    if options.transport is not None:
        policy = dataclasses.replace(policy, dw_transport=options.transport)
    optim_cfg = optim_cfg or OptimizerConfig()
    backend = resolve_backend(
        options.kernel_backend if options.kernel_backend is not None
        else policy.kernel_backend, dev)
    anneal = options.bit_anneal
    if anneal is None and policy.bit_anneal:
        anneal = AnnealSchedule.parse(policy.bit_anneal)
    sched, pipe_metrics = _pipeline_metrics(options.pipeline_schedule,
                                            options.pipeline_stages,
                                            options.num_microbatches)
    pipe_metrics = {k: v.to(dev) for k, v in pipe_metrics.items()}
    if options.engine == "autodiff":
        # the anneal is accepted for parity with the engine; bits unused
        step = _autodiff_step(cfg, optim_cfg, dev)
    else:
        pipe = None
        if sched is not None and options.pipeline_stages \
                and int(options.pipeline_stages) > 1:
            _check_pipeline_exec(cfg, policy, int(options.pipeline_stages))
            pipe = (sched, int(options.pipeline_stages),
                    int(options.num_microbatches or 1))
        step = _taxonn_step(cfg, policy, optim_cfg, dev, anneal, pipe)

    def run(params, opt_state, batch, hyper: Hyper, bits=None, rng=None):
        check_model_axis(cfg, policy, options.pipeline_stages)
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        if rng is not None:
            rng = prng.as_key(rng)
        with kernel_backend_ctx(backend, dev):
            new_params, new_opt, metrics = step(params, opt_state, batch,
                                                hyper, bits, rng)
        metrics.update(pipe_metrics)
        return new_params, new_opt, metrics

    run.backend, run.device, run.bit_anneal = backend, dev, anneal
    run.pipeline_schedule = sched
    return run


def _autodiff_step(cfg, optim_cfg, dev):
    def step(params, opt_state, batch, hyper, bits=None, rng=None):
        specs = _step_specs(cfg)
        pg = _requires_grad(params)
        with torch.enable_grad():
            loss, metrics = lm.loss_fn(pg, cfg, batch)
            grads = _grad_leaves([loss], pg, None)
        gsq = _sq_sums(grads, specs, loss)
        new_params, new_opt = {}, {}
        for k in params:  # grouped like the engine's state layout
            new_params[k], new_opt[k] = apply_update(
                params[k], grads[k], opt_state[k], hyper, optim_cfg,
                specs=None if specs is None else specs[k])
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["grad_norm"] = torch.sqrt(gsq)
        return new_params, new_opt, metrics
    return step


def _taxonn_step(cfg, policy, optim_cfg, dev, anneal=None, pipe=None):
    """The engine's step; with ``pipe`` = (schedule, stages,
    microbatches) the blocks stack runs stage-sharded
    (``_pipeline_stack_forward``) under one autograd pass and its stacked
    dW goes through ``apply_stacked_updates``; the rest of the step is the
    engine's."""
    scale = policy.grad_scale

    def step(params, opt_state, batch, hyper, bits, rng=None):
        if anneal is not None:
            # the step-indexed F-bit ramp: the bits stay runtime data, and
            # a resume at step N continues the ramp bitwise
            bits = anneal.apply_tree({k: v.to(dev) for k, v in bits.items()},
                                     hyper.step)
        main_bits = bits["blocks"].to(dev)
        specs = _step_specs(cfg)
        bnd = {k: params[k] for k in boundary_keys(params)}
        bnd_g = _requires_grad(bnd)
        tokens = batch["tokens"]
        bsz, tlen = tokens.shape
        total_t = tlen + (batch["patch_embeds"].shape[1]
                          if cfg.family == "vlm" else 0)
        positions = torch.arange(total_t, device=dev).expand(bsz, total_t)

        # ---- encoder forward (encdec), and enc_norm under autograd -------
        if cfg.family == "encdec":
            enc_bits = bits["enc_blocks"].to(dev)
            dt = lm.compute_dtype(cfg)
            frames = batch["frames"].to(dt)
            enc_x0 = frames + lm._sinusoid(frames.shape[1], cfg.d_model,
                                           device=dev).to(dt)
            s_len = frames.shape[1]
            enc_body = _enc_body(cfg, torch.arange(s_len, device=dev)
                                 .expand(bsz, s_len))
            e_last, enc_caches, _ = forward_stack(
                enc_body, params["enc_blocks"], enc_x0, enc_bits, policy)
            with torch.enable_grad():
                e_last = e_last.detach().requires_grad_()
                enc_out = L.apply_norm(bnd_g["enc_norm"], e_last, cfg)

        # ---- embed, kept under autograd for the input-side gradient -----
        with torch.enable_grad():
            x0 = _embed_fn(cfg, batch, policy, _bits_edge(main_bits, 0))(
                bnd_g)

        # ---- main stack forward, caching quantized X_i -------------------
        # the hybrid's shared operand: the weight-tied block, quantized
        # with each group's weight format; the encdec's: the encoder's
        # output, an activation quantized once here in the last encoder
        # unit's activation format
        body = _make_body(cfg, positions)
        shared, quantize_shared = (), cfg.family == "hybrid"
        if cfg.family == "hybrid":
            shared = (params["shared_attn"],)
        elif cfg.family == "encdec":
            enc_q = enc_out.detach()
            if policy.quantize_acts:
                eb = _bits_edge(enc_bits, -1)
                enc_q = _blend_quant(enc_q, eb["a_i"], eb["a_f"],
                                     eb["enabled"])
            shared = (enc_q,)
        if pipe is not None:
            # the bodies run a microbatch at a time: microbatch-shaped
            # positions, and the shared operand, the stack and x0 as
            # autograd inputs of the one backward below
            sched, n_stages, n_mb = pipe
            if bsz % n_mb:
                raise ValueError(f"global batch {bsz} does not divide into "
                                 f"num_microbatches={n_mb}")
            pos_mb = torch.arange(total_t, device=dev).expand(bsz // n_mb,
                                                              total_t)
            with torch.enable_grad():
                blocks_g = _requires_grad(params["blocks"])
                shared_g = tuple(_requires_grad(t) for t in shared)
                x0_g = x0.detach().requires_grad_()
                y_pipe, aux_pipe = _pipeline_stack_forward(
                    _make_body(cfg, pos_mb,
                               moe_aux_parts=cfg.family == "moe"),
                    blocks_g, main_bits, policy, x0_g, sched, n_stages,
                    n_mb, current_mesh(), shared=shared_g,
                    shared_kind=lm.SHARED_OPERAND_KIND[cfg.family],
                    moe_experts=(cfg.num_experts if cfg.family == "moe"
                                 else None), rng=rng)
            x_final, aux_sum = y_pipe.detach(), aux_pipe.detach()
        else:
            x_final, caches, aux_sum = forward_stack(
                body, params["blocks"], x0.detach(), main_bits, policy,
                shared=shared, quantize_shared=quantize_shared)

        # ---- head (loss), seeded with grad_scale --------------------------
        head_f = _head_fn(cfg, batch, policy, _bits_edge(main_bits, -1))
        with torch.enable_grad():
            xf = x_final.detach().requires_grad_()
            loss, metrics = head_f(bnd_g, xf)
            seed = torch.tensor(scale, dtype=torch.float32, device=dev)
            d_bnd_head = _grad_leaves([loss], {"b": bnd_g, "x": xf}, [seed])
        G_final = d_bnd_head.pop("x")
        d_bnd_head = d_bnd_head["b"]
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["aux"] = aux_sum
        metrics["loss_total"] = metrics["loss"] + AUX_COEF * aux_sum

        if pipe is not None:
            # ---- the G-chain through the stages: autograd, the grad taps
            # quantizing G; the aux seeded with its coefficient (the
            # recombination after the drain spreads it over the layers and
            # microbatches); then the stacked dW's update tail with the
            # engine's per-layer keys -------------------------------------
            outs, seeds = [y_pipe], [G_final.to(y_pipe.dtype)]
            if aux_pipe.requires_grad:
                outs.append(aux_pipe)
                seeds.append(torch.tensor(AUX_COEF * scale,
                                          dtype=torch.float32, device=dev))
            wrt = tree_leaves(blocks_g) + tree_leaves(shared_g) + [x0_g]
            with torch.enable_grad():
                grads = torch.autograd.grad(outs, wrt, seeds,
                                            allow_unused=True)
            del outs, y_pipe, aux_pipe
            grads = [torch.zeros_like(w) if g is None else g
                     for g, w in zip(grads, wrt)]
            n_b, n_s = len(tree_leaves(blocks_g)), len(tree_leaves(shared_g))
            d_blocks = tree_unflatten(params["blocks"], [
                g.to(torch.float32) / scale for g in grads[:n_b]])
            dshared = tree_unflatten(shared, grads[n_b:n_b + n_s])
            G_in = grads[-1]
            del grads, wrt, blocks_g, shared_g
            new_blocks, new_blocks_opt, gsq = apply_stacked_updates(
                params["blocks"], d_blocks, opt_state["blocks"], main_bits,
                hyper, policy, optim_cfg, base_key=rng)
            del d_blocks
        else:
            # ---- the G-chain: reverse loop with fused per-layer updates --
            G_in, new_blocks, new_blocks_opt, gsq, dshared = backward_stack(
                body, params["blocks"], opt_state["blocks"], caches,
                main_bits, G_final, hyper, policy, optim_cfg, AUX_COEF,
                base_key=rng, shared=shared, quantize_shared=quantize_shared,
                specs=None if specs is None else specs["blocks"])
            del caches
        new_params, new_opt = dict(params), dict(opt_state)
        new_params["blocks"], new_opt["blocks"] = new_blocks, new_blocks_opt

        # ---- the shared block's one update, from dS summed over groups ---
        if cfg.family == "hybrid":
            d_sh = tree_map(lambda g: g / scale, dshared[0])
            new_params["shared_attn"], new_opt["shared_attn"] = apply_update(
                params["shared_attn"], d_sh, opt_state["shared_attn"],
                hyper, optim_cfg)
            gsq = gsq + _sq_sum(d_sh, gsq)

        # ---- encoder backward (encdec): dS, summed over the decoder's
        # layers in the scaled domain, through enc_norm and the encoder's
        # reverse loop, keyed as the decoder's -----------------------------
        d_enc_norm = None
        if cfg.family == "encdec":
            with torch.enable_grad():
                d_enc_norm, d_e_last = _grad_leaves(
                    [enc_out], (bnd_g["enc_norm"], e_last),
                    [dshared[0].to(enc_out.dtype)])
            del enc_out, dshared
            _, new_enc, new_enc_opt, gsq_e, _ = backward_stack(
                enc_body, params["enc_blocks"], opt_state["enc_blocks"],
                enc_caches, enc_bits, d_e_last, hyper, policy, optim_cfg,
                AUX_COEF, base_key=rng)
            new_params["enc_blocks"] = new_enc
            new_opt["enc_blocks"] = new_enc_opt
            gsq = gsq + gsq_e

        # ---- boundary updates (embed: head + input contributions) --------
        with torch.enable_grad():
            d_bnd_embed = _grad_leaves([x0], bnd_g, [G_in.to(x0.dtype)])
        d_bnd = tree_map(lambda a, b: (a.to(torch.float32)
                                       + b.to(torch.float32)) / scale,
                         d_bnd_head, d_bnd_embed)
        if d_enc_norm is not None:
            d_bnd["enc_norm"] = tree_map(
                lambda a, g: a + g.to(torch.float32) / scale,
                d_bnd["enc_norm"], d_enc_norm)
        for k in bnd:
            sk = None if specs is None else specs[k]
            new_params[k], new_opt[k] = apply_update(
                bnd[k], d_bnd[k], opt_state[k], hyper, optim_cfg, specs=sk)
            gsq = gsq + _sq_sums(d_bnd[k], sk, gsq)
        metrics["grad_norm"] = torch.sqrt(gsq)
        return new_params, new_opt, metrics
    return step


def make_eval_step(cfg: ModelConfig):
    @torch.no_grad()
    def eval_step(params, batch):
        _, metrics = lm.loss_fn(params, cfg, batch)
        return metrics
    return eval_step
