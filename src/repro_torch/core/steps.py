"""Train/eval step builders: the TaxoNN engine against the autodiff baseline
(port of ``core/steps.py``: the dense, ssm and hybrid families, single
device).

``make_train_step(cfg, policy, optim_cfg, options, device=None)`` returns

    step(params, opt_state, batch, hyper, bits, rng=None)
        -> (params, opt_state, metrics)

engine="taxonn"   -- the paper's unrolled G-chain with per-layer fused
                     updates (``core.taxonn``)
engine="autodiff" -- autograd over the whole loss and one optimizer apply
                     (the "conventional accelerator" baseline, and the
                     engine's correctness oracle)

``bits`` is a dict of BitSchedules keyed by stack name ("blocks"); they are
runtime data, so one step object serves every schedule.  The hybrid's
engine unit is a group (the shared block, then K Mamba layers), so its
schedule has one entry a group; the weight-tied ``shared_attn`` block is
the engine's shared operand, quantized with each group's weight format,
its gradient summed over the groups and applied once after the reverse
loop with its own optimizer state.  The step is
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
Pipeline execution (with its ``grad_tap_stochastic``) and the overlap and
transport options wait for multi-GPU (ROADMAP A11).
``capture_resume_extra`` and ``apply_resume_extra`` carry the train
driver's resume payload; the noise and the anneal depend only on the
step, so the payload needs no PRNG state, and the anneal spec rides along
only to guard against resuming under another ramp.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Optional

import torch

from repro_torch import resolve_device
from repro_torch.core.taxonn import (QuantPolicy, backward_stack,
                                     default_bits_for, forward_stack,
                                     quantize_weight_tree)
from repro_torch.kernels.ops import kernel_backend_ctx, resolve_backend
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.models.config import ModelConfig
from repro_torch.optim import Hyper, OptimizerConfig, apply_update
from repro_torch.optim import init_opt_state
from repro_torch.search.anneal import AnnealSchedule
from repro_torch.util import prng
from repro_torch.util.tree import tree_leaves, tree_map, tree_unflatten

AUX_COEF = lm.AUX_COEF


ENGINE_FAMILIES = ("dense", "ssm", "hybrid")
_LATER_ITEM = {"moe": "A9c", "encdec": "A9e", "vlm": "A9e"}


def require_engine_family(cfg: ModelConfig) -> None:
    """Raise unless the engine trains ``cfg``: the dense, ssm and hybrid
    families with no MLA (moe, MLA, encdec and vlm wait for ROADMAP
    A9c-e)."""
    if cfg.family not in ENGINE_FAMILIES or cfg.use_mla:
        item = "A9d" if cfg.use_mla else _LATER_ITEM.get(cfg.family, "A9")
        raise NotImplementedError(
            f"the port's training engine covers the dense, ssm and hybrid "
            f"families (no MLA) so far, not {cfg.family}"
            f"{' with MLA' if cfg.use_mla else ''} (ROADMAP {item})")


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
    require_engine_family(cfg)
    return lm.stack_units(cfg)


def default_bits(cfg: ModelConfig, enabled: bool = True) -> dict:
    return {"blocks": default_bits_for(num_scan_units(cfg), enabled)}


# ---------------------------------------------------------------------------
# Resume-state capture: everything a bitwise restart needs beyond params
# ---------------------------------------------------------------------------

RESUME_SCHEMA = 1


def capture_resume_extra(cfg: ModelConfig, step: int, *, loader=None,
                         user_extra: Optional[dict] = None,
                         anneal=None) -> dict:
    """The checkpoint ``extra`` payload that makes a restart BITWISE: the
    data-pipeline step, so the step-indexed loader replays the exact batch
    stream (the lr schedule is a function of the step too).  The keys are
    the JAX package's; its transport and kernel tune caches are written
    empty, since the port has no tuner (ROADMAP A8, A11).  ``anneal`` (a
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
        "transport_cache": {},
        "tune_cache": {},
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
    gemma is silent corruption the shape check alone may not catch.  A
    JAX-written payload's transport and tune caches are not installed (the
    port has no tuner).  A payload annealed under another spec than
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
    caches = {k: len(extra.get(k) or {})
              for k in ("transport_cache", "tune_cache")}
    if any(caches.values()):
        print(f"[train] checkpoint carries {caches['transport_cache']} "
              f"transport-cache and {caches['tune_cache']} tune-cache "
              f"decision(s); the port has no tuner and does not install "
              f"them", flush=True)
    return int(extra.get("data_step", ckpt_step))


# ---------------------------------------------------------------------------
# The stack body and the boundary (embed / head) functions
# ---------------------------------------------------------------------------

def _make_body(cfg: ModelConfig, positions):
    """body(params_slice, x, bits_l, *shared) -> (y, aux): the blocks of one
    unit (``lm.unit_blocks``), their aux summed.  The hybrid's unit is a
    group, the shared block then its K Mamba layers."""
    require_engine_family(cfg)

    def body(p, x, b_l, *shared):
        aux = None
        for kind, bp, _ in lm.unit_blocks(p, cfg, *shared):
            x, a = lm.block_fn(kind)(bp, x, cfg, positions)
            aux = a if aux is None else aux + a
        return x, aux
    return body


def _embed_fn(cfg: ModelConfig, batch, policy: QuantPolicy, bits0):
    """x0 from the boundary params; the embedding is quantized with the
    first layer's weight format."""
    def f(bnd):
        emb = bnd["embed"]
        if policy.quantize_weights:
            emb = quantize_weight_tree(emb, bits0["w_i"], bits0["w_f"],
                                       bits0["enabled"], True)
        x0, _ = lm.embed_input({"embed": emb}, cfg, batch)
        return x0
    return f


def _head_fn(cfg: ModelConfig, batch, policy: QuantPolicy, bits_last):
    """(loss, metrics) from the boundary params and the stack's output; the
    head weight (the tied embedding's transpose) is quantized with the last
    layer's weight format."""
    def f(bnd, xf):
        x = L.apply_norm(bnd["final_norm"], xf, cfg)
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


def _requires_grad(tree):
    return tree_map(lambda w: w.detach().requires_grad_(), tree)


def _sq_sum(tree, like: torch.Tensor) -> torch.Tensor:
    total = torch.zeros((), dtype=torch.float32, device=like.device)
    for g in tree_leaves(tree):
        total = total + torch.sum(torch.square(g.to(torch.float32)))
    return total


# ---------------------------------------------------------------------------
# The train step
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class StepOptions:
    """Everything that selects how a train step executes.  ``None`` for
    ``kernel_backend`` or ``bit_anneal`` defers to the policy;
    ``bit_anneal`` takes a spec string (normalised to an
    ``AnnealSchedule``) or an ``AnnealSchedule``.  (The JAX package's
    pipeline, overlap and transport fields come with multi-GPU: ROADMAP
    A11.)"""

    engine: str = "taxonn"
    kernel_backend: Optional[str] = None
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


def make_train_step(cfg: ModelConfig, policy: Optional[QuantPolicy] = None,
                    optim_cfg: Optional[OptimizerConfig] = None,
                    options: Optional[StepOptions] = None, *, device=None):
    """Build the train step described by ``options`` (a ``StepOptions``)
    for ``device`` (CUDA unless named).  ``kernel_backend`` "auto" means
    int8 on CUDA and off on the CPU.  (The JAX package's legacy per-knob
    keywords are not ported.)"""
    options = options or StepOptions()
    dev = resolve_device(device)
    require_engine_family(cfg)
    policy = policy or QuantPolicy.off()
    optim_cfg = optim_cfg or OptimizerConfig()
    backend = resolve_backend(
        options.kernel_backend if options.kernel_backend is not None
        else policy.kernel_backend, dev)
    anneal = options.bit_anneal
    if anneal is None and policy.bit_anneal:
        anneal = AnnealSchedule.parse(policy.bit_anneal)
    if options.engine == "autodiff":
        # the anneal is accepted for parity with the engine; bits unused
        step = _autodiff_step(cfg, optim_cfg, dev)
    else:
        step = _taxonn_step(cfg, policy, optim_cfg, dev, anneal)

    def run(params, opt_state, batch, hyper: Hyper, bits=None, rng=None):
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        if rng is not None:
            rng = prng.as_key(rng)
        with kernel_backend_ctx(backend, dev):
            return step(params, opt_state, batch, hyper, bits, rng)

    run.backend, run.device, run.bit_anneal = backend, dev, anneal
    return run


def _autodiff_step(cfg, optim_cfg, dev):
    def step(params, opt_state, batch, hyper, bits=None, rng=None):
        pg = _requires_grad(params)
        with torch.enable_grad():
            loss, metrics = lm.loss_fn(pg, cfg, batch)
            grads = _grad_leaves([loss], pg, None)
        gsq = _sq_sum(grads, loss)
        new_params, new_opt = {}, {}
        for k in params:  # grouped like the engine's state layout
            new_params[k], new_opt[k] = apply_update(
                params[k], grads[k], opt_state[k], hyper, optim_cfg)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["grad_norm"] = torch.sqrt(gsq)
        return new_params, new_opt, metrics
    return step


def _taxonn_step(cfg, policy, optim_cfg, dev, anneal=None):
    scale = policy.grad_scale

    def step(params, opt_state, batch, hyper, bits, rng=None):
        if anneal is not None:
            # the step-indexed F-bit ramp: the bits stay runtime data, and
            # a resume at step N continues the ramp bitwise
            bits = anneal.apply_tree({k: v.to(dev) for k, v in bits.items()},
                                     hyper.step)
        main_bits = bits["blocks"].to(dev)
        bnd = {k: params[k] for k in boundary_keys(params)}
        tokens = batch["tokens"]
        bsz, tlen = tokens.shape
        positions = torch.arange(tlen, device=dev).expand(bsz, tlen)

        # ---- embed, kept under autograd for the input-side gradient -----
        bnd_g = _requires_grad(bnd)
        with torch.enable_grad():
            x0 = _embed_fn(cfg, batch, policy, _bits_edge(main_bits, 0))(
                bnd_g)

        # ---- main stack forward, caching quantized X_i -------------------
        # the hybrid's shared operand: the weight-tied block, quantized
        # with each group's weight format
        body = _make_body(cfg, positions)
        shared = ((params["shared_attn"],) if cfg.family == "hybrid"
                  else ())
        x_final, caches, aux_sum = forward_stack(
            body, params["blocks"], x0.detach(), main_bits, policy,
            shared=shared)

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

        # ---- the G-chain: reverse loop with fused per-layer updates ------
        G_in, new_blocks, new_blocks_opt, gsq, dshared = backward_stack(
            body, params["blocks"], opt_state["blocks"], caches, main_bits,
            G_final, hyper, policy, optim_cfg, AUX_COEF, base_key=rng,
            shared=shared)
        new_params, new_opt = dict(params), dict(opt_state)
        new_params["blocks"], new_opt["blocks"] = new_blocks, new_blocks_opt

        # ---- the shared block's one update, from dS summed over groups ---
        if shared:
            d_sh = tree_map(lambda g: g / scale, dshared[0])
            new_params["shared_attn"], new_opt["shared_attn"] = apply_update(
                params["shared_attn"], d_sh, opt_state["shared_attn"],
                hyper, optim_cfg)
            gsq = gsq + _sq_sum(d_sh, gsq)

        # ---- boundary updates (embed: head + input contributions) --------
        with torch.enable_grad():
            d_bnd_embed = _grad_leaves([x0], bnd_g, [G_in.to(x0.dtype)])
        d_bnd = tree_map(lambda a, b: (a.to(torch.float32)
                                       + b.to(torch.float32)) / scale,
                         d_bnd_head, d_bnd_embed)
        for k in bnd:
            new_params[k], new_opt[k] = apply_update(
                bnd[k], d_bnd[k], opt_state[k], hyper, optim_cfg)
            gsq = gsq + _sq_sum(d_bnd[k], gsq)
        metrics["grad_norm"] = torch.sqrt(gsq)
        return new_params, new_opt, metrics
    return step


def make_eval_step(cfg: ModelConfig):
    @torch.no_grad()
    def eval_step(params, batch):
        _, metrics = lm.loss_fn(params, cfg, batch)
        return metrics
    return eval_step
