"""Training driver: checkpoint/restart, straggler-tolerant data loading,
fault-injection drills, the TaxoNN layer engine (port of
``repro/launch/train.py``, single device).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \
        --steps 200 --ckpt-dir /tmp/run1 [--resume]

It runs on the card unless ``--device cpu`` is given, and raises when CUDA
is absent; ``--kernel-backend auto`` is int8 on CUDA and off on the CPU.
Fault tolerance: atomic verified async checkpoints every ``--ckpt-every``
steps carry the resume payload (``core.steps.capture_resume_extra``); on
restart the step-indexed data pipeline resumes exactly, so a restart is
BITWISE identical to the uninterrupted run.  ``--fault-plan`` (or
``REPRO_FAULT_PLAN``) injects deterministic faults -- crash-at-step,
checkpoint IO/fsync/rename failures, straggler stalls, post-save bit flips
(see ``repro_torch.ft``); a restart past a corrupted LATEST falls back to
the newest valid checkpoint with a loud warning.  The checkpoint format is
the JAX package's, so either driver resumes the other's checkpoints.

``--stochastic`` rounds G (and, with ``--quantize-updates``, the update)
stochastically with the JAX driver's keys, ``fold_in(key(1), step)`` a
step, so the noise is JAX's and depends only on the step: the resume
payload carries no PRNG state and a resumed run draws the same noise.
The synthetic loader makes tokens and labels only; an encoder-decoder's
``frames`` [B, encoder_seq, D] and a vlm's ``patch_embeds``
[B, num_patches, D] are standard normals drawn a step, as the JAX driver
draws them, from ``fold_in(key(2), step)`` and ``fold_in(key(3), step)``
(``util.prng.normal``), so a resumed run replays them too.

``--bit-anneal`` ramps the F bits with the step (``search.anneal``); the
spec rides in the checkpoint, and a resume under another spec is refused.
``--bit-search GROUPS`` runs a per-layer-group (I,F) sensitivity sweep
(``search.sensitivity.run_sweep_lm``, on the card its probes launch the
engine's kernels) before training, writes ``bit_plan.json`` and its int8
serving export ``bit_plan_serve.json`` under ``--ckpt-dir`` (or
``artifacts/``), checks the train<->serve int8 parity
(``search.export``) and trains with the plan.

``--compress-dw`` routes each layer's dW through the int8 block-scaled
wire format (``dist.collectives.compressed_psum``) in the engine's
backward loop: on one device the codec round trip, as the JAX driver's.
``--overlap on`` software-pipelines each layer's dW reduce
``--overlap-depth`` layers deep over the transport ``--transport`` picks
(``core.taxonn``, ``dist.async_collectives``); on one device it is a pure
schedule change.  After any restore (whose transport and tune-cache
decisions are installed first and stay cache hits) the transport cache is
primed for the run's dW leaf sizes where the data group has more than one
member (``prime_transports``), and the kernel tune cache for the run's
shapes (``kernels.ops``).

``--pipeline-schedule gpipe|1f1b|interleaved`` (with ``--virtual-stages``
for interleaved and ``--microbatches``) runs the blocks stack through
``dist.pipeline`` in ``num_virtual`` x the pipe axis's stages (the JAX
driver's ``n_stages``): with more than one stage it executes
stage-sharded (``core.steps._pipeline_stack_forward``), with one it is a
cost model only and the step is the engine's; the driver prints the JAX
driver's ``[train] pipeline ...`` line.  The driver is one process, so its
pipe axis has one rank: ``--pipe`` > 1, ``--data`` and ``--model`` wait
for the driver's multi-rank launch (ROADMAP A11.3b; the tensor-parallel
step itself runs under ``dist.mesh_ctx``) and are refused by name, and
the data group has one member.
"""
from __future__ import annotations

import argparse
import dataclasses
import tempfile
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.ckpt import AsyncCheckpointer, latest_step, restore_checkpoint
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.core import QuantPolicy, StepOptions, make_train_step
from repro_torch.core.steps import (apply_resume_extra, capture_resume_extra,
                                    default_bits, init_train_state)
from repro_torch.data import SyntheticLMDataset, StragglerTolerantLoader
from repro_torch.dist.async_collectives import prime_transport_cache
from repro_torch.dist.pipeline import get_schedule
from repro_torch.ft import FaultPlan
from repro_torch.kernels.ops import (prime_tune_cache, train_tune_shapes,
                                     tune_cache_stats)
from repro_torch.models import lm
from repro_torch.optim import Hyper, OptimizerConfig, cosine_schedule
from repro_torch.util import prng
from repro_torch.util.tree import tree_leaves


def _reduce(cfg):
    """Small same-family twin for CPU runs (--reduced)."""
    changes = dict(num_layers=min(cfg.num_layers, 4), d_model=128,
                   vocab_size=512, compute_dtype="float32")
    if cfg.num_heads:
        kv = cfg.num_kv_heads if cfg.num_kv_heads == cfg.num_heads else 2
        changes.update(num_heads=4, num_kv_heads=min(kv, 4), head_dim=32)
    if cfg.d_ff:
        changes.update(d_ff=256)
    if cfg.family == "moe":
        changes.update(num_experts=4, experts_per_token=2, moe_d_ff=64)
    if cfg.use_mla:
        changes.update(kv_lora_rank=32, qk_nope_dim=32, qk_rope_dim=16,
                       v_head_dim=32)
    if cfg.family in ("ssm", "hybrid"):
        changes.update(ssm_state=16, ssm_head_dim=16, ssm_chunk=32)
    if cfg.family == "hybrid":
        changes.update(num_layers=4, attn_every=2)
    if cfg.family == "encdec":
        changes.update(num_encoder_layers=2, encoder_seq=32)
    if cfg.family == "vlm":
        changes.update(num_patches=8)
    return dataclasses.replace(cfg, **changes)


def modality_inputs(cfg, bsz: int, step: int, device) -> dict:
    """The inputs beside the tokens that a step of ``cfg`` needs, drawn as
    the JAX driver draws them for ``step``: an encdec's ``frames`` from
    ``fold_in(key(2), step)``, a vlm's ``patch_embeds`` from
    ``fold_in(key(3), step)``, standard normals on ``device``."""
    if cfg.family == "encdec":
        return {"frames": prng.normal(prng.fold_in(prng.key(2), step),
                                      (bsz, cfg.encoder_seq, cfg.d_model),
                                      device)}
    if cfg.family == "vlm":
        return {"patch_embeds": prng.normal(
            prng.fold_in(prng.key(3), step),
            (bsz, cfg.num_patches, cfg.d_model), device)}
    return {}


# the JAX driver's flags of multi-GPU items not ported yet (refused by name)
LATER_A11_FLAGS = ("--data", "--model")


def prime_transports(args, cfg, params, n_data: int):
    """Measure the transport decisions for this model's per-layer dW leaf
    sizes before the first step (the step only reads the cache or the
    model), as the JAX driver gates it: ``--overlap on``, ``--transport
    auto`` and a data group of more than one member.  Collective over the
    default process group; decisions a restored checkpoint installed are
    cache hits and are not measured again.  Returns {bucket bytes:
    transport}, or None where the gate is shut."""
    if not (args.overlap == "on" and args.transport == "auto"
            and n_data > 1):
        return None
    leaf_bytes = sorted({x[0].numel() * 4
                         for x in tree_leaves(params["blocks"])})
    decided = prime_transport_cache(leaf_bytes, n_data,
                                    compressed=args.compress_dw)
    picks = ", ".join(f"{b // 1024}kb->{t}" for b, t in decided.items())
    print(f"[train] transport autotuner (g={n_data}): {picks}", flush=True)
    return decided


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_NAMES, default="qwen1.5-0.5b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--optimizer", default="momentum",
                    choices=["sgd", "momentum", "momentum8", "adam"])
    ap.add_argument("--quantize", action="store_true",
                    help="enable the TaxoNN per-layer (I,F) schedule")
    ap.add_argument("--bit-anneal", default=None, metavar="SPEC",
                    help="progressive bitwidth-annealing schedule, e.g. "
                         "'0:off,100:16,400:12': comma-separated STEP:VALUE "
                         "milestones where VALUE is an F-bit floor applied "
                         "on top of the per-layer schedule ('off' = "
                         "quantization disabled until the next milestone); "
                         "bits stay runtime data so the ramp needs no other "
                         "step object and resume continues it bitwise (see "
                         "repro_torch.search.anneal)")
    ap.add_argument("--bit-search", type=int, default=0, metavar="GROUPS",
                    help="run a per-layer-group (I,F) sensitivity sweep on "
                         "this arch before training (GROUPS contiguous "
                         "layer groups; 0 = off) and train with the "
                         "selected plan; the BitPlan + its serving int8 "
                         "export are saved next to the checkpoints (or "
                         "under artifacts/)")
    ap.add_argument("--bit-target", type=float, default=0.1,
                    help="--bit-search loss-delta target vs the f32 "
                         "baseline probe")
    ap.add_argument("--bit-probe-steps", type=int, default=24,
                    help="--bit-search training steps per probe")
    ap.add_argument("--engine", default="taxonn",
                    choices=["taxonn", "autodiff"])
    ap.add_argument("--kernel-backend", default="auto",
                    choices=["auto", "off", "emulate", "int8"],
                    help="dense-unit datapath (auto = int8 on CUDA, off on "
                         "the CPU)")
    ap.add_argument("--stochastic", action="store_true",
                    help="stochastic rounding for the quantized G chain "
                         "(and updates with --quantize-updates); noise is "
                         "keyed per (step, layer, batch row), as the JAX "
                         "driver keys it")
    ap.add_argument("--compress-dw", action="store_true",
                    help="route per-layer dW through the int8 block-scaled "
                         "wire format inside the backward loop")
    ap.add_argument("--overlap", default="off", choices=["off", "on"],
                    help="comm-optimized backward loop: ring-transport dW "
                         "leaves software-pipeline --overlap-depth layers "
                         "deep so the in-flight hops overlap the next "
                         "layers' G-step compute, blocking-transport leaves "
                         "land same-layer updates (fused psum, or the "
                         "sharded sgd update on scatter leaves); each "
                         "bucket's transport comes from the per-size "
                         "autotuner unless --transport forces one")
    ap.add_argument("--overlap-depth", type=int, default=2,
                    help="in-flight dW reduces per layer stream with "
                         "--overlap on (clamped to the layer count; only "
                         "ring-transport leaves defer)")
    ap.add_argument("--transport", default="auto",
                    choices=["auto", "ring", "psum", "scatter"],
                    help="dW all-reduce transport: auto consults the "
                         "measured per-bucket cache (primed at start-up "
                         "for this model's dW sizes; REPRO_TRANSPORT "
                         "overrides everything); ring/psum/scatter force "
                         "one (scatter = native reduce-scatter whose 1/g "
                         "chunk gets the sharded optimizer update)")
    for flag in LATER_A11_FLAGS:
        ap.add_argument(flag, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--pipe", type=int, default=0,
                    help="pipe-axis size (0 = no pipe axis; the driver is "
                         "one process, so more than 1 is refused until "
                         "ROADMAP A11.3b)")
    ap.add_argument("--pipeline-schedule", default="none",
                    choices=["none", "gpipe", "1f1b", "interleaved"],
                    help="pipe-axis pipeline schedule; with stages > 1 the "
                         "engine's blocks stack EXECUTES stage-sharded "
                         "through repro_torch.dist.pipeline for EVERY model "
                         "family (hybrid/encdec shared operands replicate "
                         "or slice per stage, moe aux statistics reduce "
                         "post-drain; layers and batch must divide into "
                         "stages and microbatches)")
    ap.add_argument("--virtual-stages", type=int, default=2,
                    help="virtual stages per pipe device (interleaved "
                         "schedule only)")
    ap.add_argument("--microbatches", type=int, default=8,
                    help="microbatches per step for the pipeline schedule")
    ap.add_argument("--quantize-updates", action="store_true",
                    help="strict paper mode: quantize q(alpha*dW) in the "
                         "layer's gradient (I,F) format before the update")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "PyTorch versions of the kernels)")
    ap.add_argument("--reduced", action="store_true",
                    help="CPU-scale reduced twin of the arch")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--fault-plan", default=None,
                    help="deterministic fault-injection spec for recovery "
                         "drills (falls back to REPRO_FAULT_PLAN), e.g. "
                         "'crash@12;io@8x2;stall@5:0.5;flip@10;seed=7' or "
                         "'crash@rand:8-20;seed=3' -- see "
                         "repro_torch.ft.FaultPlan")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--deadline-s", type=float, default=5.0)
    ap.add_argument("--profile", type=int, default=0, metavar="N",
                    help="capture a torch.profiler trace of the first N "
                         "steps (trace file printed at exit)")
    return ap


def main(argv=None):
    """Train; returns the per-step losses (floats)."""
    ap = _parser()
    args = ap.parse_args(argv)
    later = [f for f in LATER_A11_FLAGS
             if getattr(args, f[2:].replace("-", "_")) is not None]
    if args.pipe > 1:
        later.append("--pipe")
    if later:
        ap.error(f"{', '.join(later)}: the port has the dW reduction, "
                 f"--compress-dw, the overlap and transport options and "
                 f"the stage-sharded pipeline on one process, and the "
                 f"tensor-parallel step under a mesh (dist.sharding, "
                 f"dist.api); the mesh options wait for the rest of "
                 f"ROADMAP A11 (A11.3b: the driver's multi-rank launch)")
    dev = resolve_device(args.device)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = _reduce(cfg)
    print(f"[train] {cfg.name} ({cfg.family}) on {dev} "
          f"params~{cfg.param_count()/1e6:.1f}M", flush=True)

    pipe_sched, n_stages = None, None
    if args.pipeline_schedule != "none":
        pipe_sched = get_schedule(
            args.pipeline_schedule,
            num_virtual=(args.virtual_stages
                         if args.pipeline_schedule == "interleaved" else None))
        # the JAX driver's pipe_axis_size x num_virtual, with a pipe axis
        # of one rank (one process)
        n_stages = pipe_sched.num_virtual
        mode = ("stage-sharded execution" if n_stages > 1
                else "cost model only (1 stage)")
        print(f"[train] pipeline {pipe_sched.name} ({mode}): "
              f"{pipe_sched.summary(n_stages, args.microbatches)}", flush=True)

    ocfg = OptimizerConfig(kind=args.optimizer, grad_clip=1.0)
    policy = (QuantPolicy(grad_scale=64.0) if args.quantize
              else QuantPolicy.off())
    policy = dataclasses.replace(policy, kernel_backend=args.kernel_backend,
                                 compress_dw=args.compress_dw,
                                 overlap=args.overlap,
                                 overlap_depth=args.overlap_depth,
                                 dw_transport=args.transport,
                                 stochastic=args.stochastic,
                                 quantize_updates=args.quantize_updates,
                                 bit_anneal=args.bit_anneal)
    bits = default_bits(cfg, enabled=args.quantize)

    if args.bit_search:
        from repro_torch.search import export as bit_export
        from repro_torch.search.sensitivity import SweepConfig, run_sweep_lm
        if not args.quantize:
            print("[train] note: --bit-search without --quantize — the "
                  "sweep runs quantized probes but training stays fp32",
                  flush=True)
        sweep = SweepConfig(num_groups=args.bit_search,
                            target=args.bit_target,
                            probe_steps=args.bit_probe_steps,
                            batch=args.global_batch, lr=args.lr)
        t_sweep = time.time()
        bit_plan = run_sweep_lm(cfg, ocfg, sweep, seq_len=args.seq_len,
                                log=lambda s: print(f"[bit-search] {s}",
                                                    flush=True),
                                device=dev)
        print(f"[train] bit-search ({bit_plan.probes} probes, "
              f"{time.time() - t_sweep:.1f}s): {bit_plan.describe()}",
              flush=True)
        out_dir = args.ckpt_dir or "artifacts"
        bit_plan.save(f"{out_dir}/bit_plan.json")
        serve_plan = bit_export.to_serve_plan(bit_plan)
        bit_export.save_serve_plan(serve_plan, f"{out_dir}/bit_plan_serve.json")
        parity = bit_export.verify_train_serve_parity(bit_plan, device=dev)
        print(f"[train] train<->serve int8 parity: "
              f"{'OK' if parity['ok'] else 'VIOLATED'} {parity}", flush=True)
        bits["blocks"] = bit_plan.to_bit_schedule(enabled=args.quantize)
    sched = cosine_schedule(args.lr, warmup=max(10, args.steps // 20),
                            total=args.steps)

    params = lm.init_params(cfg, seed=0, device=dev)
    opt_state = init_train_state(params, ocfg)
    start_step = 0

    plan = FaultPlan.from_env(args.fault_plan)
    if plan is not None:
        print(f"[train] fault plan: {plan.describe()}", flush=True)

    # restore BEFORE priming: the checkpoint's resume payload carries the
    # killed run's transport and tune-cache decisions, and installing them
    # first keeps the resumed collective schedule and kernel splits (and
    # so the numerics) the killed run's
    if (args.resume and args.ckpt_dir
            and latest_step(args.ckpt_dir) is not None):
        (params, opt_state), ckpt_step, extra = restore_checkpoint(
            args.ckpt_dir, (params, opt_state))
        start_step = apply_resume_extra(extra, cfg, ckpt_step,
                                        anneal=args.bit_anneal)
        print(f"[train] resumed from step {start_step}", flush=True)

    # the driver has a data group of one until --data comes (A11): the
    # gate stays shut and nothing is measured
    prime_transports(args, cfg, params, n_data=1)
    # prime the kernel tune cache for this run's shapes after the restore:
    # the checkpoint's entries are cache hits (kept with their restored:
    # provenance and replayed, never re-derived)
    derived = tune_cache_stats()["misses"]
    tuned = prime_tune_cache(train_tune_shapes(cfg, args.global_batch,
                                               args.seq_len))
    derived = tune_cache_stats()["misses"] - derived
    print(f"[train] kernel tune cache primed: {derived}/{len(tuned)} "
          f"shape(s) derived, {len(tuned) - derived} already cached",
          flush=True)

    ckpt = (AsyncCheckpointer(args.ckpt_dir,
                              fault=plan.ckpt_fault if plan else None)
            if args.ckpt_dir else None)

    ds = SyntheticLMDataset(cfg.vocab_size, args.seq_len, args.global_batch)
    fetch = plan.wrap_fetch(ds.batch_at) if plan else ds.batch_at
    loader = StragglerTolerantLoader(fetch, deadline_s=args.deadline_s,
                                     start_step=start_step)

    step_fn = make_train_step(
        cfg, policy, ocfg,
        StepOptions(engine=args.engine, pipeline_schedule=pipe_sched,
                    pipeline_stages=n_stages,
                    num_microbatches=(args.microbatches if pipe_sched
                                      else None),
                    bit_anneal=args.bit_anneal),
        device=dev)
    print(f"[train] engine {args.engine}, kernel backend {step_fn.backend}",
          flush=True)

    def ckpt_extra(next_step):
        return capture_resume_extra(cfg, next_step, loader=loader,
                                    user_extra={"loss": losses[-1]},
                                    anneal=args.bit_anneal)

    def maybe_flip(next_step):
        # bit-flip drills corrupt a LANDED checkpoint: join the async write
        # first, then flip (the manifest keeps the original crc, so a later
        # restore must detect the mismatch and fall back)
        if plan is not None and next_step in plan.flip_steps():
            ckpt.wait()
            plan.corrupt_checkpoint(args.ckpt_dir, next_step)

    losses = []
    trace_path, prof = None, None
    if args.profile > 0:
        trace_path = (tempfile.mkdtemp(prefix="repro-trace-train-")
                      + "/trace.json")
    t0 = time.time()
    try:
        for step in range(start_step, args.steps):
            if trace_path and step == start_step:
                acts = [torch.profiler.ProfilerActivity.CPU]
                if dev.type == "cuda":
                    acts.append(torch.profiler.ProfilerActivity.CUDA)
                prof = torch.profiler.profile(activities=acts)
                prof.start()
            if plan is not None:
                plan.check_crash(step)
            # the lr in f32, as the JAX driver hands it to its step
            hyper = Hyper(lr=float(np.float32(sched(step))), step=step)
            rng = (prng.fold_in(prng.key(1), step) if args.stochastic
                   else None)
            skips = loader.skips
            batch = dict(loader.get(step))
            if loader.skips != skips:
                print(f"[train] step {step}: no batch within "
                      f"{args.deadline_s} s, the previous one stands in",
                      flush=True)
            batch.update(modality_inputs(cfg, batch["tokens"].shape[0],
                                         step, dev))
            params, opt_state, metrics = step_fn(params, opt_state, batch,
                                                 hyper, bits, rng)
            losses.append(float(metrics["loss"]))
            if prof is not None and step - start_step + 1 >= args.profile:
                prof.stop()
                prof.export_chrome_trace(trace_path)
                prof = None
            if step % args.log_every == 0 or step == args.steps - 1:
                dt = time.time() - t0
                print(f"step {step:5d} loss {losses[-1]:.4f} "
                      f"gnorm {float(metrics['grad_norm']):.3f} "
                      f"lr {sched(step):.2e} {dt:.3f}s "
                      f"data_skips={loader.skips}", flush=True)
            if ckpt and step and step % args.ckpt_every == 0:
                ckpt.save(step + 1, (params, opt_state),
                          extra=ckpt_extra(step + 1))
                maybe_flip(step + 1)
        if ckpt:
            ckpt.save(args.steps, (params, opt_state),
                      extra=ckpt_extra(args.steps))
            ckpt.wait()
            maybe_flip(args.steps)
    finally:
        # close() flushes the final in-flight write and surfaces any
        # background error even when the loop raises; only an injected
        # crash (os._exit) skips it, by design
        if prof is not None:
            prof.stop()
            prof.export_chrome_trace(trace_path)
        if ckpt:
            ckpt.close()
        loader.close()
    for t in ckpt.timings if ckpt else ():
        print(f"[train] checkpoint step {t['step']}: snapshot "
              f"{t['snapshot_s']:.3f} s, write {t['write_s']:.3f} s",
              flush=True)
    if trace_path:
        print(f"[train] profiler trace ({args.profile} step(s)): "
              f"{trace_path}", flush=True)
    print(f"[train] done: loss {losses[0]:.4f} -> {losses[-1]:.4f} "
          f"({np.mean(losses[:5]):.3f} -> {np.mean(losses[-5:]):.3f} "
          f"smoothed)", flush=True)
    return losses


if __name__ == "__main__":
    main()
