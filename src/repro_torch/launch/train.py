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

The JAX driver's mesh, pipeline, overlap, transport and dW-compression
flags wait for multi-GPU (ROADMAP A11), ``--bit-search`` and
``--bit-anneal`` for ``search/`` (A10), and ``--stochastic`` for the
engine's stochastic mode (A6b); argparse refuses them.
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
from repro_torch.ft import FaultPlan
from repro_torch.models import lm
from repro_torch.optim import Hyper, OptimizerConfig, cosine_schedule


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
    ap.add_argument("--engine", default="taxonn",
                    choices=["taxonn", "autodiff"])
    ap.add_argument("--kernel-backend", default="auto",
                    choices=["auto", "off", "emulate", "int8"],
                    help="dense-unit datapath (auto = int8 on CUDA, off on "
                         "the CPU)")
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
    args = _parser().parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = _reduce(cfg)
    print(f"[train] {cfg.name} ({cfg.family}) on {dev} "
          f"params~{cfg.param_count()/1e6:.1f}M", flush=True)

    ocfg = OptimizerConfig(kind=args.optimizer, grad_clip=1.0)
    policy = (QuantPolicy(grad_scale=64.0) if args.quantize
              else QuantPolicy.off())
    policy = dataclasses.replace(policy, kernel_backend=args.kernel_backend,
                                 quantize_updates=args.quantize_updates)
    bits = default_bits(cfg, enabled=args.quantize)
    sched = cosine_schedule(args.lr, warmup=max(10, args.steps // 20),
                            total=args.steps)

    params = lm.init_params(cfg, seed=0, device=dev)
    opt_state = init_train_state(params, ocfg)
    start_step = 0

    plan = FaultPlan.from_env(args.fault_plan)
    if plan is not None:
        print(f"[train] fault plan: {plan.describe()}", flush=True)

    if (args.resume and args.ckpt_dir
            and latest_step(args.ckpt_dir) is not None):
        (params, opt_state), ckpt_step, extra = restore_checkpoint(
            args.ckpt_dir, (params, opt_state))
        start_step = apply_resume_extra(extra, cfg, ckpt_step)
        print(f"[train] resumed from step {start_step}", flush=True)

    ckpt = (AsyncCheckpointer(args.ckpt_dir,
                              fault=plan.ckpt_fault if plan else None)
            if args.ckpt_dir else None)

    ds = SyntheticLMDataset(cfg.vocab_size, args.seq_len, args.global_batch)
    fetch = plan.wrap_fetch(ds.batch_at) if plan else ds.batch_at
    loader = StragglerTolerantLoader(fetch, deadline_s=args.deadline_s,
                                     start_step=start_step)

    step_fn = make_train_step(cfg, policy, ocfg,
                              StepOptions(engine=args.engine), device=dev)
    print(f"[train] engine {args.engine}, kernel backend {step_fn.backend}",
          flush=True)

    def ckpt_extra(next_step):
        return capture_resume_extra(cfg, next_step, loader=loader,
                                    user_extra={"loss": losses[-1]})

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
            params, opt_state, metrics = step_fn(params, opt_state,
                                                 loader.get(step), hyper,
                                                 bits)
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
