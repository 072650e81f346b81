"""Serving entry point: continuous-batching decode over the slot scheduler,
paged or contiguous.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \
        --slots 8 --requests 16 --prompt-len 64 --prompt-len-max 192 \
        --shared-prefix 64 --max-new 32 --max-len 512 --block-size 16
    PYTHONPATH=src python -m repro_torch.launch.serve --mode contiguous \
        --slots 8 --requests 8 --prompt-len 128 --max-new 32 --max-len 160
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b \
        --slots 8 --requests 8 --prompt-len 128 --max-new 32 --max-len 160
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mixtral-8x7b \
        --device cpu --reduced --requests 4 --prompt-len 12 --max-new 8
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch deepseek-v2-lite-16b --device cpu --reduced --requests 4 \
        --prompt-len 12 --max-new 8 --profile 3

Port of ``repro/launch/serve.py``.  ``--mode auto`` is paged where
``paged_supported`` holds (the dense, moe and vlm families with GQA
attention and no sliding window) and contiguous otherwise (ssm and hybrid,
whose state is no KV pool, a sliding window's ring, as in mixtral-8x7b and
h2o-danube-3-4b, and MLA's latent cache, as in deepseek-v2-lite-16b;
``--mode paged`` raises for them, as in JAX).  A vlm (llava) serves its
text only, paged, as JAX's paged prefill takes tokens only.  The
scheduler's prefill hook hands the engine only the prompt's tokens, as
JAX's does, so an encoder-decoder (whisper), whose prefill needs its
encoder frames, and a vlm in contiguous mode, whose prefill needs its
patch embeddings, are refused before a weight is drawn (JAX's CLI fails
on the missing input); whisper serves through the engine's own
``prefill``/``decode_step``/``greedy_generate`` with its frames.
Contiguous mode keeps
the JAX scheduler's one decode position for the whole batch, so this CLI
runs it only on equal-length prompts with no ``--eos-id`` (requests
admitted together finish together).  It runs on
the card unless ``--device cpu`` is given, and raises when CUDA is absent.
Its defaults differ from the JAX package's serve CLI on purpose: the
kernel backend defaults to ``auto`` (int8 on CUDA, off on the CPU) and
``--attn-impl`` to ``kernel``, because on the card the kernels are the
serving path (the JAX CLI kept them opt-in, as on the CPU they only ran in
interpret mode).  Weights are random f32 masters from a seeded generator;
prompts are random tokens, of lengths drawn in [--prompt-len,
--prompt-len-max], and every other request starts with one common
--shared-prefix tokens so that prefix sharing and copy-on-write run.
``--profile N`` runs the first N scheduler ticks under ``torch.profiler``
and writes their Chrome trace (``trace.json``) into a new directory under
the temporary directory, which the CLI prints.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.launch.train import _reduce
from repro_torch.models import lm
from repro_torch.models.blocks import require_ported
from repro_torch.serving import (BatchScheduler, EngineHooks, Request,
                                 ServeConfig, paged_supported)


def make_prompts(rng: np.random.Generator, n: int, vocab: int, lo: int,
                 hi: int, shared_prefix: int) -> list:
    """n random prompts with lengths in [lo, hi]; every other one starts
    with the same ``shared_prefix`` tokens."""
    prefix = rng.integers(0, vocab, size=(shared_prefix,)).astype(np.int32)
    prompts = []
    for i in range(n):
        p = rng.integers(0, vocab, size=(int(rng.integers(lo, hi + 1)),))
        p = p.astype(np.int32)
        if shared_prefix and i % 2 == 0:
            p[:shared_prefix] = prefix[:len(p)]
        prompts.append(p)
    return prompts


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_NAMES, default="qwen1.5-0.5b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "PyTorch versions of the kernels)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights and prompts")
    ap.add_argument("--mode", default="auto",
                    choices=["auto", "paged", "contiguous"],
                    help="auto: paged where the family supports it, "
                         "contiguous otherwise")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--prompt-len-max", type=int, default=None,
                    help="longest prompt (default: --prompt-len)")
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="tokens every other prompt shares at its start")
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--block-size", type=int, default=8)
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="prefill token budget per tick (default: block size)")
    ap.add_argument("--cache-dtype", default=None,
                    choices=["bfloat16", "float32", "int8"],
                    help="KV storage dtype (default: the compute dtype)")
    ap.add_argument("--eos-id", type=int, default=None,
                    help="stop at this token id (default: run to max-new)")
    ap.add_argument("--kernel-backend", default="auto",
                    choices=["auto", "off", "emulate", "int8"],
                    help="decode-hook kernel backend (auto: int8 on CUDA, "
                         "off on the CPU)")
    ap.add_argument("--attn-impl", default="kernel", choices=["ref", "kernel"],
                    help="paged decode attention: the paged_attention kernel "
                         "or the plain gather path")
    ap.add_argument("--profile", type=int, default=0, metavar="N",
                    help="capture a torch.profiler Chrome trace of the first "
                         "N scheduler ticks (trace directory printed at "
                         "exit)")
    return ap


def profile_ticks(sched, n: int, device) -> str:
    """Run up to ``n`` ticks of ``sched`` under ``torch.profiler`` (CPU
    activity, and CUDA on the card) and write their Chrome trace to
    ``trace.json`` in a new directory under the temporary directory;
    returns the directory."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    trace_dir = tempfile.mkdtemp(prefix="repro-torch-trace-serve-")
    with profile(activities=acts) as prof:
        for _ in range(n):
            if sched.step() == 0 and not sched.pending:
                break
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
    return trace_dir


def main(argv=None) -> dict:
    """Serve random prompts to completion.  Returns a report: the finished
    requests, the scheduler's stats, tokens, decode steps and times, and
    the model served (``cfg`` and its ``params``)."""
    ap = _parser()
    args = ap.parse_args(argv)
    hi = args.prompt_len_max or args.prompt_len
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = _reduce(cfg)
    require_ported(cfg)
    mode = args.mode
    if mode == "auto":
        mode = "paged" if paged_supported(cfg) else "contiguous"
    if cfg.family == "encdec" or (cfg.family == "vlm"
                                  and mode == "contiguous"):
        need = "frames" if cfg.family == "encdec" else "patch_embeds"
        ap.error(f"{cfg.name} ({cfg.family}): the scheduler's prefill hook "
                 f"passes only the prompt's tokens, and this prefill needs "
                 f"its {need}; serve it through serving.engine's prefill/"
                 f"decode_step/greedy_generate with the {need}")
    if mode == "contiguous" and (hi != args.prompt_len
                                 or args.eos_id is not None):
        ap.error("contiguous mode decodes the whole batch at one position: "
                 "give equal-length prompts (no --prompt-len-max) and no "
                 "--eos-id")
    device = resolve_device(args.device)
    params = lm.init_params(cfg, seed=args.seed, device=device)

    cache_dtype = args.cache_dtype or (
        "bfloat16" if cfg.compute_dtype == "bfloat16" else "float32")
    serve = ServeConfig(num_slots=args.slots, eos_id=args.eos_id,
                        max_len=args.max_len, mode=mode,
                        block_size=args.block_size,
                        prefill_chunk=args.prefill_chunk,
                        cache_dtype=cache_dtype,
                        attn_impl=args.attn_impl,
                        kernel_backend=args.kernel_backend)
    print(f"[serve] {cfg.name} ({cfg.family}) on {device} slots={args.slots} "
          f"mode={mode} cache={cache_dtype} "
          f"kernel_backend={args.kernel_backend} "
          f"attn_impl={args.attn_impl}", flush=True)

    hooks = EngineHooks.for_model(params, cfg, serve)

    if mode == "paged":
        # prime the kernel tune cache for this serve's decode shapes (paged
        # attention, the fused prologue and the decode rows' MLP products)
        # so that the first decode tick finds its launches decided; after
        # the hooks, which refuse a family that paged mode cannot serve
        from repro_torch.kernels.ops import (prime_tune_cache,
                                             serve_tune_shapes,
                                             tune_cache_stats)
        derived = tune_cache_stats()["misses"]
        tuned = prime_tune_cache(serve_tune_shapes(
            cfg, num_blocks=serve.resolved_num_blocks,
            block_size=serve.block_size,
            max_blocks_per_seq=serve.max_blocks_per_seq,
            cache_itemsize=torch.empty(
                (), dtype=serve.torch_cache_dtype()).element_size(),
            num_slots=serve.num_slots))
        derived = tune_cache_stats()["misses"] - derived
        print(f"[serve] kernel tune cache primed: {derived}/{len(tuned)} "
              f"shape(s) derived, {len(tuned) - derived} already cached",
              flush=True)

    decode_s = [0.0]
    inner = hooks.decode

    def timed_decode(*a):
        t = time.perf_counter()
        out = inner(*a)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        decode_s[0] += time.perf_counter() - t
        return out
    hooks.decode = timed_decode
    sched = BatchScheduler(serve, hooks)

    rng = np.random.default_rng(args.seed)
    prompts = make_prompts(rng, args.requests, cfg.vocab_size,
                           args.prompt_len, hi, args.shared_prefix)
    reqs = [Request(uid=i, prompt=p, max_new_tokens=args.max_new)
            for i, p in enumerate(prompts)]
    t0 = time.perf_counter()
    for r in reqs:
        sched.submit(r)
    trace_dir = (profile_ticks(sched, args.profile, device)
                 if args.profile > 0 else None)
    sched.run_until_drained()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    finished = [r for r in reqs if r.done]
    tok = sum(len(r.generated) for r in finished)
    steps = sched.steps_run
    extra = ""
    if mode == "paged":
        extra = (f", {sched.stats['prefix_hits']} prefix hits, "
                 f"{sched.stats['cow_copies']} COW copies")
    print(f"[serve] {len(finished)}/{args.requests} requests, {tok} tokens "
          f"in {dt:.2f}s ({tok / dt:.1f} tok/s), {steps} decode steps "
          f"({1e3 * decode_s[0] / max(steps, 1):.2f} ms/step){extra}",
          flush=True)
    for r in finished[:3]:
        print(f"  req {r.uid}: {r.generated[:8]}...", flush=True)
    if trace_dir:
        print(f"[serve] profiler trace ({args.profile} tick(s)): "
              f"{trace_dir}", flush=True)
    return {"finished": finished, "requests": args.requests,
            "stats": dict(sched.stats), "tokens": tok, "seconds": dt,
            "decode_steps": steps, "decode_seconds": decode_s[0],
            "device": str(device), "mode": mode, "cfg": cfg,
            "params": params, "trace_dir": trace_dir}


if __name__ == "__main__":
    main()
