#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py            # every phase; needs one CUDA card

Phases (any failure exits non-zero before the result line is printed):

1. device   -- the card's name and power limit (nvidia-smi), torch and CUDA
               versions.
2. build    -- nvcc builds every kernel of ``src/repro_torch/csrc`` (one
               process per source, all at once) into ``build/kernels``.
3. kernels  -- each kernel against its plain PyTorch version on the card, at
               the full-width decode shapes of qwen1.5-0.5b (8 slots; for
               fxp_matmul also the prefill chunk of 16 rows, and
               zamba2-2.7b's shared-block products at 8 slots and a
               128-token prefill, ``ZAMBA2_FXP``) and the
               full-width LeNet-5 training shapes (batch 128, and 1024 so
               that a launch moves more than a few hundred KB), for both
               datapaths, with the tolerance stated beside each check;
               paged_attention and decode_prologue also at yi-34b's
               attention widths (D 7168, 56 heads, 8 KV heads of 128, 8
               slots; attention over up to 4096 positions),
               decode_prologue also at zamba2-2.7b's (D 2560, 32 heads of
               80, no bias) and mixtral-8x7b's (D 4096, 32 heads and 8 KV
               heads of 128, no bias), and
               sgd_dw_update also in the dW-only form at the qwen1.5-0.5b
               MLP shape (T 2048, 1024 x 2816); bp_gstep also at the dense
               engine's dx shapes there (mlp_up: G [2048, 2816] against W
               [1024, 2816]; mlp_down: G [2048, 1024] against W
               [2816, 1024], z=None and with a silu gate's f'(Z));
               bp_fused_unit also on a 2816-wide hidden frame (T 128).
               fxp_matmul, bp_gstep and sgd_dw_update also as the layer
               engine calls them in train_lm (``check_engine_units``): T
               1024 tokens through each of qwen1.5-0.5b's unit shapes
               (q/k/v/o 1024 x 1024, gate/up 1024 x 2816, down 2816 x
               1024), bf16 activations against f32 weights, identity,
               and through zamba2-2.7b's shared-block units in train_ssm
               (``ZAMBA2_ENGINE_UNITS``: q/k/v/o 2560 x 2560, gate/up
               2560 x 10240, down 10240 x 2560) and mixtral-8x7b's
               attention units in the moe phase
               (``MIXTRAL_ENGINE_UNITS``: q/o 4096 x 4096, k/v 4096 x
               1024).
               Beside each bp_fused_unit row the port's unfused pair
               (bp_gstep + sgd_dw_update), and beside each decode_prologue
               row the engine's unfused branch (rmsnorm, three fxp_matmul
               launches, bias, rope), run on the same inputs
               (``unfused_ms``).  The timer's floor, a
               one-element fill, is printed first.
               Times are CUDA-event medians of 25 launches after warm-up,
               each launch after a write of 128 MB that evicts the 50 MB L2
               (the paths read every weight cold) and a ~0.5 ms spin of the
               card that hides the host's enqueue time.  ``library_ms``
               times one PyTorch call that computes the same function, as a
               yardstick; the port never calls it.
3b. edges   -- untimed: fxp_matmul, bp_gstep, sgd_dw_update,
               bp_fused_unit, decode_prologue (int8 bitwise equal to its
               plain version) and paged_attention at ragged
               and unaligned shapes, fxp_matmul and decode_prologue at
               every split count, bp_gstep on both of its paths, at every
               row count of the short one and every split count of the
               tiled one, and bp_fused_unit at every cluster size its plan
               could pick (``check_edges``), int8 bitwise across them.
4. serve    -- the port's serving entry point (``launch.serve.main``) on
               full-width qwen1.5-0.5b with random f32 masters from a seed:
               8 slots, 16 requests of 64-192 prompt tokens (every other one
               shares a 64-token prefix, so prefix sharing and copy-on-write
               run), 32 new tokens each, max_len 512, block 16, once with the
               int8 backend and int8 KV cache and once with the emulate
               backend and bf16 KV cache.  The launch counts are set to 0
               just before each run and read just after.  Then one decode
               step after a prefill runs on the card (kernels) and on the
               CPU (plain versions) from the same pool, the logits are
               compared, and torch.profiler splits a few more decode steps
               into device time by kernel, wall time and idle share.
               Then contiguous mode (``--mode contiguous``): 8 slots, 8
               prompts of 128 tokens admitted together, 32 new tokens,
               bf16 KV, the int8 backend; launches exactly 168 fxp_matmul a
               prefill and 24 decode_prologue + 72 fxp_matmul (no
               paged_attention) a decode step; one decode step card against
               CPU; a profile of 5 decode steps; and in both modes a
               snapshot after 8 decode steps, through the checkpoint layer,
               restored into a fresh scheduler, whose streams must equal
               the uninterrupted run's.
4b. serve_ssm -- contiguous serving of the ssm and hybrid families
               through ``launch.serve.main`` at full width, random f32
               masters from seed 0: zamba2-2.7b (54 layers: 9 groups of
               one application of the weight-tied shared block and 6
               Mamba2 layers, d 2560) and mamba2-370m (48 Mamba2 layers),
               each with 8 slots, 8 prompts of 128 tokens, 32 new tokens,
               bf16 caches, the int8 backend; every request finishes with
               32 tokens and the launches are exactly 63 fxp_matmul a
               prefill and 27 fxp_matmul + 9 decode_prologue a decode step
               (zamba2) and none at all (mamba2: its products are plain
               PyTorch, as JAX computes them outside any kernel).  Then,
               from the engine's entry points: each prefill's launches and
               ms, a decode step's launches, a profile of 5 decode steps,
               and a snapshot after 8 decode steps restored to equal
               streams.  Last, zamba2 cut to one group at full width does
               a prefill of 8 x 40 tokens and a decode step on the card
               and on the CPU from the same weights and tokens, under int8
               and emulate: the logits within SSM_PARITY_TOL, and the
               same card run with a dropped K split or K tile of the down
               projection beyond it.
5. train    -- the port's LeNet-5 train step (``core.lenet``), the paper's
               Fig. 3 network at full width (784-256-256-256-256-10), f32
               masters from seed 0, Table-I MNIST (I,F) points, on the
               synthetic classification set (8192 train / 2048 test, noise
               3.5): 150 SGD steps of batch 128 at lr 0.05, once with the
               int8 backend and once with emulate.  Launch counts are set to
               0 just before each run and read just after; each run must
               descend (last-20 mean loss below half the first-20 mean).
               Then one step from the same params and batch runs on the card
               and on the CPU (plain versions) and the new parameters and
               loss are compared, and torch.profiler splits a few steps into
               device time by kernel, wall time and idle share; and one
               such step of a net with 2048-wide hidden layers (frames the
               first port of bp_fused_unit refused).
5a. noise  -- util/prng.py (JAX's threefry2x32 in int64 PyTorch ops) on the
               card against the CPU, bit for bit: keys and fold chains of
               seeds 0, 1 and 2^32-1, bits and uniforms, the per-row form at
               offsets 0 and 3, and one full [8, 128, 1024] G draw; the
               device time of that draw and of the stochastic rounding.
5b. train_lm -- the layer engine (``core.steps.make_train_step``) on
               full-width, 24-layer qwen1.5-0.5b (f32 masters from seed 0,
               bf16 compute): 6 momentum steps of batch 8 x seq 128 at lr
               3e-3 on one synthetic batch, once a backend (int8, emulate);
               every loss finite, the last-3 mean below the first-3 mean,
               and exactly 336 fxp_matmul, 168 bp_gstep and 168
               sgd_dw_update launches a step; then timed ms/step, tokens/s
               and a profile of 3 steps, and one step of a 2-layer
               full-width net on the card against the CPU.  Then the int8
               step with stochastic rounding under the JAX driver's keys:
               3 steps at exactly those launches, every loss finite, a
               second run from the same params and keys bitwise equal, a
               profile of 3 steps with the noise ops as their own group
               ("prng") beside the round-to-nearest profile, and the
               2-layer step card against CPU.
5e. train_ssm -- the layer engine on the ssm and hybrid families: train_lm's
               step (momentum, grad_scale 64, default bits, lr 3e-3, one
               synthetic batch of 8 x 128) on full-width zamba2-2.7b (f32
               masters from seed 0, bf16 compute; 9 groups of the shared
               block and 6 Mamba2 layers), 6 steps a backend (int8,
               emulate), and on full-width mamba2-370m, 6 steps: every
               loss finite, the last-2 mean below the first-2 mean, and
               exactly 126 fxp_matmul, 63 bp_gstep and 63 sgd_dw_update
               launches a zamba2 step (HYBRID_TRAIN_LAUNCHES), none a
               mamba2 step; timed ms/step, tokens/s, peak memory and a
               profile of 3 steps each.  Then zamba2's int8 step with
               stochastic rounding, 2 steps twice from the same params and
               keys, bitwise equal; the train driver in-process on zamba2
               (--quantize --stochastic, int8, 3 steps, no checkpoint); and
               one step of zamba2 cut to one group (both backends) and of
               mamba2 cut to 2 layers, at full width, batch 2 x 64, on the
               card and on the CPU: the update's relative L2 within
               SSM_TRAIN_PARITY_TOL as a whole, SSM_TRAIN_LEAF_TOL leaf by
               leaf and SSM_TRAIN_VECTOR_TOL for A_log and dt_bias, and
               the hybrid's card step again under serve_ssm's dropped-K
               faults beyond them.
5f. moe    -- the moe family and sliding-window decode on mixtral-8x7b
               at full width (d 4096, 8 experts of 14336, top-2, 32 heads
               and 8 KV heads of 128, vocab 32000, a window of 4096), f32
               masters from seed 0, bf16 compute, cut in depth only (each
               cut printed as reduced): (1) 4 layers served by the
               scheduler in contiguous mode through the engine's hooks, 8
               slots, 8 prompts of 128 tokens, 32 new, bf16 KV, the int8
               backend: every request finishes, exactly 16 fxp_matmul a
               prefill and 4 decode_prologue a decode step (the router and
               experts are plain products, as in JAX), prefill ms,
               ms/decode step, tokens/s and a profile of 5 decode steps;
               (2) one layer with the window cut to 64, 2 rows of 72
               prompt tokens and 4 decode steps (the ring wraps) on the
               card and on the CPU under int8 and emulate: the logits
               within MOE_PARITY_TOL, the share of routing picks that
               differ printed, a dropped K split of q/k/v/o and
               un-renormalised routing weights beyond the limit; (3) 2
               layers trained by train_lm's step (momentum, lr 3e-3, 8 x
               128), 6 steps a backend: every loss finite, the last-2 mean
               below the first-2 mean, exactly 16 / 8 / 8 launches a step,
               ms/step, tokens/s, the aux, peak memory, a profile of 3
               steps; the int8 stochastic step 2 steps twice, bitwise;
               (4) one layer, one step, 2 x 32, card against CPU: the
               update's relative L2 whole, leaf by leaf and the router's
               within MOE_TRAIN_PARITY_TOL, MOE_TRAIN_LEAF_TOL and
               MOE_ROUTER_TOL, the dropped-K control beyond them.
5g. mla    -- MLA (DeepSeek-V2's latent attention, the absorbed decode)
               and the top-6 moe with shared experts on
               deepseek-v2-lite-16b at full width (d 2048, 16 heads,
               latent rank 512, nope/rope/v 128/64/128, 64 experts of
               1408, top-6, 2 shared, vocab 102400), f32 masters from a
               seed, bf16 compute, the int8 backend; no kernel lies on
               this path, so every launch count must read 0.  (1) The
               earlier phases' memory freed and the card's free memory
               printed (27 layers' masters and 6 GB must fit), 27 layers
               (16.0 B masters) served by the scheduler in contiguous
               mode, 8 slots, 8 prompts of 128 tokens, 32 new, bf16
               latent cache: every request finishes, prefill ms,
               ms/decode step, tokens/s, peak memory, a profile of 5
               decode steps and a snapshot restored to equal streams;
               (2) one layer, 2 rows of 32 prompt tokens and 4 decode
               steps on the card and on the CPU: the logits within
               MLA_PARITY_TOL, the routing picks that differ printed, the
               CPU's run with the router nudged by one bf16 ulp within
               it, a dropped latent (the last quarter of the cache's rank
               zeroed) and an un-absorbed query (no w_uk) beyond it; the
               absorbed decode's logits against the materialised prefill
               of the same tokens in f32 within MLA_ABSORB_TOL (the
               un-absorbed control beyond it; bf16 printed); (3) 4 layers
               trained by train_lm's step, 6 steps: every loss finite,
               the last-2 mean below the first-2 mean, ms/step, tokens/s,
               the aux, peak memory, a profile of 3 steps; the stochastic
               step 2 steps twice, bitwise; (4) one layer, one step, 2 x
               32, card against CPU: the routing picks that differ
               printed, the update whole, leaf by leaf and the router's
               within MLA_TRAIN_PARITY_TOL, MLA_TRAIN_LEAF_TOL and
               MLA_ROUTER_TOL, and with the CPU's picks replayed on the
               card within MLA_REPLAYED_TOL; the dropped-latent control
               beyond them.
5c. search -- the bitwidth search (``search/``), in three parts:
               (1) the LeNet-5 sweep at the JAX defaults (784-256x4-10, 3
               groups, the 6-point grid, 120 probe steps of batch 128 at
               lr 0.05, seed 0; plain PyTorch, no kernel launch) on the
               card and on the CPU from the same weights: every probe loss
               finite, the same plan, the gated losses within
               SEARCH_LENET_LOSS_TOL (a differing decision nearer the
               threshold than that is printed, not failed); (2) the
               driver's --bit-search at full width (24 layers, int8, 2
               groups, 3 steps a probe, then 2 training steps): the sweep's
               log and plan, both JSON files load back, the parity line
               OK, every probe loss finite, and exactly (probes x 3 + 2) x
               train_lm's launches a step plus one decode_prologue; (3)
               ``verify_train_serve_parity`` on the card for (2)'s plan and
               the JAX suite's EXPORT_PLAN: ok, every diff 0, one
               decode_prologue launch each.  Probes, seconds and ms a
               probe step printed.
5d. train_driver -- the port's train driver (``launch.train.main``) on
               the same full-width qwen1.5-0.5b with --quantize,
               --stochastic and --bit-anneal 0:16,3:14,6:12, int8 on the
               card, momentum, seq 128, batch 8, 8 steps, a checkpoint
               every 4 (3.71 GB each: f32 params and momentum).  Run A
               in-process: launches exactly 8 x train_lm's a step, every
               loss finite, checkpoints 5 and 8 verify; ms/step, tokens/s,
               the checkpoint's bytes, snapshot, write and restore seconds.
               The flip drill: one bit of A's checkpoint 8 flipped, the
               restore onto the card warns and recovers step 5, bitwise
               A's by crc32.  Run B, a subprocess, is killed at step 6
               (exit 41) after its step-5 checkpoint landed; run B' resumes
               it from step 5 and
               must end with every crc32 of its checkpoint 8 equal to A's
               and the same logged losses.
6. summary  -- one line of each phase's seconds, one ``{"kernels":
               [...]}`` line, the card's line, and last ``{"ok": true,
               "device": {...}}``.

``--phases`` picks a subset of device, build, kernels, edges, serve,
serve_ssm, train, noise, train_lm, train_ssm, moe, mla, search and
train_driver
(for
example ``--phases
device,build,kernels,edges`` or ``--phases device,train``);
the result line is printed only when every phase ran.  The script imports
nothing of JAX nor of the JAX package ``repro``.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import pathlib
import re
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"
PHASES = ("device", "build", "kernels", "edges", "serve", "serve_ssm",
          "train", "noise", "train_lm", "train_ssm", "moe", "mla", "search",
          "train_driver")

HBM_BYTES_PER_S = 3.35e12                     # H100 SXM HBM3
PEAK_OPS = {"float32": 67e12, "bfloat16": 989e12, "int8": 1979e12}
FLUSH_BYTES = 128 << 20                       # > the 50 MB L2
REPS, WARM = 25, 3
SLEEP_CYCLES = 1_000_000                      # ~0.5 ms at the H100's clocks

# qwen1.5-0.5b decode widths (configs/qwen1_5_0_5b.py), 8 slots
B, D, H, HKV, HD, FF = 8, 1024, 16, 16, 64, 2816
BS, M = 16, 32                                # block size, blocks per slot

# LeNet-5 training widths (configs/lenet5.py), batch 128 and 1024
LENET_IN, LENET_H, LENET_C = 784, 256, 10
TRAIN_T = (128, 1024)
LR = 0.05

SOURCES = {
    "fxp_matmul": ("src/repro_torch/csrc/fxp_matmul.cu",
                   "src/repro/kernels/fxp_matmul.py:138"),
    "bp_gstep": ("src/repro_torch/csrc/bp_gstep.cu",
                 "src/repro/kernels/bp_gstep.py:137"),
    "sgd_dw_update": ("src/repro_torch/csrc/sgd_dw_update.cu",
                      "src/repro/kernels/sgd_dw_update.py:79"),
    "bp_fused_unit": ("src/repro_torch/csrc/bp_fused_unit.cu",
                      "src/repro/kernels/bp_fused_unit.py:199"),
    "decode_prologue": ("src/repro_torch/csrc/decode_prologue.cu",
                        "src/repro/kernels/decode_prologue.py:188"),
    "paged_attention": ("src/repro_torch/csrc/paged_attention.cu",
                        "src/repro/kernels/paged_attention.py:126"),
}


class SmokeFailure(RuntimeError):
    pass


def say(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


# ---------------------------------------------------------------------------
# helpers: timing, bounds, comparisons
# ---------------------------------------------------------------------------

def time_ms(fn, torch, flush) -> float:
    """Median CUDA-event time of ``fn`` over REPS launches, each after a
    write of ``flush`` that evicts L2.  Between the flush and the start
    event the card spins for ~0.5 ms (``torch.cuda._sleep``), so the host
    has enqueued all of ``fn``'s work before the start event runs: the time
    is the device's, not the host's (a PyTorch call takes ~0.03 ms of host
    time on the card's machine, longer than most of these kernels)."""
    for _ in range(WARM):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        flush.zero_()
        torch.cuda._sleep(SLEEP_CYCLES)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound(nbytes: float, ops: float, kind: str):
    """The least time the card could take: bytes over HBM bandwidth or
    operations over the peak rate of their type, whichever is larger."""
    tb, to = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS[kind]
    return max(tb, to) * 1e3, ("bytes" if tb >= to else "operations")


def compare(got, ref, *, atol: float, rtol: float, grid: float = 0.0,
            grid_frac: float = 0.0):
    """max |got - ref| and whether every element is within atol + rtol|ref|,
    allowing a difference of one output grid step more on at most
    ``grid_frac`` of the elements."""
    g, r = got.double(), ref.double()
    require(bool(g.isfinite().all()), "kernel output is not finite")
    err = (g - r).abs()
    lim = atol + rtol * r.abs()
    over = err > lim
    ok = not bool(over.any())
    if not ok and grid:
        ok = (bool((err <= lim + grid).all())
              and float(over.double().mean()) <= grid_frac)
    return float(err.max()), ok


# ---------------------------------------------------------------------------
# phase 3: each kernel against its plain version
# ---------------------------------------------------------------------------

def check_fxp_matmul(torch, dev, flush, gen):
    from repro_torch.kernels.fxp_matmul import fxp_matmul, fxp_matmul_plain
    from repro_torch.quant.int8 import quantize_int8_absmax

    rows = []
    # decode (8 slots), the unaligned row, and prefill (chunks of 16 rows)
    shapes = [(B, D, FF), (B, FF, D), (5, 1000, 333), (BS, D, FF),
              (BS, FF, D)]
    # datapath, x dtype, W dtype, (xa_bits, w_bits, out_bits), act
    variants = [
        ("emulate", torch.float32, torch.float32, (None, None, None),
         "identity"),
        ("emulate", torch.bfloat16, torch.float32, (None, None, None),
         "identity"),
        ("emulate", torch.bfloat16, torch.bfloat16, (None, None, None),
         "identity"),
        ("emulate", torch.float32, torch.float32,
         ((4, 10), (2, 12), (4, 10)), "silu"),
        ("int8", torch.int8, torch.int8, (None, None, None), "identity"),
        ("int8", torch.int8, torch.int8, (None, None, (4, 10)), "silu"),
    ]
    # zamba2-2.7b's shared block (ZAMBA2_FXP): the int8 rows serve_ssm runs
    # and the emulate row of its parity check (bf16 X, f32 W)
    zamba = [v for v in variants if v[0] == "int8"
             or v[1:3] == (torch.bfloat16, torch.float32)]
    for (m, k, n), vs in ([(s, variants) for s in shapes]
                          + [(s, zamba) for s in ZAMBA2_FXP]):
        x = torch.randn((m, k), generator=gen, device=dev)
        w = torch.randn((k, n), generator=gen, device=dev) * k ** -0.5
        qx, sx = quantize_int8_absmax(x)
        qw, sw = quantize_int8_absmax(w)
        for datapath, xdt, wdt, (xa, wb, ob), act in vs:
            if (m, k, n) == (5, 1000, 333) and ob is not None:
                continue
            if m == BS and (xdt == torch.bfloat16 or act != "identity"):
                continue             # prefill: f32 and int8 only
            kw = dict(xa_bits=xa, w_bits=wb, out_bits=ob, act=act,
                      datapath=datapath)
            if datapath == "int8":
                a, bw = qx, qw
                kw["scale"] = sx * sw
                kind, nbytes = "int8", m * k + k * n + 4 * m * n
            else:
                a, bw = x.to(xdt), w.to(wdt)
                kind = "bfloat16" if xdt == torch.bfloat16 else "float32"
                nbytes = (a.element_size() * m * k + bw.element_size() * k * n
                          + 4 * m * n)
            got = fxp_matmul(a, bw, **kw)
            ref = fxp_matmul_plain(a, bw, **kw)
            torch.cuda.synchronize()
            scale_ref = float(ref.abs().max())
            if datapath == "int8" and act == "identity" and ob is None:
                # identical int32 sums and one identical f32 rescale
                tol = "bitwise"
                err = float((got - ref).abs().max())
                ok = bool(torch.equal(got, ref))
            else:
                # f32 sums of k products taken in another order, and the
                # activation's exp in another library: 1e-4 of the output
                # scale; after an (I,F) output rounding a value at a grid tie
                # may land one step 2^-F away, on at most 1% of the outputs
                grid = 2.0 ** -ob[1] if ob else 0.0
                tol = "|d| <= 1e-4*max|ref| + 1e-4*|ref|" + (
                    " (+1 grid step on <= 1%)" if grid else "")
                err, ok = compare(got, ref, atol=1e-4 * scale_ref, rtol=1e-4,
                                  grid=grid, grid_frac=0.01)
            require(ok, f"fxp_matmul {datapath} {xdt} bits={xa, wb, ob} "
                        f"act={act} {m}x{k}x{n}: max err {err} beyond {tol}")
            ms = time_ms(lambda: fxp_matmul(a, bw, **kw), torch, flush)
            plain_ms = time_ms(lambda: fxp_matmul_plain(a, bw, **kw), torch,
                               flush)
            library_ms, library_note = None, "no single PyTorch call"
            if xa or ob or act != "identity":
                pass                    # (I,F) rounding or an activation
            elif datapath == "int8":
                try:
                    torch._int_mm(a, bw)
                    library_ms = time_ms(lambda: torch._int_mm(a, bw), torch,
                                         flush)
                    library_note = "torch._int_mm"
                except RuntimeError as e:
                    library_note = f"torch._int_mm refused: {str(e)[:120]}"
            elif xdt == torch.float32:
                library_ms = time_ms(lambda: torch.matmul(a, bw), torch,
                                     flush)
                library_note = "torch.matmul f32 (TF32 off)"
            elif wdt == torch.bfloat16:
                library_ms = time_ms(lambda: torch.matmul(a, bw), torch,
                                     flush)
                library_note = "torch.matmul bf16"
            else:
                # the kernel reads f32 W (4 bytes a weight), this call bf16
                wb16 = bw.to(torch.bfloat16)
                library_ms = time_ms(lambda: torch.matmul(a, wb16), torch,
                                     flush)
                library_note = "torch.matmul bf16 (weights pre-cast)"
            bms, by = bound(nbytes, 2.0 * m * k * n, kind)
            wname = "/w=bfloat16" if wdt == torch.bfloat16 else ""
            rows.append(dict(
                name="fxp_matmul",
                variant=f"{datapath}/{str(xdt).split('.')[-1]}{wname}"
                        f"/bits={'on' if xa or ob else 'off'}/{act}",
                shape=f"{m}x{k}x{n}", max_abs_err=err, tol=tol, ms=ms,
                plain_ms=plain_ms, library_ms=library_ms,
                library=library_note, bound_ms=bms, bound_by=by))
            say(f"fxp_matmul {rows[-1]['variant']} {m}x{k}x{n}: err {err:.3g}"
                f" ({tol}) {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
                f"{library_ms if library_ms is None else round(library_ms, 4)}"
                f" ms, bound {bms:.4f} ms ({by})")
    return rows


# the prologue's phase-3 shapes: qwen1.5-0.5b's attention front (8 slots,
# bias; eps 1e-6 as the first rows of this check had it), yi-34b's
# (configs/yi_34b.py: 56 heads, 8 KV heads of 128, rope theta 5e6, no
# bias) at 8 slots, and zamba2-2.7b's shared block (configs/zamba2_2_7b.py:
# d 2560, 32 heads of 80, no bias, theta 1e4) at serve_ssm's 8 slots
PROLOGUE_SHAPES = (
    dict(b=B, d=D, h=H, hkv=HKV, hd=HD, bias=True, theta=1e6, eps=1e-6,
         variants=(("float32", "emulate"), ("float32", "int8"),
                   ("bfloat16", "emulate"), ("bfloat16", "int8"))),
    dict(b=8, d=7168, h=56, hkv=8, hd=128, bias=False, theta=5e6, eps=1e-5,
         variants=(("bfloat16", "int8"), ("bfloat16", "emulate"))),
    dict(b=8, d=2560, h=32, hkv=32, hd=80, bias=False, theta=1e4, eps=1e-5,
         variants=(("bfloat16", "int8"), ("bfloat16", "emulate"))),
    dict(b=8, d=4096, h=32, hkv=8, hd=128, bias=False, theta=1e6, eps=1e-5,
         variants=(("bfloat16", "int8"), ("bfloat16", "emulate"))),
)


def _prologue_inputs(torch, dev, gen, *, b, d, h, hkv, hd, bias, **_):
    """Random f32 norm scale, masters, biases, positions and x [b, d]."""
    nscale = 1.0 + 0.1 * torch.randn((d,), generator=gen, device=dev)
    ws = [torch.randn((d, nh * hd), generator=gen, device=dev) * d ** -0.5
          for nh in (h, hkv, hkv)]
    biases = tuple(0.1 * torch.randn((nh, hd), generator=gen, device=dev)
                   for nh in (h, hkv, hkv)) if bias else None
    pos = torch.randint(0, BS * M, (b,), generator=gen, device=dev,
                        dtype=torch.int32)
    x32 = torch.randn((b, d), generator=gen, device=dev)
    return nscale, ws, biases, pos, x32


def _prologue_tol(torch, x, nscale, ws, datapath, ref, eps):
    """The phase-3 tolerance of a prologue row: (atol, rtol, text)."""
    scale_ref = max(float(r.float().abs().max()) for r in ref)
    if x.dtype == torch.float32:
        # f32 sums in another order, and cos/sin/pow of the rope angle (up
        # to 511 rad) in another library
        atol, rtol, tol = (2e-4 * scale_ref, 2e-4,
                           "|d| <= 2e-4*max|ref| + 2e-4*|ref|")
    else:
        # the reference rounds to bf16 after the dot, after the bias and
        # after the rope: up to one bf16 ulp (2^-7 relative) at each of them
        atol, rtol, tol = (2.0 ** -7 * scale_ref, 2.0 ** -6,
                           "|d| <= 2^-7*max|ref| + 2^-6*|ref|")
    if datapath == "int8":
        # the normed row, rounded in another order, may move one activation
        # payload by one step: sx * max|w| per output
        xn = x.float() * torch.rsqrt(
            x.float().square().mean(-1, keepdim=True) + eps) * nscale
        sx = float(xn.abs().amax()) / 127.0
        step = sx * max(float(w.abs().max()) for w in ws)
        atol += 2 * step
        tol += f" + 2*sx*max|w| ({2 * step:.3g})"
    return atol, rtol, tol


def _prologue_close(got, ref, atol, rtol):
    err, ok = 0.0, True
    for g_, r_ in zip(got, ref):
        e, o = compare(g_.float(), r_.float(), atol=atol, rtol=rtol)
        err, ok = max(err, e), ok and o
    return err, ok


def _unfused_prologue(torch, x, nscale, ws, biases, pos, datapath, shp):
    """The engine's unfused branch on the row's inputs, as a yardstick:
    ``layers.apply_norm`` + ``layers._project_qkv`` (rmsnorm, three
    fxp_matmul launches, bias, ``apply_rope``) under the emulate backend;
    for int8 the same steps with W quantized beforehand (not timed) and x
    quantized per tensor at each projection, as ``ops.dense_fwd`` does.
    Returns a function that runs them."""
    import types

    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.fxp_matmul import fxp_matmul
    from repro_torch.models import layers as L
    from repro_torch.quant.int8 import quantize_int8_absmax

    b, d, hd = x.shape[0], x.shape[1], shp["hd"]
    heads = (shp["h"], shp["hkv"], shp["hkv"])
    cfg = types.SimpleNamespace(norm_kind="rmsnorm", norm_eps=shp["eps"],
                                qkv_bias=biases is not None, use_rope=True,
                                rope_theta=shp["theta"])
    x3, positions, norm = x[:, None, :], pos[:, None], {"scale": nscale}
    attn = {f"w{n}": w.view(d, nh, hd) for n, w, nh in zip("qkv", ws, heads)}
    if biases is not None:
        attn.update({f"b{n}": bb for n, bb in zip("qkv", biases)})
    if datapath == "emulate":
        def run():
            with kops.kernel_backend_ctx("emulate"):
                return L._project_qkv(attn, L.apply_norm(norm, x3, cfg), cfg,
                                      positions)
        return run
    q8 = [quantize_int8_absmax(w) for w in ws]

    def run():
        h2 = L.apply_norm(norm, x3, cfg).reshape(b, d)
        out = []
        for (qw, sw), nh, n in zip(q8, heads, "qkv"):
            qx, sx = quantize_int8_absmax(h2)
            y = fxp_matmul(qx, qw, out_bits=None, act="identity",
                           datapath="int8", scale=sx * sw)
            y = y.to(x.dtype).reshape(b, 1, nh, hd)
            if biases is not None:
                y = y + attn[f"b{n}"].to(x.dtype)
            out.append(y)
        q, k, v = out
        return (L.apply_rope(q, positions, cfg.rope_theta),
                L.apply_rope(k, positions, cfg.rope_theta), v)
    return run


def check_decode_prologue(torch, dev, flush, gen):
    """Each prologue row against its plain version, with the engine's
    unfused branch on the same inputs beside it (``unfused_ms``)."""
    from repro_torch.kernels.decode_prologue import (fused_prologue,
                                                     prologue_plain)
    from repro_torch.quant.int8 import quantize_int8_absmax

    rows = []
    for shp in PROLOGUE_SHAPES:
        b, d, h, hkv, hd = (shp[k] for k in ("b", "d", "h", "hkv", "hd"))
        nscale, ws, biases, pos, x32 = _prologue_inputs(torch, dev, gen,
                                                        **shp)
        stat = dict(use_rope=True, theta=shp["theta"], eps=shp["eps"], h=h,
                    hkv=hkv, hd=hd)
        q8 = [quantize_int8_absmax(w) for w in ws]
        shape = (f"B{b} D{d} H{h} Hkv{hkv} hd{hd}"
                 + (" bias" if shp["bias"] else "") + " rope")
        for dt_name, datapath in shp["variants"]:
            dt = getattr(torch, dt_name)
            x = x32.to(dt)
            if datapath == "int8":
                w3 = [q for q, _ in q8]
                wscales = torch.stack([s for _, s in q8])
                wbytes = sum(w.numel() for w in w3)
            else:
                w3, wscales = ws, None
                wbytes = 4 * sum(w.numel() for w in w3)

            def run(fn):
                return fn(x, nscale, *w3, biases, pos, wscales=wscales,
                          **stat)
            got, ref = run(fused_prologue), run(prologue_plain)
            torch.cuda.synchronize()
            atol, rtol, tol = _prologue_tol(torch, x, nscale, ws, datapath,
                                            ref, shp["eps"])
            err, ok = _prologue_close(got, ref, atol, rtol)
            require(ok, f"decode_prologue {datapath} {dt} {shape}: max err "
                        f"{err} beyond {tol}")
            # int8: exact sums, and the plain version norms the rows in the
            # rows kernel's order, so the two are equal bit for bit
            require(datapath != "int8" or all(
                torch.equal(g_, r_) for g_, r_ in zip(got, ref)),
                f"decode_prologue int8 {dt} {shape}: not bitwise equal to "
                f"its plain version (max err {err})")
            unfused = _unfused_prologue(torch, x, nscale, ws, biases, pos,
                                        datapath, shp)
            u_err, u_ok = _prologue_close(
                [t.reshape(r.shape) for t, r in zip(unfused(), ref)], ref,
                atol, rtol)
            if datapath == "emulate":
                require(u_ok, f"decode_prologue unfused emulate {dt} {shape}:"
                              f" max err {u_err} beyond {tol}")
            ms = time_ms(lambda: run(fused_prologue), torch, flush)
            plain_ms = time_ms(lambda: run(prologue_plain), torch, flush)
            unfused_ms = time_ms(unfused, torch, flush)
            isz = x.element_size()
            nbytes = (wbytes + isz * b * d + 4 * d + 4 * b
                      + (4 * (h + 2 * hkv) * hd if shp["bias"] else 0)
                      + isz * b * (h + 2 * hkv) * hd)
            kind = "int8" if datapath == "int8" else dt_name
            bms, by = bound(nbytes, 2.0 * b * d * (h + 2 * hkv) * hd, kind)
            rows.append(dict(
                name="decode_prologue", variant=f"{datapath}/{dt_name}",
                shape=shape, max_abs_err=err, tol=tol, ms=ms,
                plain_ms=plain_ms, library_ms=None,
                library="no single PyTorch call", bound_ms=bms, bound_by=by,
                unfused_ms=unfused_ms, unfused_max_abs_err=u_err,
                unfused="layers.apply_norm + layers._project_qkv (int8: W "
                        "quantized beforehand, not timed; x per tensor)"))
            say(f"decode_prologue {rows[-1]['variant']} {shape}: err "
                f"{err:.3g} ({tol}) {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                f"unfused {unfused_ms:.4f} ms (err {u_err:.3g}"
                f"{'' if datapath == 'emulate' else ', not gated'}), bound "
                f"{bms:.4f} ms ({by})")
    return rows


# yi-34b attention widths (configs/yi_34b.py: 56 heads, 8 KV heads of 128,
# groups 7): 8 slots of up to 4096 positions
YI = dict(b=8, h=56, hkv=8, hd=128, bs=16, m=256)


def _attention_case(torch, dev, gen, *, b, h, hkv, hd, bs, m, lens):
    """Random K/V in a pool of 1 + b*m blocks (block 0 the null block),
    every slot owning m blocks in a shuffled order, slot 0 inactive."""
    perm = 1 + torch.randperm(b * m, generator=gen, device=dev)
    tables = perm.reshape(b, m).to(torch.int32).contiguous()
    tables[0] = 0
    lens = torch.tensor(lens, dtype=torch.int32, device=dev)
    kv = torch.randn((2, 1 + b * m, bs, hkv, hd), generator=gen, device=dev)
    return tables, lens, kv


def check_paged_attention(torch, dev, flush, gen):
    """The qwen1.5-0.5b decode shape (every dtype pair), then yi-34b's
    attention widths (bf16 q, int8 and bf16 pools)."""
    rows = []
    qwen = dict(b=B, h=H, hkv=HKV, hd=HD, bs=BS, m=M)
    case = _attention_case(torch, dev, gen, **qwen,
                           lens=[0, BS - 1, BS, 100, 255, 300, 400,
                                 BS * M - 1])
    for dt in (torch.float32, torch.bfloat16):
        for pool_kind in ("dt", "int8"):
            rows.append(_paged_attention_row(torch, dev, flush, gen, qwen,
                                             case, dt, pool_kind))
    yi_lens = [0, 1, 700, 1500, 2047, 2900, 3600, YI["bs"] * YI["m"] - 1]
    case = _attention_case(torch, dev, gen, **YI, lens=yi_lens)
    for pool_kind in ("dt", "int8"):
        rows.append(_paged_attention_row(torch, dev, flush, gen, YI, case,
                                         torch.bfloat16, pool_kind,
                                         tag="/yi-34b"))
    del case
    return rows


def _attention_pool(kv, dt, pool_kind, hkv, hd):
    from repro_torch.serving.engine import quant_kv_rows

    if pool_kind == "dt":
        return {"k": kv[0].to(dt).contiguous(), "v": kv[1].to(dt).contiguous()}
    pool = {}
    for name, t in (("k", kv[0]), ("v", kv[1])):
        p8, s8 = quant_kv_rows(t.reshape(-1, hkv, hd))
        pool[name] = p8.reshape(t.shape)
        pool[f"{name}_scale"] = s8.reshape(t.shape[:2])
    return pool


# bf16 rows: both sides round P to bf16 from f32 scores summed in another
# order and exp'd in another library, so a weight near a rounding tie may
# land one bf16 ulp (<= 2^-7 P) away: allow one such weight per row, at the
# row's largest P and max|v|; then each side rounds the output to bf16,
# one ulp (<= 2^-7 |ref|) apart
BF16_ATTN_TOL = ("|d| <= 2^-7*max_t(P)*max|v| + 2^-7*|ref| (one bf16 P "
                 "ulp per row, one output ulp)")


def _bf16_attention_atol(torch, q, kk, lens, groups, scale, vmax):
    """BF16_ATTN_TOL's absolute term per (slot, head), [B, H, 1]: q [B, H,
    hd]; kk the gathered K [B, T, Hkv, hd]."""
    ok = (torch.arange(kk.shape[1], device=q.device)[None, :]
          <= lens[:, None])                                     # [B, T]
    s = torch.einsum("bhd,bthd->bht", q.float(),
                     kk.repeat_interleave(groups, 2).float())
    pmax = torch.softmax((s * scale).masked_fill(~ok[:, None], -math.inf),
                         dim=-1).amax(-1)                       # [B, H]
    return (2.0 ** -7 * vmax * pmax.double())[..., None]


def _paged_attention_row(torch, dev, flush, gen, shp, case, dt, pool_kind,
                         tag=""):
    import torch.nn.functional as F

    from repro_torch.kernels.paged_attention import (gather_kv,
                                                     paged_attention,
                                                     paged_attention_plain)

    b, h, hkv, hd, bs, m = (shp[k] for k in ("b", "h", "hkv", "hd", "bs",
                                             "m"))
    tables, lens, kv = case
    scale = hd ** -0.5
    q = torch.randn((b, h, hd), generator=gen, device=dev).to(dt)
    pool = _attention_pool(kv, dt, pool_kind, hkv, hd)
    kw = dict(groups=h // hkv, scale=scale)
    got = paged_attention(q, pool, tables, lens, **kw)
    ref = paged_attention_plain(q, pool, tables, lens, **kw)
    torch.cuda.synchronize()
    vmax = float(kv[1].abs().max())
    kk, vv = gather_kv(pool, tables, dt)
    if dt == torch.float32:
        atol, rtol = 1e-5 * vmax, 1e-5
        tol = "|d| <= 1e-5*max|v| + 1e-5*|ref| (f32 sums, exp)"
    else:
        atol = _bf16_attention_atol(torch, q, kk, lens, h // hkv, scale, vmax)
        rtol, tol = 2.0 ** -7, BF16_ATTN_TOL
    qs = q[:, :, None, :]                                   # [B, H, 1, hd]
    ks_, vs_ = kk.transpose(1, 2), vv.transpose(1, 2)       # [B, Hkv, T, hd]
    del kk, vv
    mask = (torch.arange(m * bs, device=dev)[None, :]
            <= lens[:, None])[:, None, None, :]
    err, ok = compare(got.float(), ref.float(), atol=atol, rtol=rtol)
    variant = f"{str(dt).split('.')[-1]}/pool={pool_kind}{tag}"
    require(ok, f"paged_attention {variant}: max err {err} beyond {tol}")
    ms = time_ms(lambda: paged_attention(q, pool, tables, lens, **kw),
                 torch, flush)
    plain_ms = time_ms(
        lambda: paged_attention_plain(q, pool, tables, lens, **kw),
        torch, flush)
    # yardstick: SDPA over K/V already gathered and dequantized
    library_ms = time_ms(
        lambda: F.scaled_dot_product_attention(qs, ks_, vs_, attn_mask=mask,
                                               scale=scale,
                                               enable_gqa=h != hkv),
        torch, flush)
    nvalid = torch.clamp(lens.long() + 1, max=m * bs)
    tok = float(nvalid.sum())
    el = pool["k"].element_size()
    nbytes = (2 * tok * hkv * hd * el
              + (2 * 4 * tok if pool_kind == "int8" else 0)
              + 2 * q.numel() * q.element_size() + 4 * b * (m + 1))
    bms, by = bound(nbytes, 4.0 * tok * h * hd, str(dt).split(".")[-1])
    say(f"paged_attention {variant}: err {err:.3g} ({tol}) {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, library {library_ms:.4f} ms, bound "
        f"{bms:.5f} ms ({by}), {ms / bms:.0f}x bound")
    return dict(name="paged_attention", variant=variant,
                shape=f"B{b} bs{bs} M{m} H{h} Hkv{hkv} hd{hd} "
                      f"lens={lens.tolist()}",
                max_abs_err=err, tol=tol, ms=ms, plain_ms=plain_ms,
                library_ms=library_ms,
                library="F.scaled_dot_product_attention on gathered K/V",
                bound_ms=bms, bound_by=by)


# ---------------------------------------------------------------------------
# phase 3, continued: the training kernels at the LeNet-5 shapes
# ---------------------------------------------------------------------------

TABLE_I = ((2, 12), (2, 12), (2, 12), (1, 12), (3, 10))   # MNIST, Table I
# f32 sums taken in another order than the plain version's matmul: 1e-4 of
# the output scale; after an (I,F) output rounding a value at a grid tie
# may land one step 2^-F away, on at most 1% of the outputs
F32_TOL = "|d| <= 1e-4*max|ref| + 1e-4*|ref|"
# W - lr*dW: lr times the f32 reassociation error of dW (1e-4 of max|dW|),
# plus two f32 ulps of W for the rounding of the subtraction
UPDATE_TOL = "|d| <= 1e-4*lr*max|dW| + 2^-22*|ref|"
GRID_TOL = " (+1 grid step on <= 1%)"


def _record(torch, flush, name, variant, shape, run, plain, err, tol,
            nbytes, ops, kind, library=None,
            library_note="no single PyTorch call"):
    """Time the kernel, its plain version and the library call; one row."""
    ms = time_ms(run, torch, flush)
    plain_ms = time_ms(plain, torch, flush)
    library_ms = None if library is None else time_ms(library, torch, flush)
    bms, by = bound(nbytes, ops, kind)
    say(f"{name} {variant} {shape}: err {err:.3g} ({tol}) {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, library "
        f"{library_ms if library_ms is None else round(library_ms, 4)} ms "
        f"({library_note}), bound {bms:.4f} ms ({by})")
    return dict(name=name, variant=variant, shape=shape, max_abs_err=err,
                tol=tol, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                library=library_note, bound_ms=bms, bound_by=by)


def _bitwise(torch, got, ref):
    require(bool(got.isfinite().all()), "kernel output is not finite")
    return float((got - ref).abs().max()), bool(torch.equal(got, ref))


def _f32_close(got, ref, grid=0.0):
    return compare(got, ref, atol=1e-4 * float(ref.abs().max()), rtol=1e-4,
                   grid=grid, grid_frac=0.01)


def _update_close(got, ref, dw, grid=0.0):
    return compare(got, ref, atol=1e-4 * LR * float(dw.abs().max()),
                   rtol=2.0 ** -22, grid=grid, grid_frac=0.01)


def _int_mm_library(torch, a, b):
    """torch._int_mm(a, b) as the yardstick, where its shape rules allow."""
    try:
        torch._int_mm(a, b)
    except RuntimeError as e:
        return None, f"torch._int_mm refused: {str(e)[:100]}"
    return (lambda: torch._int_mm(a, b)), "torch._int_mm"


def check_fxp_matmul_lenet(torch, dev, flush, gen):
    """fxp_matmul at the LeNet forward shapes, with each layer's Table-I
    bits (input K = 784, head N = 10: ragged)."""
    from repro_torch.kernels.fxp_matmul import fxp_matmul, fxp_matmul_plain
    from repro_torch.quant.int8 import quantize_int8_auto

    rows = []
    for t in TRAIN_T:
        for li, (k, n) in ((0, (LENET_IN, LENET_H)), (1, (LENET_H, LENET_H)),
                           (4, (LENET_H, LENET_C))):
            bits = TABLE_I[li]
            x = torch.randn((t, k), generator=gen, device=dev)
            if li:
                x = x.clamp_min(0.0)                      # relu'd hidden
            w = torch.randn((k, n), generator=gen, device=dev) * k ** -0.5
            shape = f"{t}x{k}x{n}"
            for datapath in ("emulate", "int8"):
                if datapath == "int8":
                    (a, sx), (b, sw) = (quantize_int8_auto(x, bits),
                                        quantize_int8_auto(w, bits))
                    kw = dict(out_bits=None, act="identity", datapath="int8",
                              scale=sx * sw)
                    kind, nbytes = "int8", t * k + k * n + 4 * t * n
                else:
                    a, b = x, w
                    kw = dict(xa_bits=bits, w_bits=bits, out_bits=None,
                              act="identity")
                    kind, nbytes = "float32", 4 * (t * k + k * n + t * n)
                got = fxp_matmul(a, b, **kw)
                ref = fxp_matmul_plain(a, b, **kw)
                torch.cuda.synchronize()
                if datapath == "int8":
                    # identical int32 sums and one identical f32 rescale
                    tol, (err, ok) = "bitwise", _bitwise(torch, got, ref)
                    library, note = _int_mm_library(torch, a, b)
                else:
                    tol, (err, ok) = F32_TOL, _f32_close(got, ref)
                    library, note = None, "n/a: (I,F) rounding of operands"
                require(ok, f"fxp_matmul {datapath} lenet {shape}: max err "
                            f"{err} beyond {tol}")
                rows.append(_record(
                    torch, flush, "fxp_matmul",
                    f"{datapath}/lenet/bits={bits}", shape,
                    lambda: fxp_matmul(a, b, **kw),
                    lambda: fxp_matmul_plain(a, b, **kw), err, tol, nbytes,
                    2.0 * t * k * n, kind, library, note))
    return rows


# bp_gstep at the dense engine's dx shapes, qwen1.5-0.5b's MLP at T 2048:
# (label, Dout, Din, variants) with G [T, Dout], W [Din, Dout] -> [T, Din];
# mlp_down's bits rows carry the gate's pre-activation Z [T, 2816] (silu)
GSTEP_QWEN = (
    ("qwen_mlp_up", FF, D, (("emulate", "z=None"), ("int8", "z=None"))),
    ("qwen_mlp_down", D, FF, (("emulate", "z=None"), ("int8", "z=None"),
                              ("emulate", "silu"), ("int8", "silu"))))


def _gstep_row(torch, flush, g, w, z, datapath, act, g_bits, quant, shape,
               suffix=""):
    """One bp_gstep row: the kernel against its plain version (int8
    bitwise; emulate F32_TOL, + GRID_TOL when g_bits rounds), timed beside
    the plain version and, for z=None, the library's product."""
    from repro_torch.kernels.bp_gstep import bp_gstep, bp_gstep_plain

    kw = dict(g_bits=g_bits, act=act)
    if datapath == "int8":
        (a, sg), (b, sw) = quant(g), quant(w)
        kw.update(datapath="int8", scale=sg * sw)
        kind, esz = "int8", 1
    else:
        a, b, kind, esz = g, w, "float32", 4
    got = bp_gstep(a, b, z, **kw)
    ref = bp_gstep_plain(a, b, z, **kw)
    torch.cuda.synchronize()
    library, note = None, "n/a: f'(Z) and (I,F) rounding"
    if datapath == "int8":
        # identical int32 sums, rescale, f'(Z) product and rounding
        tol, (err, ok) = "bitwise", _bitwise(torch, got, ref)
        if z is None:
            library, note = _int_mm_library(torch, a, b.T.contiguous())
            note += " (on a pre-transposed W)"
    else:
        grid = 2.0 ** -g_bits[1] if g_bits else 0.0
        tol = F32_TOL + (GRID_TOL if grid else "")
        err, ok = _f32_close(got, ref, grid)
        if z is None:
            library, note = (lambda: a @ b.T), "g @ w.T (f32)"
    form = "z=None" if z is None else f"bits=on/{act}"
    require(ok, f"bp_gstep {datapath} {form}{suffix} {shape}: max err {err} "
                f"beyond {tol}")
    (t, dout), din = g.shape, w.shape[0]
    nbytes = esz * (t * dout + din * dout) + 4 * t * din * (
        2 if z is not None else 1)
    return _record(torch, flush, "bp_gstep", f"{datapath}/{form}{suffix}",
                   shape, lambda: bp_gstep(a, b, z, **kw),
                   lambda: bp_gstep_plain(a, b, z, **kw), err, tol, nbytes,
                   2.0 * t * din * dout, kind, library, note)


def check_bp_gstep(torch, dev, flush, gen):
    """The head's G seed: G [T, 10] against W_out [256, 10], f'(Z) of the
    last hidden layer, g_bits of layer 3 (Table I); and the z=None form.
    Then the dense engine's dx at qwen1.5-0.5b's MLP widths (GSTEP_QWEN):
    z=None as ``dense_bwd_dx`` runs it (int8 payloads by absmax), and
    f'(Z) of a silu gate with g_bits (2, 12), int8 operands as
    ``bp_gstep_op`` quantizes them."""
    from repro_torch.quant.int8 import quantize_int8_absmax, quantize_int8_auto

    rows = []
    din, dout = LENET_H, LENET_C
    for t in TRAIN_T:
        g = 0.01 * torch.randn((t, dout), generator=gen, device=dev)
        w = torch.randn((din, dout), generator=gen, device=dev) * din ** -0.5
        z = torch.randn((t, din), generator=gen, device=dev)
        shape = f"T{t} Dout{dout} Din{din}"
        for datapath, form in (("emulate", "bits"), ("int8", "bits"),
                               ("emulate", "z=None"), ("int8", "z=None")):
            if form == "bits":
                rows.append(_gstep_row(
                    torch, flush, g, w, z, datapath, "relu", TABLE_I[3],
                    lambda v: quantize_int8_auto(v, TABLE_I[4]), shape))
            else:
                rows.append(_gstep_row(
                    torch, flush, g, w, None, datapath, "identity", None,
                    quantize_int8_absmax, shape))
    t = DENSE_T
    for label, dout, din, variants in GSTEP_QWEN:
        g = 0.01 * torch.randn((t, dout), generator=gen, device=dev)
        w = torch.randn((din, dout), generator=gen, device=dev) * dout ** -0.5
        z = torch.randn((t, din), generator=gen, device=dev)
        shape = f"T{t} Dout{dout} Din{din}"
        for datapath, act in variants:
            if act == "z=None":
                rows.append(_gstep_row(
                    torch, flush, g, w, None, datapath, "identity", None,
                    quantize_int8_absmax, shape, f"/{label}"))
            else:
                rows.append(_gstep_row(
                    torch, flush, g, w, z, datapath, act, (2, 12),
                    lambda v: quantize_int8_auto(v, (2, 12)), shape,
                    f"/{label}"))
    return rows


def check_sgd_dw_update(torch, dev, flush, gen):
    """The head's update (X [T, 256], G [T, 10]) and the input layer's
    (X [T, 784], G [T, 256]) as on the path (w_bits None), and at the input
    shape the dW-only form and a kq_w variant."""
    from repro_torch.kernels.sgd_dw_update import (sgd_dw_update,
                                                   sgd_dw_update_plain)
    from repro_torch.quant.int8 import quantize_int8_auto

    rows = []
    for t in TRAIN_T:
        for layer, (din, dout, li) in (("w_out", (LENET_H, LENET_C, 4)),
                                       ("w_in", (LENET_IN, LENET_H, 0))):
            x = torch.randn((t, din), generator=gen, device=dev)
            if layer == "w_out":
                x = x.clamp_min(0.0)                      # relu'd hidden
            g = 1e-3 * torch.randn((t, dout), generator=gen, device=dev)
            w = torch.randn((din, dout), generator=gen, device=dev) \
                * din ** -0.5
            qx, sx = quantize_int8_auto(x, TABLE_I[li])
            qg, sg = quantize_int8_auto(g, TABLE_I[li])
            forms = [("w", None)]
            if layer == "w_in":
                forms += [("w=None", None), ("w", TABLE_I[0])]
            shape = f"T{t} Din{din} Dout{dout}"
            for form, w_bits in forms:
                ww = w if form == "w" else None
                for datapath in ("emulate", "int8"):
                    if datapath == "int8" and w_bits is not None:
                        continue
                    if datapath == "int8":
                        a, b, kind, esz = qx, qg, "int8", 1
                        kw = dict(w_bits=w_bits, datapath="int8",
                                  scale=sx * sg)
                    else:
                        a, b, kind, esz = x, g, "float32", 4
                        kw = dict(w_bits=w_bits)
                    got = sgd_dw_update(a, b, ww, LR, **kw)
                    ref = sgd_dw_update_plain(a, b, ww, LR, **kw)
                    torch.cuda.synchronize()
                    library, note = None, "n/a: (I,F) rounding of W_new"
                    if datapath == "int8":
                        # identical int32 sums, rescale and update order
                        tol, (err, ok) = "bitwise", _bitwise(torch, got, ref)
                        if ww is None:
                            library, note = _int_mm_library(
                                torch, a.T.contiguous(), b)
                            note += " (on a pre-transposed X)"
                        else:
                            note = "n/a: int8 product and update in one"
                    elif ww is None:
                        tol, (err, ok) = F32_TOL, _f32_close(got, ref)
                        library, note = (lambda: a.T @ b), "x.T @ g (f32)"
                    else:
                        grid = 2.0 ** -w_bits[1] if w_bits else 0.0
                        tol = UPDATE_TOL + (GRID_TOL if grid else "")
                        err, ok = _update_close(got, ref, a.T @ b, grid)
                        if w_bits is None:
                            library = (lambda: torch.addmm(w, a.T, b,
                                                           alpha=-LR))
                            note = "torch.addmm(w, x.T, g, alpha=-lr) (f32)"
                    require(ok, f"sgd_dw_update {datapath} {layer} {form} "
                                f"{shape}: max err {err} beyond {tol}")
                    nbytes = esz * t * (din + dout) + 4 * din * dout * (
                        2 if ww is not None else 1)
                    variant = f"{datapath}/{layer}/" + (
                        "w=None" if ww is None else f"w_bits={w_bits}")
                    rows.append(_record(
                        torch, flush, "sgd_dw_update", variant, shape,
                        lambda: sgd_dw_update(a, b, ww, LR, **kw),
                        lambda: sgd_dw_update_plain(a, b, ww, LR, **kw), err,
                        tol, nbytes, 2.0 * t * din * dout, kind, library,
                        note))
    return rows


# qwen1.5-0.5b's MLP up-projection as the dense engine's backward sees it:
# dW = Xᵀ G over 2048 tokens, X [T, 1024], G [T, 2816]
DENSE_T, DENSE_DIN, DENSE_DOUT = 2048, D, FF


def _dw_row(torch, flush, x, g, datapath, variant):
    """One dW-only sgd_dw_update row (dW = Xᵀ G) as the dense engine's
    backward runs it: int8 payloads by absmax (bitwise against the plain
    version), or X widened to f32 (F32_TOL)."""
    from repro_torch.kernels.sgd_dw_update import (sgd_dw_update,
                                                   sgd_dw_update_plain)
    from repro_torch.quant.int8 import quantize_int8_absmax

    (t, din), dout = x.shape, g.shape[1]
    shape = f"T{t} Din{din} Dout{dout}"
    if datapath == "int8":
        (a, sx), (b, sg) = quantize_int8_absmax(x), quantize_int8_absmax(g)
        kw = dict(datapath="int8", scale=sx * sg)
        kind, esz = "int8", 1
    else:
        a, b, kw, kind, esz = x.to(torch.float32), g, {}, "float32", 4
    got = sgd_dw_update(a, b, None, LR, **kw)
    ref = sgd_dw_update_plain(a, b, None, LR, **kw)
    torch.cuda.synchronize()
    if datapath == "int8":
        # identical int32 sums and one identical rescale
        tol, (err, ok) = "bitwise", _bitwise(torch, got, ref)
        library, note = _int_mm_library(torch, a.T.contiguous(), b)
        note += " (on a pre-transposed X)"
    else:
        tol, (err, ok) = F32_TOL, _f32_close(got, ref)
        library, note = (lambda: a.T @ b), "x.T @ g (f32)"
    require(ok, f"sgd_dw_update {variant} {shape}: max err {err} beyond "
                f"{tol}")
    return _record(
        torch, flush, "sgd_dw_update", variant, shape,
        lambda: sgd_dw_update(a, b, None, LR, **kw),
        lambda: sgd_dw_update_plain(a, b, None, LR, **kw), err, tol,
        esz * t * (din + dout) + 4 * din * dout, 2.0 * t * din * dout,
        kind, library, note)


def check_sgd_dw_update_dense(torch, dev, flush, gen):
    """The dW-only form at the qwen1.5-0.5b MLP shape, both datapaths."""
    x = torch.randn((DENSE_T, DENSE_DIN), generator=gen, device=dev)
    g = 1e-3 * torch.randn((DENSE_T, DENSE_DOUT), generator=gen, device=dev)
    return [_dw_row(torch, flush, x, g, datapath,
                    f"{datapath}/qwen_mlp/w=None")
            for datapath in ("emulate", "int8")]


# the layer engine's dense units in train_lm (qwen1.5-0.5b, T = batch 8 x
# seq 128 = 1024 tokens): (label, K, N, W's dtype) of x [T, K] @ W [K, N];
# k and v are 1024 wide too (16 KV heads of 64); the attention output
# projection takes W cast to the compute dtype, as the JAX package's does
ENGINE_UNITS = (("qkv", D, D, "float32"), ("o", D, D, "bfloat16"),
                ("gate_up", D, FF, "float32"), ("down", FF, D, "float32"))


def check_engine_units(torch, dev, flush, gen, units=ENGINE_UNITS):
    """fxp_matmul, bp_gstep and sgd_dw_update at the shapes and types that
    train_lm's steps give them (``units``; ZAMBA2_ENGINE_UNITS those of
    train_ssm's zamba2-2.7b step), so that the plans those steps run (tile
    counts, split counts, which follow from T) are the ones compared: per
    unit the forward z = x @ W (x bf16 [T, K], W [K, N] of the unit's
    dtype; int8 payloads by absmax, as ``kernels.ops.dense_fwd`` makes
    them), dx = dz @ Wᵀ (``dense_bwd_dx``: bp_gstep's z=None form, dz f32
    [T, N], emulate W widened to f32) and
    dW = xᵀ dz (``dense_bwd_dw``: sgd_dw_update's w=None form).  int8
    bitwise, emulate F32_TOL."""
    from repro_torch.kernels.fxp_matmul import fxp_matmul, fxp_matmul_plain
    from repro_torch.quant.int8 import quantize_int8_absmax

    t = TRAIN_LM_BATCH * TRAIN_LM_SEQ
    rows = []
    for label, k, n, wdt in units:
        x = torch.randn((t, k), generator=gen, device=dev).to(torch.bfloat16)
        w = (torch.randn((k, n), generator=gen, device=dev)
             * k ** -0.5).to(getattr(torch, wdt))
        dz = 0.01 * torch.randn((t, n), generator=gen, device=dev)
        for datapath in ("emulate", "int8"):
            kw = dict(out_bits=None, act="identity", datapath=datapath)
            if datapath == "int8":
                (a, sx), (b, sw) = (quantize_int8_absmax(x),
                                    quantize_int8_absmax(w))
                kw["scale"] = sx * sw
                kind, nbytes = "int8", t * k + k * n + 4 * t * n
            else:
                a, b = x, w
                kw.update(xa_bits=None, w_bits=None)
                # bf16 operands widened to f32 in the kernel: f32 products
                kind = "float32"
                nbytes = 2 * t * k + w.element_size() * k * n + 4 * t * n
            got = fxp_matmul(a, b, **kw)
            ref = fxp_matmul_plain(a, b, **kw)
            torch.cuda.synchronize()
            if datapath == "int8":
                # identical int32 sums and one identical f32 rescale
                tol, (err, ok) = "bitwise", _bitwise(torch, got, ref)
                library, note = _int_mm_library(torch, a, b)
            else:
                tol, (err, ok) = F32_TOL, _f32_close(got, ref)
                b16 = b.to(torch.bfloat16)
                library = (lambda: torch.matmul(a, b16))
                note = "torch.matmul bf16 (weights pre-cast)"
            shape = f"{t}x{k}x{n}"
            require(ok, f"fxp_matmul {datapath} engine_{label} {shape}: max "
                        f"err {err} beyond {tol}")
            rows.append(_record(
                torch, flush, "fxp_matmul",
                f"{datapath}/x=bfloat16/engine_{label}", shape,
                lambda: fxp_matmul(a, b, **kw),
                lambda: fxp_matmul_plain(a, b, **kw), err, tol, nbytes,
                2.0 * t * k * n, kind, library, note))
            rows.append(_gstep_row(
                torch, flush, dz, w if datapath == "int8" else w.float(),
                None, datapath, "identity", None,
                quantize_int8_absmax, f"T{t} Dout{n} Din{k}",
                f"/engine_{label}"))
            rows.append(_dw_row(torch, flush, x, dz, datapath,
                                f"{datapath}/engine_{label}/w=None"))
    return rows


def _offset_copy(torch, t, offset):
    """``t`` in a buffer that starts ``offset`` elements past an aligned
    address (off every vector boundary for offset 1)."""
    buf = torch.empty((t.numel() + offset,), dtype=t.dtype, device=t.device)
    return buf[offset:].view(t.shape).copy_(t)


def check_fxp_matmul_edges(torch, dev, gen):
    """Correctness only, no timing: fxp_matmul's decode path (M <= 16) and
    tiled path (M = 17) at ragged and unaligned shapes (N = 10 and 333,
    K = 784 and 1000, operands 1 element off a 16-byte boundary), with the
    tolerances of the phase-3 rows; then every split count the plan could
    pick at the decode, prefill and LeNet shapes and at zamba2-2.7b's five
    shared-block products: int8 bitwise for each."""
    from repro_torch.kernels import fxp_matmul as FM
    from repro_torch.kernels.common import sm_count
    from repro_torch.quant.int8 import quantize_int8_absmax

    def check(a, b, kw, label, plan=None):
        scale = kw.get("scale")
        if plan is None:
            got = FM.fxp_matmul(a, b, **kw)
        else:
            got = FM._launch(a, b, kw.get("xa_bits"), kw.get("w_bits"),
                             kw.get("out_bits"), kw["act"],
                             kw.get("datapath", "emulate"), scale, plan)
        ref = FM.fxp_matmul_plain(a, b, **kw)
        ob = kw.get("out_bits")
        if kw.get("datapath") == "int8" and kw["act"] in ("identity",
                                                          "relu"):
            (err, ok), tol = _bitwise(torch, got, ref), "bitwise"
        else:
            (err, ok), tol = _f32_close(got, ref, 2.0 ** -ob[1] if ob
                                        else 0.0), F32_TOL + GRID_TOL
        require(ok, f"edge fxp_matmul {label}: max err {err} beyond {tol}")

    n = 0
    bits = ((4, 10), (2, 12), (4, 10))
    for m in (1, 5, 16, 17):
        for k in (784, 1000):
            for nn in (10, 333):
                x = torch.randn((m, k), generator=gen, device=dev)
                w = torch.randn((k, nn), generator=gen, device=dev) * k ** -0.5
                (qx, sx), (qw, sw) = (quantize_int8_absmax(x),
                                      quantize_int8_absmax(w))
                for off in (0, 1):
                    cases = (
                        (x, w, dict(xa_bits=bits[0], w_bits=bits[1],
                                    out_bits=bits[2], act="silu")),
                        (x.to(torch.bfloat16), w.to(torch.bfloat16),
                         dict(xa_bits=None, w_bits=None, out_bits=None,
                              act="identity")),
                        (qx, qw, dict(out_bits=(4, 10), act="relu",
                                      datapath="int8", scale=sx * sw)))
                    for a, b, kw in cases:
                        if off:
                            a, b = (_offset_copy(torch, a, off),
                                    _offset_copy(torch, b, off))
                        check(a, b, kw, f"{a.dtype}/{b.dtype} {m}x{k}x{nn} "
                                        f"+{off}")
                        n += 1
    n_sm = sm_count(dev)
    for m, k, nn in ((B, D, FF), (B, FF, D), (BS, FF, D),
                     (128, LENET_IN, LENET_H)) + ZAMBA2_FXP:
        x = torch.randn((m, k), generator=gen, device=dev)
        w = torch.randn((k, nn), generator=gen, device=dev) * k ** -0.5
        (qx, sx), (qw, sw) = quantize_int8_absmax(x), quantize_int8_absmax(w)
        for a, b, kw in ((x, w, dict(act="identity", xa_bits=None,
                                     w_bits=None, out_bits=None)),
                         (qx, qw, dict(act="identity", out_bits=None,
                                       datapath="int8",
                                       scale=(sx * sw).reshape(1)))):
            plan = FM._plan(m, k, nn, n_sm, kw.get("datapath", "emulate"),
                            a.element_size(), b.element_size())
            nt = -(-k // plan.bk)
            for s in (1, 2, 4, 8, 16):
                if s > nt or (plan.path == "decode" and FM._x_bytes(
                        m, k, plan.bk, s, kw.get("datapath", "emulate"),
                        a.element_size()) > FM.X_SMEM):
                    continue
                check(a, b, kw, f"{a.dtype} {m}x{k}x{nn} S={s}",
                      plan._replace(splits=s))
                n += 1
    torch.cuda.synchronize()
    return n


# decode_prologue's edges: (B, D, H, Hkv, hd, bias, rope, x offset) --
# B 1, 5, 16, 24 (two passes); hd 64, 120 (h2o-danube3-4b: 4-byte W copies
# in int8, a strip of 28 pairs), 128, 256 (gemma-7b: 4 strips a head); GQA
# groups 1, 4, 7; D 1000 (a ragged last tile) and 3840; x 1 element off a
# 16-byte boundary; hd 20 (10 pairs: single-byte W copies in int8); hd 80
# (zamba2-2.7b: a strip of 32 pairs and one of 8, 4-byte W copies in int8)
PROLOGUE_EDGES = ((1, 1000, 4, 4, 64, True, True, 0),
                  (5, 3840, 32, 8, 120, False, True, 1),
                  (16, 1000, 28, 4, 128, True, False, 0),
                  (24, 3840, 4, 4, 256, False, False, 1),
                  (8, 1024, 14, 2, 120, True, True, 1),
                  (3, 3840, 8, 2, 256, True, True, 0),
                  (24, 1024, 7, 1, 64, False, True, 0),
                  (2, 1000, 3, 1, 20, True, True, 0),
                  (5, 2560, 6, 2, 80, False, True, 1))


def check_decode_prologue_edges(torch, dev, gen):
    """Correctness only, no timing: the prologue at PROLOGUE_EDGES, both
    compute dtypes and both datapaths, at every split count ``_plan`` can
    take (forced through ``splits``), each within the phase-3 row's
    tolerance of plain; int8 bitwise equal to plain and to the split-1
    launch."""
    from repro_torch.kernels import decode_prologue as DP
    from repro_torch.kernels.common import sm_count
    from repro_torch.quant.int8 import quantize_int8_absmax

    n_sm, n = sm_count(dev), 0
    for b, d, h, hkv, hd, bias, rope, off in PROLOGUE_EDGES:
        nscale, ws, biases, pos, x32 = _prologue_inputs(
            torch, dev, gen, b=b, d=d, h=h, hkv=hkv, hd=hd, bias=bias)
        q8 = [quantize_int8_absmax(w) for w in ws]
        kw = dict(use_rope=rope, theta=1e4, eps=1e-5, h=h, hkv=hkv, hd=hd)
        for dt in (torch.float32, torch.bfloat16):
            x = x32.to(dt)
            if off:
                x = _offset_copy(torch, x, off)
            for datapath in ("emulate", "int8"):
                if datapath == "int8":
                    w3 = [q for q, _ in q8]
                    wscales = torch.stack([s for _, s in q8])
                else:
                    w3, wscales = ws, None
                ref = DP.prologue_plain(x, nscale, *w3, biases, pos,
                                        wscales=wscales, **kw)
                atol, rtol, tol = _prologue_tol(torch, x, nscale, ws,
                                                datapath, ref, kw["eps"])
                label = (f"B{b} D{d} H{h} Hkv{hkv} hd{hd} bias={bias} "
                         f"rope={rope} +{off} {dt} {datapath}")
                first = None
                for s in (1, 2, 4, 8):
                    try:
                        plan = DP._plan(b, d, h, hkv, hd, n_sm, datapath,
                                        x.element_size(), splits=s)
                    except ValueError:
                        continue
                    got = DP._launch(x, nscale, *w3, biases, pos, wscales,
                                     plan=plan, **kw)
                    err, ok = _prologue_close(got, ref, atol, rtol)
                    require(ok, f"edge decode_prologue {label} S={s}: max "
                                f"err {err} beyond {tol}")
                    if datapath == "int8":
                        require(all(torch.equal(g_, r_)
                                    for g_, r_ in zip(got, ref)),
                                f"edge decode_prologue {label} S={s}: not "
                                "bitwise equal to plain")
                        if first is None:
                            require(s == 1, f"edge decode_prologue {label}: "
                                            "no split-1 plan")
                            first = got
                        require(all(torch.equal(g_, f_)
                                    for g_, f_ in zip(got, first)),
                                f"edge decode_prologue {label} S={s}: not "
                                "bitwise equal to S=1")
                    n += 1
    torch.cuda.synchronize()
    return n


# bp_gstep's edges: (T, Din, Dout, offset, act) -- T 1, 33, 1000, 4100 (no
# multiple of a tile); Din 50, 130, 1000 (no multiple of 64 or 128); Dout
# 1, 10 and 15 (the short path, at every row count), 16 (the tiled path's
# least), 40 (ragged last tiles), 70 (rows of no whole 16-byte pieces), 80
# (int8: 16-byte pieces, a ragged last tile) and 1000 (int8: no whole
# pieces, f32: whole), the tiled ones at every split count; an operand 1
# element past an aligned address; f'(Z) of every activation
GSTEP_EDGES = ((1, 50, 1, 0, "relu"), (33, 130, 10, 1, "sigmoid"),
               (1000, 1000, 15, 0, "silu"), (4100, 130, 40, 1, "tanh"),
               (33, 1000, 70, 0, "gelu"), (4100, 50, 16, 1, "silu"),
               (1000, 130, 80, 0, "relu"), (1, 1000, 1000, 1, "tanh"),
               (1000, 1000, 1000, 0, "silu"), (33, 50, 1000, 1, "gelu"))


def check_bp_gstep_edges(torch, dev, gen):
    """Correctness only: bp_gstep at GSTEP_EDGES, with Z (g_bits (2, 12))
    and z=None, both datapaths, at every row count of the short path and
    every split count of the tiled one: int8 bitwise, emulate within the
    phase-3 tolerances."""
    from repro_torch.kernels import bp_gstep as GS
    from repro_torch.kernels.common import sm_count
    from repro_torch.quant.int8 import quantize_int8_absmax

    n_sm, n = sm_count(dev), 0
    for t, din, dout, off, act in GSTEP_EDGES:
        g = 0.01 * torch.randn((t, dout), generator=gen, device=dev)
        w = torch.randn((din, dout), generator=gen, device=dev) * dout ** -0.5
        z = torch.randn((t, din), generator=gen, device=dev)
        (qg, sg), (qw, sw) = quantize_int8_absmax(g), quantize_int8_absmax(w)
        if off:
            g, w, z, qg, qw = (_offset_copy(torch, v, off)
                               for v in (g, w, z, qg, qw))
        for datapath, a, b, scale in (("emulate", g, w, None),
                                      ("int8", qg, qw, sg * sw)):
            for zz, kw in ((z, dict(g_bits=(2, 12), act=act)),
                           (None, dict(g_bits=None, act="identity"))):
                ref = GS.bp_gstep_plain(a, b, zz, datapath=datapath,
                                        scale=scale, **kw)
                if dout < GS.SHORT_DOUT:
                    plans = [GS._plan(t, din, dout, n_sm, datapath, rows=r)
                             for r in GS.SHORT_ROWS]
                else:
                    nt = -(-dout // GS.TILE_K[datapath])
                    plans = [GS._plan(t, din, dout, n_sm, datapath,
                                      splits=sp)
                             for sp in (1, 2, 4, 8) if sp <= nt]
                for p in plans:
                    got = GS._launch(a, b, zz, kw["g_bits"], kw["act"],
                                     datapath, scale, (a, b) if zz is None
                                     else (a, b, zz), p)
                    if datapath == "int8":
                        (err, ok), tol = _bitwise(torch, got, ref), "bitwise"
                    else:
                        grid = 2.0 ** -12 if zz is not None else 0.0
                        (err, ok), tol = _f32_close(got, ref, grid), (
                            F32_TOL + (GRID_TOL if grid else ""))
                    require(ok, f"edge bp_gstep {datapath} T{t} Din{din} "
                                f"Dout{dout} +{off} {kw['act']} {p}: max "
                                f"err {err} beyond {tol}")
                    n += 1
    torch.cuda.synchronize()
    return n


# the activation rows of ROADMAP fault C2: int8 fxp_matmul (act_fn) and
# int8 bp_fused_unit (f'(Z)) with each non-relu activation, held bitwise.
# fxp_matmul: (M, K, N) on the decode path, the tiled path, a ragged shape
# and the dense engine's qwen1.5-0.5b MLP gate (T 1024); bp_fused_unit:
# (T, Din, Dout) of the LeNet frame, its head and a 2816-wide frame.
ACT_EDGE_ACTS = ("sigmoid", "tanh", "silu", "gelu")
ACT_EDGE_FXP = ((B, D, FF), (128, LENET_IN, LENET_H), (33, 1000, 333),
                (1024, D, FF))
ACT_EDGE_FUSED = ((128, LENET_H, LENET_H), (100, 48, 10), (64, 256, FF))


def check_act_edges(torch, dev, gen):
    """Correctness only: the int8 rows of fxp_matmul and bp_fused_unit with
    a sigmoid, tanh, silu or gelu activation, bitwise against their plain
    versions.  Every row is printed; a row that is not bitwise fails the
    phase at the end with the prefix "edge C2", so that a parent tree's
    kernels can be run past it (tools/run_smoke_tree.py --known "edge C2")
    and the log shows each row it missed."""
    from repro_torch.kernels import bp_fused_unit as FU
    from repro_torch.kernels import fxp_matmul as FM
    from repro_torch.quant.int8 import quantize_int8_absmax, quantize_int8_auto

    misses, n = [], 0

    def row(label, got, ref):
        nonlocal n
        n += 1
        require(bool(got.isfinite().all()), f"{label}: not finite")
        diff = int((got != ref).sum())
        say(f"C2 row {label}: {'bitwise' if diff == 0 else 'NOT bitwise'}, "
            f"{diff} of {ref.numel()} elements differ, max err "
            f"{float((got - ref).abs().max()):.3g}")
        if diff:
            misses.append(label)

    for m, k, nn in ACT_EDGE_FXP:
        x = torch.randn((m, k), generator=gen, device=dev)
        w = torch.randn((k, nn), generator=gen, device=dev) * k ** -0.5
        (qx, sx), (qw, sw) = quantize_int8_absmax(x), quantize_int8_absmax(w)
        for act in ACT_EDGE_ACTS:
            for ob in ((4, 10), None):
                kw = dict(out_bits=ob, act=act, datapath="int8",
                          scale=sx * sw)
                row(f"fxp_matmul int8 {act} out_bits={ob} {m}x{k}x{nn}",
                    FM.fxp_matmul(qx, qw, **kw),
                    FM.fxp_matmul_plain(qx, qw, **kw))
    bits = TABLE_I[1]
    for t, din, dout in ACT_EDGE_FUSED:
        g = 1e-3 * torch.randn((t, dout), generator=gen, device=dev)
        w = torch.randn((din, dout), generator=gen, device=dev) * din ** -0.5
        x = torch.randn((t, din), generator=gen, device=dev)
        z = torch.randn((t, din), generator=gen, device=dev)
        (qg, sg), (qx, sx) = (quantize_int8_auto(g, bits),
                              quantize_int8_auto(x, bits))
        for act in ACT_EDGE_ACTS:
            kw = dict(g_bits=bits, w_bits=bits, w_out_bits=None, act=act,
                      datapath="int8", g_scale=sg, x_scale=sx)
            got = FU.bp_fused_unit(qg, w, qx, z, LR, **kw)
            ref = FU.bp_fused_unit_plain(qg, w, qx, z, LR, **kw)
            label = f"bp_fused_unit int8 {act} T{t} Din{din} Dout{dout}"
            row(f"{label} G_out", got[0], ref[0])
            row(f"{label} W_new", got[1], ref[1])
    torch.cuda.synchronize()
    require(not misses, f"edge C2: {len(misses)} of {n} activation rows "
                        f"not bitwise: {misses}")
    return n


def check_edges(torch, dev, gen):
    """Correctness only, no timing: fxp_matmul's, bp_gstep's,
    bp_fused_unit's and decode_prologue's own checks, then sgd_dw_update and paged_attention
    at ragged and unaligned shapes the main paths do not reach -- a token
    count that is no multiple of a tile, widths that are no multiple of 16
    bytes, an operand that starts 4 bytes past an aligned address,
    h2o-danube3-4b's hd = 120 (120 bytes a row in int8), block sizes that
    do not divide a chunk, and MQA with 16 query heads (two register
    blocks of 8); and a pool that starts off a vector boundary, which
    paged_attention must refuse."""
    from repro_torch.kernels.paged_attention import (gather_kv,
                                                     paged_attention,
                                                     paged_attention_plain)
    from repro_torch.kernels.sgd_dw_update import (sgd_dw_update,
                                                   sgd_dw_update_plain)
    from repro_torch.quant.int8 import quantize_int8_absmax

    n_act = check_act_edges(torch, dev, gen)
    n_fxp = check_fxp_matmul_edges(torch, dev, gen)
    n_gstep = check_bp_gstep_edges(torch, dev, gen)
    n_fused = check_bp_fused_unit_edges(torch, dev, gen)
    n_pro = check_decode_prologue_edges(torch, dev, gen)
    n = 0
    for t, din, dout, offset in ((100, 50, 10, 0), (1000, 784, 10, 0),
                                 (33, 130, 70, 1), (3, 16, 16, 0),
                                 (4100, 64, 48, 1)):
        x = torch.randn((t * din + offset,), generator=gen,
                        device=dev)[offset:].view(t, din)
        g = 1e-3 * torch.randn((t, dout), generator=gen, device=dev)
        w = torch.randn((din, dout), generator=gen, device=dev)
        for ww, bits in ((None, None), (w, None), (w, (2, 12))):
            got = sgd_dw_update(x, g, ww, LR, w_bits=bits)
            ref = sgd_dw_update_plain(x, g, ww, LR, w_bits=bits)
            if ww is None:
                err, ok = _f32_close(got, ref)
            else:
                err, ok = _update_close(got, ref, x.T @ g,
                                        2.0 ** -bits[1] if bits else 0.0)
            require(ok, f"edge sgd_dw_update emulate T{t} Din{din} "
                        f"Dout{dout} +{offset} w={ww is not None} "
                        f"bits={bits}: max err {err}")
            (qx, sx), (qg, sg) = quantize_int8_absmax(x), \
                quantize_int8_absmax(g)
            if offset:
                qx = torch.empty((t * din + offset,), dtype=torch.int8,
                                 device=dev)[offset:].view(t, din).copy_(qx)
            kw = dict(w_bits=bits, datapath="int8", scale=sx * sg)
            got = sgd_dw_update(qx, qg, ww, LR, **kw)
            ref = sgd_dw_update_plain(qx, qg, ww, LR, **kw)
            err, ok = _bitwise(torch, got, ref)
            require(ok, f"edge sgd_dw_update int8 T{t} Din{din} Dout{dout} "
                        f"+{offset} w={ww is not None} bits={bits}: max err "
                        f"{err}, not bitwise")
            n += 2
    for shp, lens in ((dict(b=3, h=32, hkv=8, hd=120, bs=16, m=12),
                       [0, 63, 191]),
                      (dict(b=4, h=16, hkv=1, hd=64, bs=7, m=30),
                       [209, 64, 65, 0]),
                      (dict(b=2, h=4, hkv=4, hd=32, bs=128, m=3),
                       [383, 127])):
        tables, lens, kv = _attention_case(torch, dev, gen, **shp, lens=lens)
        for dt in (torch.float32, torch.bfloat16):
            for pool_kind in ("dt", "int8"):
                pool = _attention_pool(kv, dt, pool_kind, shp["hkv"],
                                       shp["hd"])
                q = torch.randn((shp["b"], shp["h"], shp["hd"]),
                                generator=gen, device=dev).to(dt)
                kw = dict(groups=shp["h"] // shp["hkv"],
                          scale=shp["hd"] ** -0.5)
                for _ in range(2):          # the tickets must be zero again
                    got = paged_attention(q, pool, tables, lens, **kw)
                ref = paged_attention_plain(q, pool, tables, lens, **kw)
                vmax = float(kv[1].abs().max())
                # the tolerances of the phase-3 rows
                if dt == torch.float32:
                    atol, rtol = 1e-5 * vmax, 1e-5
                else:
                    atol = _bf16_attention_atol(
                        torch, q, gather_kv(pool, tables, dt)[0], lens,
                        kw["groups"], kw["scale"], vmax)
                    rtol = 2.0 ** -7
                err, ok = compare(got.float(), ref.float(), atol=atol,
                                  rtol=rtol)
                require(ok, f"edge paged_attention {shp} {dt} {pool_kind}: "
                            f"max err {err}")
                n += 1
    # the last case's K as a bf16 pool that starts 2 bytes past a vector
    # (q, tables, lens as the last case's bf16 rows)
    k = kv[0].to(torch.bfloat16)
    off = torch.empty((k.numel() + 1,), dtype=k.dtype,
                      device=dev)[1:].view(k.shape).copy_(k)
    try:
        paged_attention(q, {"k": off, "v": off}, tables, lens, **kw)
        refused = False
    except RuntimeError:
        refused = True
    require(refused, "edge paged_attention: a pool off a vector boundary "
                     "was not refused")
    torch.cuda.synchronize()
    say(f"edges: {n_act} int8 activation rows (C2) bitwise, "
        f"{n_fxp} ragged/unaligned/split cases of fxp_matmul, "
        f"{n_gstep} of bp_gstep, {n_fused} of bp_fused_unit, {n_pro} of decode_prologue and {n} of "
        "sgd_dw_update and paged_attention agree with their plain versions")


# a 2816-wide hidden frame (qwen1.5-0.5b's MLP width), above the first
# port's limit of 1024
WIDE_H = FF


def _unfused_pair(a, w, xx, z, kw, w_bits, g_scale, x_scale):
    """The port's own unfused pair on the frame's inputs, as a yardstick:
    bp_gstep on W rounded (emulate) or quantized (int8) beforehand -- that
    rounding is not timed -- and sgd_dw_update with w_bits = w_out_bits.
    Returns a function that runs both launches."""
    from repro_torch.kernels.bp_gstep import bp_gstep
    from repro_torch.kernels.common import maybe_kq
    from repro_torch.kernels.sgd_dw_update import sgd_dw_update
    from repro_torch.quant.int8 import quantize_int8_auto

    gk = dict(g_bits=kw["g_bits"], act=kw["act"])
    if kw.get("datapath") == "int8":
        qw, sw = quantize_int8_auto(w, w_bits)
        gk.update(datapath="int8", scale=g_scale * sw)
        uk = dict(w_bits=kw["w_out_bits"], datapath="int8",
                  scale=x_scale * g_scale)
        wg = qw
    else:
        wg, uk = maybe_kq(w, w_bits), dict(w_bits=kw["w_out_bits"])
    return lambda: (bp_gstep(a, wg, z, **gk),
                    sgd_dw_update(xx, a, w, LR, **uk))


def check_bp_fused_unit(torch, dev, flush, gen):
    """One hidden TDM frame (G, X, Z [T, 256], W [256, 256]) with Table-I
    bits; int8 with W on an absmax grid (w_bits (2, 12), too wide for int8)
    and on its exact (I,F) grid (w_bits (2, 5)); then a 2816-wide frame at
    T 128 (emulate, int8 absmax).  Beside each row, the port's unfused pair
    on the same inputs (``unfused_ms``), which must agree with the frame:
    bitwise on int8, within the row's tolerance on emulate."""
    from repro_torch.kernels.bp_fused_unit import (bp_fused_unit,
                                                   bp_fused_unit_plain)
    from repro_torch.quant.int8 import quantize_int8_auto

    rows = []
    bits = TABLE_I[1]
    variants = (("emulate", bits, ""), ("int8", bits, " absmax"),
                ("int8", (2, 5), " exact"))
    frames = [(t, LENET_H, variants) for t in TRAIN_T]
    frames.append((128, WIDE_H, variants[:2]))
    for t, width, frame_variants in frames:
        din = dout = width
        g = 1e-3 * torch.randn((t, dout), generator=gen, device=dev)
        w = torch.randn((din, dout), generator=gen, device=dev) * din ** -0.5
        x = torch.randn((t, din), generator=gen, device=dev).clamp_min(0.0)
        z = torch.randn((t, din), generator=gen, device=dev)
        (qg, sg), (qx, sx) = (quantize_int8_auto(g, bits),
                              quantize_int8_auto(x, bits))
        shape = f"T{t} Din{din} Dout{dout}"
        for datapath, w_bits, mode in frame_variants:
            kw = dict(g_bits=bits, w_bits=w_bits, w_out_bits=None, act="relu")
            if datapath == "int8":
                a, xx, kind, esz = qg, qx, "int8", 1
                kw.update(datapath="int8", g_scale=sg, x_scale=sx)
            else:
                a, xx, kind, esz = g, x, "float32", 4
            got = bp_fused_unit(a, w, xx, z, LR, **kw)
            ref = bp_fused_unit_plain(a, w, xx, z, LR, **kw)
            unfused = _unfused_pair(a, w, xx, z, kw, w_bits, sg, sx)
            pair = unfused()
            torch.cuda.synchronize()
            if datapath == "int8":
                # the kernel's W payloads, absmax and int32 sums equal the
                # plain version's, and so do the rescales and the update
                checks = [_bitwise(torch, got[0], ref[0]),
                          _bitwise(torch, got[1], ref[1]),
                          _bitwise(torch, pair[0], got[0]),
                          _bitwise(torch, pair[1], got[1])]
                tol = "bitwise"
            else:
                dw = xx.T @ a
                checks = [_f32_close(got[0], ref[0], 2.0 ** -bits[1]),
                          _update_close(got[1], ref[1], dw),
                          _f32_close(pair[0], got[0], 2.0 ** -bits[1]),
                          _update_close(pair[1], got[1], dw)]
                tol = f"G_out {F32_TOL}{GRID_TOL}; W_new {UPDATE_TOL}"
            (e1, ok1), (e2, ok2) = checks[:2]
            err, ok = max(e1, e2), ok1 and ok2
            require(ok, f"bp_fused_unit {datapath}{mode} {shape}: max err "
                        f"{e1} (G_out), {e2} (W_new) beyond {tol}")
            require(all(c[1] for c in checks[2:]),
                    f"bp_fused_unit {datapath}{mode} {shape}: the unfused "
                    f"pair differs from the frame by "
                    f"{[c[0] for c in checks[2:]]}, beyond {tol}")
            nbytes = (esz * 2 * t * din + 4 * t * din        # G, X; Z
                      + 4 * 2 * din * dout + 4 * t * din)    # W, W_new; G_out
            rows.append(_record(
                torch, flush, "bp_fused_unit",
                f"{datapath}/w_bits={w_bits}{mode}", shape,
                lambda: bp_fused_unit(a, w, xx, z, LR, **kw),
                lambda: bp_fused_unit_plain(a, w, xx, z, LR, **kw), err, tol,
                nbytes, 4.0 * t * din * dout, kind, None,
                "n/a: no single call computes the frame"))
            rows[-1]["unfused_ms"] = time_ms(unfused, torch, flush)
            rows[-1]["unfused"] = ("bp_gstep on a pre-rounded (emulate) or "
                                   "pre-quantized (int8) W, not timed, + "
                                   "sgd_dw_update(w_bits=w_out_bits)")
            say(f"  bp_fused_unit {rows[-1]['variant']} {shape}: unfused "
                f"pair {rows[-1]['unfused_ms']:.4f} ms against the frame's "
                f"{rows[-1]['ms']:.4f}")
    return rows


def check_bp_fused_unit_edges(torch, dev, gen):
    """Correctness only: bp_fused_unit at ragged T, Din and Dout (Dout 10,
    1025 and 2816; T no multiple of the 64-token block), G and X 1 element
    off a 16-byte boundary, for emulate and int8 (absmax and exact W), with
    every cluster size a plan can take (so every chunk count these widths
    give): int8 bitwise, emulate within the phase-3 tolerance."""
    from repro_torch.kernels import bp_fused_unit as FU
    from repro_torch.quant.int8 import quantize_int8_auto

    bits = TABLE_I[1]
    n = 0
    for t, din, dout, off in ((100, 48, 10, 0), (130, 40, 1025, 1),
                              (64, 256, 2816, 0), (3, 16, 16, 0),
                              (200, 70, 300, 1)):
        g = 1e-3 * torch.randn((t, dout), generator=gen, device=dev)
        w = torch.randn((din, dout), generator=gen, device=dev) * din ** -0.5
        x = torch.randn((t, din), generator=gen, device=dev).clamp_min(0.0)
        z = torch.randn((t, din), generator=gen, device=dev)
        (qg, sg), (qx, sx) = (quantize_int8_auto(g, bits),
                              quantize_int8_auto(x, bits))
        for datapath, w_bits in (("emulate", bits), ("int8", bits),
                                 ("int8", (2, 5))):
            kw = dict(g_bits=bits, w_bits=w_bits, w_out_bits=None,
                      act="relu")
            if datapath == "int8":
                a, xx = qg, qx
                kw.update(datapath="int8", g_scale=sg, x_scale=sx)
            else:
                a, xx = g, x
            if off:
                a, xx = _offset_copy(torch, a, off), _offset_copy(torch, xx,
                                                                  off)
            ref = FU.bp_fused_unit_plain(a, w, xx, z, LR, **kw)
            dw = None if datapath == "int8" else xx.T @ a
            for cluster in (1, 2, 4, 8):
                plan = FU._plan(t, din, dout, 132, datapath, cluster=cluster)
                got = FU._launch(a, w, xx, z, LR, kw["g_bits"], w_bits, None,
                                 "relu", datapath, kw.get("g_scale"),
                                 kw.get("x_scale"), plan)
                if dw is None:
                    (e1, ok1), (e2, ok2) = (_bitwise(torch, got[0], ref[0]),
                                            _bitwise(torch, got[1], ref[1]))
                else:
                    (e1, ok1), (e2, ok2) = (
                        _f32_close(got[0], ref[0], 2.0 ** -bits[1]),
                        _update_close(got[1], ref[1], dw))
                require(ok1 and ok2,
                        f"edge bp_fused_unit {datapath} w_bits={w_bits} "
                        f"T{t} Din{din} Dout{dout} +{off} {plan}: max err "
                        f"{e1} (G_out), {e2} (W_new)")
                n += 1
    torch.cuda.synchronize()
    return n


# ---------------------------------------------------------------------------
# phase 4: the serving path end to end
# ---------------------------------------------------------------------------

SERVE_ARGS = ["--arch", "qwen1.5-0.5b", "--device", "cuda", "--seed", "0",
              "--slots", str(B), "--requests", "16", "--prompt-len", "64",
              "--prompt-len-max", "192", "--shared-prefix", "64",
              "--max-new", "32", "--max-len", str(BS * M),
              "--block-size", str(BS), "--attn-impl", "kernel"]
SERVE_RUNS = (("int8", "int8"), ("emulate", "bfloat16"))
PARITY_LENS = (64, 79, 80, 100, 127, 150, 191, 192)  # prompts, then 1 step
# |d|/|ref| of the logits, card against CPU.  bf16 activations are
# rounded in another order on each side at every one of the 24 layers
# (emulate: a few bf16 ulps that grow layer by layer, 5%).  The int8
# datapath re-quantizes every activation row to amax/127 steps, and a bf16
# ulp of difference moves ~10% of the payloads by one step (~3% of a
# typical element) at each of 5 quantizations per layer: a random walk
# that reaches 5-10% after 24 layers (15%).  A wrong index or head order
# gives uncorrelated logits, |d|/|ref| ~ 1.4.
PARITY_TOL = {"emulate": 0.05, "int8": 0.15}
PROFILE_STEPS = 5
SERVE_KERNELS = ("fxp_matmul", "decode_prologue", "paged_attention")
PROFILE_GROUPS = (("fxp_matmul", "fxp_"), ("decode_prologue", "prologue_"),
                  ("paged_attention", "paged_attention_"),
                  ("bp_gstep", "gstep_"), ("sgd_dw_update", "sgd_dw_"),
                  ("bp_fused_unit", "fused_unit_"))
# the noise ops of stochastic rounding (util/prng.py's threefry2x32): the
# PyTorch elementwise kernels of int64 ("long") adds, bitwise and/or/xor
# and shifts.  Few other int64 kernels of these kinds run in a step (the
# round-to-nearest step's "prng" group shows how few)
NOISE_TAGS = ("Bitwise", "shift_kernel", "CUDAFunctor_add")


def _profile_group(name: str) -> str:
    if "long" in name and any(t in name for t in NOISE_TAGS):
        return "prng"
    return next((k for k, tag in PROFILE_GROUPS if tag in name), "other")


def serve_runs(torch):
    from repro_torch import kernels as K
    from repro_torch.launch import serve

    runs = []
    for backend, cache in SERVE_RUNS:
        argv = SERVE_ARGS + ["--kernel-backend", backend,
                             "--cache-dtype", cache]
        K.reset_launch_counts()
        report = serve.main(argv)
        counts = K.launch_counts()
        require(len(report["finished"]) == 16,
                f"serve {backend}: {len(report['finished'])}/16 finished")
        require(all(len(r.generated) == 32 for r in report["finished"]),
                f"serve {backend}: a request stopped short of 32 tokens")
        require(report["stats"]["prefix_hits"] > 0
                and report["stats"]["cow_copies"] > 0,
                f"serve {backend}: prefix sharing/COW did not run "
                f"{report['stats']}")
        for name in SERVE_KERNELS:
            require(counts[name] > 0,
                    f"serve {backend}: kernel {name} never launched")
        steps = report["decode_steps"]
        rec = dict(run=f"{backend}/{cache}", backend=backend, cache=cache,
                   counts=counts,
                   tokens=report["tokens"], seconds=report["seconds"],
                   tokens_per_s=report["tokens"] / report["seconds"],
                   decode_steps=steps,
                   ms_per_decode_step=1e3 * report["decode_seconds"]
                   / max(steps, 1),
                   stats=report["stats"])
        say(f"serve {backend}/{cache}: {rec['tokens']} tokens in "
            f"{rec['seconds']:.2f} s = {rec['tokens_per_s']:.1f} tok/s, "
            f"{steps} decode steps at {rec['ms_per_decode_step']:.2f} "
            f"ms/step, launches {counts}")
        runs.append(rec)
    return runs


def decode_parity(torch, dev):
    """One decode step after a prefill: the card's kernels against the plain
    versions on the CPU, from the same pool, tables, lens and tokens."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops as kops
    from repro_torch.models import lm
    from repro_torch.serving import engine as E

    cfg = get_config("qwen1.5-0.5b")
    params = lm.init_params(cfg, seed=1, device=dev)
    params_cpu = _tree_cpu(params)
    rng = torch.Generator(device="cpu")
    rng.manual_seed(7)
    out = []
    for backend, cache in SERVE_RUNS:
        dtype = {"int8": torch.int8, "bfloat16": torch.bfloat16}[cache]
        pool = E.init_paged_state(cfg, 1 + B * M, BS, dtype, dev)
        tables = torch.zeros((B, M), dtype=torch.int32)
        toks = torch.zeros((B, 1), dtype=torch.int32)
        for i, p in enumerate(PARITY_LENS):
            tables[i] = torch.arange(1 + i * M, 1 + (i + 1) * M)
            prompt = torch.randint(0, cfg.vocab_size, (1, p), generator=rng,
                                   dtype=torch.int32)
            for s in range(0, p, BS):
                logits, pool = E.paged_prefill_chunk(
                    params, cfg, pool, tables[i:i + 1].to(dev),
                    prompt[:, s:s + BS].to(dev), s)
            toks[i, 0] = int(torch.argmax(logits[0]))
        lens = torch.tensor(PARITY_LENS, dtype=torch.int32)
        pool_cpu = {k: v.cpu() for k, v in pool.items()}
        with kops.kernel_backend_ctx(backend, dev):
            got, _ = E.paged_decode_step(params, cfg, pool, tables.to(dev),
                                         lens.to(dev), toks.to(dev), "kernel")
        with kops.kernel_backend_ctx(backend, "cpu"):
            ref, _ = E.paged_decode_step(params_cpu, cfg, pool_cpu, tables,
                                         lens, toks, "kernel")
        got = got.cpu()
        require(tuple(got.shape) == (B, cfg.vocab_size)
                and bool(got.isfinite().all()),
                f"decode parity {backend}: logits {tuple(got.shape)} not "
                "finite or of the wrong shape")
        err = float((got - ref).abs().max())
        rel = float((got - ref).norm() / ref.norm())
        agree = float((got.argmax(-1) == ref.argmax(-1)).float().mean())
        tol = PARITY_TOL[backend]
        say(f"decode parity {backend}/{cache}: |d|/|ref| {rel:.4g} (tol "
            f"{tol}), max |d| {err:.4g} of max|ref| "
            f"{float(ref.abs().max()):.4g}, argmax agreement {agree:.3f}")
        require(rel <= tol, f"decode parity {backend}: |d|/|ref| {rel} > "
                            f"{tol}")
        out.append(dict(backend=backend, cache=cache, rel_l2_err=rel,
                        tol=f"|d|/|ref| <= {tol}", max_abs_err=err,
                        ref_max=float(ref.abs().max()),
                        argmax_agreement=agree,
                        profile=profile_steps(
                            torch, lambda: E.paged_decode_step(
                                params, cfg, pool, tables.to(dev),
                                lens.to(dev), toks.to(dev), "kernel"),
                            f"decode {backend}", backend, dev)))
    return out


# contiguous serving (PR 21): 8 slots, 8 equal-length prompts admitted
# together (the scheduler's one decode position is defined for them only),
# bf16 KV, the int8 decode backend.  The prefill runs under engine.prefill's
# own "auto", int8 on the card: 7 fxp_matmul launches a layer (q, k, v, o,
# gate, up, down); a decode step runs the fused prologue and the MLP's three
# units on the kernels, the o-projection and the attention in plain
# PyTorch, as the JAX package does
CONT_PROMPT, CONT_NEW = 128, 32
CONT_MAX_LEN = CONT_PROMPT + CONT_NEW
CONT_ARGS = ["--arch", "qwen1.5-0.5b", "--device", "cuda", "--seed", "0",
             "--mode", "contiguous", "--slots", str(B), "--requests", str(B),
             "--prompt-len", str(CONT_PROMPT), "--max-new", str(CONT_NEW),
             "--max-len", str(CONT_MAX_LEN), "--cache-dtype", "bfloat16",
             "--kernel-backend", "int8"]
CONT_PREFILL_LAUNCHES = {"fxp_matmul": 168, "bp_gstep": 0, "sgd_dw_update": 0,
                         "bp_fused_unit": 0, "decode_prologue": 0,
                         "paged_attention": 0}
CONT_DECODE_LAUNCHES = dict(CONT_PREFILL_LAUNCHES, fxp_matmul=72,
                            decode_prologue=24)
# the decode step after which the scheduler is snapshotted and restored
SNAPSHOT_AFTER = 8


# serve_ssm: contiguous serving of full-width zamba2-2.7b (hybrid:
# 9 groups of one application of the weight-tied shared block and 6 Mamba2
# layers) and mamba2-370m (ssm: 48 Mamba2 layers), 8 slots, 8 prompts of
# CONT_PROMPT tokens, CONT_NEW new, bf16 caches, the int8 backend.  The
# Mamba layers compute every product in plain PyTorch, as JAX does outside
# any Pallas kernel: only the shared block launches.  A prefill (under
# engine.prefill's "auto", int8 on the card) runs its q, k, v, o, gate, up
# and down on fxp_matmul, 7 an application; a decode step the fused
# prologue and the MLP's three units, the o-projection and the attention
# in plain PyTorch
HYBRID_ARCH, SSM_ARCH = "zamba2-2.7b", "mamba2-370m"
HYBRID_PREFILL_LAUNCHES = dict(CONT_PREFILL_LAUNCHES, fxp_matmul=7 * 9)
HYBRID_DECODE_LAUNCHES = dict(CONT_PREFILL_LAUNCHES, fxp_matmul=3 * 9,
                              decode_prologue=9)
SSM_LAUNCHES = {name: 0 for name in SOURCES}
# train_ssm: zamba2-2.7b's training step.  The engine's unit is a group; in
# each of the 9 the shared block runs its seven dense units (q, k, v, o,
# gate, up, down) once in the forward and once in the backward's
# re-linearisation (fxp_matmul), with one dx (bp_gstep) and one dW
# (sgd_dw_update) each in the backward; the Mamba layers launch nothing,
# so mamba2-370m's step launches SSM_LAUNCHES
HYBRID_TRAIN_LAUNCHES = dict(CONT_PREFILL_LAUNCHES, fxp_matmul=2 * 7 * 9,
                             bp_gstep=7 * 9, sgd_dw_update=7 * 9)
# the (M, K, N) of the shared block's fxp_matmul launches in serve_ssm
# (configs/zamba2_2_7b.py: d 2560, 32 heads and 32 KV heads of 80, FF
# 10240): a decode step at B slots runs gate, up (B x 2560 x 10240) and
# down (B x 10240 x 2560); a prefill of one CONT_PROMPT-token prompt runs
# q, k, v, o (T x 2560 x 2560), gate, up and down.  Phase 3 times them and
# the edges sweep every split count at each
ZAMBA2_D, ZAMBA2_FF = 2560, 10240
ZAMBA2_FXP = ((B, ZAMBA2_D, ZAMBA2_FF), (B, ZAMBA2_FF, ZAMBA2_D),
              (CONT_PROMPT, ZAMBA2_D, ZAMBA2_D),
              (CONT_PROMPT, ZAMBA2_D, ZAMBA2_FF),
              (CONT_PROMPT, ZAMBA2_FF, ZAMBA2_D))
# the shared block's dense units in train_ssm's zamba2-2.7b step, as
# ENGINE_UNITS lists qwen1.5-0.5b's (T = TRAIN_LM_BATCH x TRAIN_LM_SEQ):
# q, k, v and o 2560 x 2560 (32 heads and 32 KV heads of 80), gate and up
# 2560 x 10240, down 10240 x 2560; phase 3 times the three training
# kernels at each
ZAMBA2_ENGINE_UNITS = (("zamba2_qkv", ZAMBA2_D, ZAMBA2_D, "float32"),
                       ("zamba2_o", ZAMBA2_D, ZAMBA2_D, "bfloat16"),
                       ("zamba2_gate_up", ZAMBA2_D, ZAMBA2_FF, "float32"),
                       ("zamba2_down", ZAMBA2_FF, ZAMBA2_D, "float32"))


def _cont_prompts(torch, cfg, seed=11):
    import numpy as np

    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, size=(CONT_PROMPT,))
            .astype(np.int32) for _ in range(B)]


def serve_contiguous(torch, dev):
    """The serve CLI in contiguous mode (launches of the whole serve:
    B prefills and the decode steps), then, from the engine's own entry
    points: each prefill's and one decode step's launches exactly, that
    step's logits on the card against the CPU, and a profile of
    PROFILE_STEPS decode steps."""
    from repro_torch import kernels as K
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops as kops
    from repro_torch.launch import serve
    from repro_torch.models import lm
    from repro_torch.serving import engine as E

    K.reset_launch_counts()
    report = serve.main(CONT_ARGS)
    counts = K.launch_counts()
    steps = report["decode_steps"]
    require(report["mode"] == "contiguous" and len(report["finished"]) == B
            and all(len(r.generated) == CONT_NEW
                    for r in report["finished"]),
            f"serve contiguous: {len(report['finished'])}/{B} finished")
    want = {k: B * CONT_PREFILL_LAUNCHES[k] + steps * CONT_DECODE_LAUNCHES[k]
            for k in counts}
    require(steps == CONT_NEW - 1 and counts == want,
            f"serve contiguous: {steps} decode steps, launches {counts}, "
            f"expected {want}")
    rec = dict(run="serve/contiguous/int8/bfloat16", backend="int8",
               cache="bfloat16", counts=counts, tokens=report["tokens"],
               seconds=report["seconds"],
               tokens_per_s=report["tokens"] / report["seconds"],
               decode_steps=steps,
               ms_per_decode_step=1e3 * report["decode_seconds"]
               / max(steps, 1))
    say(f"serve contiguous int8/bfloat16: {rec['tokens']} tokens in "
        f"{rec['seconds']:.2f} s = {rec['tokens_per_s']:.1f} tok/s, {steps} "
        f"decode steps at {rec['ms_per_decode_step']:.2f} ms/step, launches "
        f"{counts}")

    cfg = get_config("qwen1.5-0.5b")
    params = lm.init_params(cfg, seed=1, device=dev)
    state = E.init_decode_state(cfg, B, CONT_MAX_LEN, torch.bfloat16, dev)
    toks = torch.zeros((B, 1), dtype=torch.int32)
    for i, p in enumerate(_cont_prompts(torch, cfg)):
        K.reset_launch_counts()
        logits, one = E.prefill(params, cfg,
                                {"tokens": torch.from_numpy(p[None])},
                                CONT_MAX_LEN, torch.bfloat16)
        torch.cuda.synchronize()
        require(K.launch_counts() == CONT_PREFILL_LAUNCHES,
                f"contiguous prefill {i}: launches {K.launch_counts()}, "
                f"expected {CONT_PREFILL_LAUNCHES}")
        for k, dst in state["caches"].items():
            dst[:, i] = one["caches"][k][:, 0]
        state["pos"] = one["pos"]
        toks[i, 0] = int(torch.argmax(logits[0]))
    state_cpu = {"caches": {k: v.cpu() for k, v in state["caches"].items()},
                 "pos": state["pos"].clone()}
    K.reset_launch_counts()
    with kops.kernel_backend_ctx("int8", dev):
        got, _ = E.decode_step(params, cfg, state, toks.to(dev))
    torch.cuda.synchronize()
    require(K.launch_counts() == CONT_DECODE_LAUNCHES,
            f"contiguous decode: launches {K.launch_counts()}, expected "
            f"{CONT_DECODE_LAUNCHES}")
    with kops.kernel_backend_ctx("int8", "cpu"):
        ref, _ = E.decode_step(_tree_cpu(params), cfg, state_cpu, toks)
    got = got.cpu()
    require(tuple(got.shape) == (B, cfg.vocab_size)
            and bool(got.isfinite().all()),
            f"contiguous decode parity: logits {tuple(got.shape)} not finite "
            "or of the wrong shape")
    rel = float((got - ref).norm() / ref.norm())
    agree = float((got.argmax(-1) == ref.argmax(-1)).float().mean())
    tol = PARITY_TOL["int8"]
    say(f"contiguous decode parity int8/bfloat16: |d|/|ref| {rel:.4g} (tol "
        f"{tol}), argmax agreement {agree:.3f}; launches a prefill "
        f"{CONT_PREFILL_LAUNCHES['fxp_matmul']} fxp_matmul, a decode step "
        f"{CONT_DECODE_LAUNCHES['decode_prologue']} decode_prologue + "
        f"{CONT_DECODE_LAUNCHES['fxp_matmul']} fxp_matmul, 0 "
        "paged_attention")
    require(rel <= tol, f"contiguous decode parity: |d|/|ref| {rel} > {tol}")
    # the profile writes the same position again with the same tokens
    rec["parity"] = dict(rel_l2_err=rel, tol=f"|d|/|ref| <= {tol}",
                         argmax_agreement=agree)
    rec["profile"] = profile_steps(
        torch, lambda: E.decode_step(params, cfg, state, toks.to(dev)),
        "decode contiguous int8", "int8", dev)
    rec["snapshot"] = [snapshot_restore(torch, dev, params, cfg, mode)
                       for mode in ("contiguous", "paged")]
    del params, state, state_cpu
    torch.cuda.empty_cache()
    return rec


def _numpy_tree(tree):
    """A snapshot's ints and bools as 0-d arrays: a checkpoint template."""
    import numpy as np

    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_numpy_tree(v) for v in tree]
    return np.asarray(tree)


def snapshot_restore(torch, dev, params, cfg, mode):
    """B equal-length prompts to the end, uninterrupted; then again,
    snapshotted after SNAPSHOT_AFTER decode steps, written and read back
    through the port's checkpoint layer, and restored into a fresh
    scheduler on the card: the streams must be equal."""
    import shutil
    import tempfile

    from repro_torch.ckpt import restore_checkpoint, save_checkpoint
    from repro_torch.serving import (BatchScheduler, EngineHooks, Request,
                                     ServeConfig)

    serve = ServeConfig(num_slots=B, eos_id=None, max_len=CONT_MAX_LEN,
                        mode=mode, block_size=BS, prefill_chunk=CONT_PROMPT,
                        cache_dtype="bfloat16", attn_impl="kernel",
                        kernel_backend="int8")
    prompts = _cont_prompts(torch, cfg, seed=12)

    def start():
        sched = BatchScheduler(serve, EngineHooks.for_model(params, cfg,
                                                            serve))
        reqs = [Request(uid=i, prompt=p.copy(), max_new_tokens=CONT_NEW)
                for i, p in enumerate(prompts)]
        for r in reqs:
            sched.submit(r)
        return sched, reqs

    sched, reqs = start()
    sched.run_until_drained()
    ref = {r.uid: list(r.generated) for r in reqs}
    del sched
    sched, reqs = start()
    while sched.steps_run < SNAPSHOT_AFTER:
        sched.step()
    t0 = time.perf_counter()
    snap = sched.snapshot()
    snap_s = time.perf_counter() - t0
    del sched
    root = pathlib.Path(tempfile.mkdtemp(prefix="chip-smoke-serve-"))
    try:
        save_checkpoint(root, SNAPSHOT_AFTER, snap)
        loaded, _, _ = restore_checkpoint(root, _numpy_tree(snap))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    resumed = BatchScheduler.restore(
        loaded, hooks=EngineHooks.for_model(params, cfg, serve))
    restore_s = time.perf_counter() - t0
    done = {r.uid: list(r.generated) for r in reqs if r.done}
    done.update({r.uid: list(r.generated)
                 for r in resumed.run_until_drained()})
    require(done == ref and len(ref) == B
            and all(len(v) == CONT_NEW for v in ref.values()),
            f"snapshot/restore {mode}: continued streams differ from the "
            f"uninterrupted run's")
    res = dict(mode=mode, after_decode_steps=SNAPSHOT_AFTER,
               streams_equal=True, snapshot_s=snap_s, restore_s=restore_s)
    say(f"snapshot/restore {mode}: snapshot after {SNAPSHOT_AFTER} decode "
        f"steps ({snap_s:.3f} s), through the checkpoint layer, restored "
        f"into a fresh scheduler ({restore_s:.3f} s): all {B} streams of "
        f"{CONT_NEW} tokens equal the uninterrupted run's")
    return res


SSM_SERVE_RUNS = ((HYBRID_ARCH, HYBRID_PREFILL_LAUNCHES,
                   HYBRID_DECODE_LAUNCHES),
                  (SSM_ARCH, SSM_LAUNCHES, SSM_LAUNCHES))
# the card-against-CPU check: zamba2-2.7b at full width cut to one group
# (6 Mamba2 layers and one application of the shared block), B prompts of
# SSM_PARITY_LEN tokens (one SSD chunk), a prefill and one decode step
# under each backend from the same weights and tokens, bf16 caches.  Most
# of the sound gap is the Mamba layers' bf16 products rounding in another
# order on each side (cuBLAS against the CPU's), so the limits come from
# this check's own readings (PERF.md; H100 80GB HBM3, 700 W): sound
# runs read |d|/|ref| 0.0229 (int8) and 0.0206 (emulate), the same in
# every run.  The controls, the card's run again with the last K columns
# of each down projection's X zeroed, as a kernel that drops partial sums
# would compute (SSM_FAULTS: one of the 4 K splits of the decode plan, and
# one K tile of 128 of its 80), read 0.92-0.94 and 0.23-0.24 and must
# exceed the limit.  The limit, 0.05, is about twice the sound readings
# and a fifth of the finer control's
SSM_PARITY_LEN = 40
SSM_PARITY_TOL = {"int8": 0.05, "emulate": 0.05}
SSM_FAULTS = (("dropped K split", ZAMBA2_FF // 4),
              ("dropped K tile", 128))


def _ssm_serve_argv(arch):
    return ["--arch", arch, "--device", "cuda", "--seed", "0",
            "--slots", str(B), "--requests", str(B),
            "--prompt-len", str(CONT_PROMPT), "--max-new", str(CONT_NEW),
            "--max-len", str(CONT_MAX_LEN), "--cache-dtype", "bfloat16",
            "--kernel-backend", "int8"]


def serve_ssm_run(torch, dev, arch, pre_launches, dec_launches):
    """The serve CLI on ``arch`` in its default mode (contiguous for these
    families): every request finishes with CONT_NEW tokens and the whole
    serve launches exactly B prefills' and its decode steps' kernels.
    Then, from the engine's own entry points on the weights the CLI
    served: each prefill's launches and ms, one decode step's launches, a
    profile of PROFILE_STEPS decode steps, and a snapshot after
    SNAPSHOT_AFTER decode steps restored to equal streams."""
    from repro_torch import kernels as K
    from repro_torch.launch import serve

    t_phase = time.perf_counter()
    K.reset_launch_counts()
    report = serve.main(_ssm_serve_argv(arch))
    counts = K.launch_counts()
    steps = report["decode_steps"]
    require(report["mode"] == "contiguous" and len(report["finished"]) == B
            and all(len(r.generated) == CONT_NEW
                    for r in report["finished"]),
            f"serve {arch}: mode {report['mode']}, "
            f"{len(report['finished'])}/{B} finished")
    want = {k: B * pre_launches[k] + steps * dec_launches[k] for k in counts}
    require(steps == CONT_NEW - 1 and counts == want,
            f"serve {arch}: {steps} decode steps, launches {counts}, "
            f"expected {want}")
    rec = dict(run=f"serve_ssm/{arch}/int8/bfloat16", arch=arch,
               backend="int8", cache="bfloat16", counts=counts,
               tokens=report["tokens"], seconds=report["seconds"],
               tokens_per_s=report["tokens"] / report["seconds"],
               decode_steps=steps,
               ms_per_decode_step=1e3 * report["decode_seconds"]
               / max(steps, 1))
    cfg, params = report["cfg"], report["params"]
    del report
    say(f"serve {arch} contiguous int8/bfloat16: {rec['tokens']} tokens in "
        f"{rec['seconds']:.2f} s = {rec['tokens_per_s']:.1f} tok/s, {steps} "
        f"decode steps at {rec['ms_per_decode_step']:.2f} ms/step, launches "
        f"{counts}" + ("" if any(counts.values()) else
                       " (none: the Mamba layers are plain PyTorch, as in "
                       "JAX)"))
    _engine_serve_checks(torch, dev, arch, cfg, params, pre_launches,
                         dec_launches, rec)
    rec["snapshot"] = snapshot_restore(torch, dev, params, cfg, "contiguous")
    del params
    torch.cuda.empty_cache()
    rec["phase_s"] = time.perf_counter() - t_phase
    return rec


def _engine_serve_checks(torch, dev, arch, cfg, params, pre_launches,
                         dec_launches, rec):
    """From the engine's own entry points on the served weights: B
    prefills of CONT_PROMPT tokens merged into a contiguous batch, each
    with exactly ``pre_launches`` and its ms; one decode step with exactly
    ``dec_launches`` and finite logits; a profile of PROFILE_STEPS decode
    steps.  Writes the readings into ``rec``."""
    from repro_torch import kernels as K
    from repro_torch.kernels import ops as kops
    from repro_torch.serving import engine as E

    state = E.init_decode_state(cfg, B, CONT_MAX_LEN, torch.bfloat16, dev)
    toks = torch.zeros((B, 1), dtype=torch.int32)
    prefill_ms = []
    for i, p in enumerate(_cont_prompts(torch, cfg)):
        K.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, one = E.prefill(params, cfg,
                                {"tokens": torch.from_numpy(p[None])},
                                CONT_MAX_LEN, torch.bfloat16)
        torch.cuda.synchronize()
        prefill_ms.append(1e3 * (time.perf_counter() - t0))
        require(K.launch_counts() == pre_launches,
                f"{arch} prefill {i}: launches {K.launch_counts()}, "
                f"expected {pre_launches}")
        E.merge_slot(cfg, state["caches"], one["caches"], i)
        state["pos"] = one["pos"]
        toks[i, 0] = int(torch.argmax(logits[0]))
    K.reset_launch_counts()
    with kops.kernel_backend_ctx("int8", dev):
        got, _ = E.decode_step(params, cfg, state, toks.to(dev))
    torch.cuda.synchronize()
    require(K.launch_counts() == dec_launches,
            f"{arch} decode: launches {K.launch_counts()}, expected "
            f"{dec_launches}")
    require(tuple(got.shape) == (B, cfg.vocab_size)
            and bool(got.isfinite().all()),
            f"{arch} decode: logits {tuple(got.shape)} not finite or of the "
            "wrong shape")
    rec["prefill_ms"] = prefill_ms
    rec["prefill_ms_median"] = statistics.median(prefill_ms)
    say(f"{arch} prefill of {CONT_PROMPT} tokens: median "
        f"{rec['prefill_ms_median']:.2f} ms (each "
        + ", ".join(f"{ms:.1f}" for ms in prefill_ms) + f"), launches "
        f"{pre_launches['fxp_matmul']} fxp_matmul a prefill, "
        f"{dec_launches['decode_prologue']} decode_prologue + "
        f"{dec_launches['fxp_matmul']} fxp_matmul a decode step")
    rec["profile"] = profile_steps(
        torch, lambda: E.decode_step(params, cfg, state, toks.to(dev)),
        f"decode {arch} int8", "int8", dev)
    del state


def _dropped_k(kops, k_full, cut):
    """Install into ``kops`` an ``fxp_matmul`` that zeroes the last ``cut``
    K columns of X wherever K is ``k_full``; returns the undo."""
    real = kops.fxp_matmul

    def faulty(a, b, **kw):
        if a.shape[-1] == k_full:
            a = a.clone()
            a[:, k_full - cut:] = 0
        return real(a, b, **kw)

    kops.fxp_matmul = faulty
    return lambda: setattr(kops, "fxp_matmul", real)


def _ssm_parity_side(torch, E, K, kops, p, cfg, toks, backend, d, nxt):
    """One side of the ssm parity check: the prefill's logits, then one
    decode step's on ``nxt`` (the card's first argmax when given, else
    this side's), and the launches of each."""
    K.reset_launch_counts()
    logits, state = E.prefill(p, cfg, {"tokens": torch.from_numpy(toks)},
                              SSM_PARITY_LEN + 1, torch.bfloat16,
                              kernel_backend=backend)
    if nxt is None:
        nxt = torch.argmax(logits, dim=-1)[:, None].to(torch.int32).cpu()
    pre = K.launch_counts()
    K.reset_launch_counts()
    with kops.kernel_backend_ctx(backend, d):
        dlog, _ = E.decode_step(p, cfg, state, nxt.to(d))
    return logits.cpu(), dlog.cpu(), nxt, (pre, K.launch_counts())


def serve_ssm_parity(torch, dev):
    """A depth-cut zamba2-2.7b (one group, full width) on the card and on
    the CPU from the same weights and tokens: the prefill's and one
    decode step's logits under each backend, |d|/|ref| within
    SSM_PARITY_TOL; the card's side launches exactly one application's
    kernels; each dropped-K control must exceed the limit."""
    import dataclasses

    import numpy as np

    from repro_torch import kernels as K
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops as kops
    from repro_torch.models import lm
    from repro_torch.serving import engine as E

    full = get_config(HYBRID_ARCH)
    cfg = dataclasses.replace(full, num_layers=full.attn_every)
    params = lm.init_params(cfg, seed=2, device=dev)
    params_cpu = _tree_cpu(params)
    toks = np.random.default_rng(13).integers(
        0, cfg.vocab_size, (B, SSM_PARITY_LEN)).astype(np.int32)
    groups = lm.hybrid_groups(full)[0]
    per_app = {k: v // groups for k, v in HYBRID_PREFILL_LAUNCHES.items()}
    per_dec = {k: v // groups for k, v in HYBRID_DECODE_LAUNCHES.items()}
    out, gates = [], []
    for backend in ("int8", "emulate"):
        tol = SSM_PARITY_TOL[backend]
        t0 = time.perf_counter()
        card = _ssm_parity_side(torch, E, K, kops, params, cfg, toks,
                                backend, dev, None)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        require(card[3] == (per_app, per_dec),
                f"ssm parity {backend}: card launches {card[3]}, expected "
                f"{per_app} and {per_dec}")
        nxt = card[2]
        t0 = time.perf_counter()
        cpu = _ssm_parity_side(torch, E, K, kops, params_cpu, cfg, toks,
                               backend, "cpu", nxt)
        cpu_s = time.perf_counter() - t0
        faults = {}
        for name, cut in SSM_FAULTS:
            undo = _dropped_k(kops, cfg.d_ff, cut)
            try:
                faults[name] = _ssm_parity_side(torch, E, K, kops, params,
                                                cfg, toks, backend, dev, nxt)
            finally:
                undo()
        rec = dict(backend=backend, tol=f"|d|/|ref| <= {tol}",
                   card_s=card_s, cpu_s=cpu_s)
        for i, what in enumerate(("prefill", "decode")):
            got, ref = card[i], cpu[i]
            require(tuple(got.shape) == (B, cfg.vocab_size)
                    and bool(got.isfinite().all()),
                    f"ssm parity {backend} {what}: logits "
                    f"{tuple(got.shape)} not finite or of the wrong shape")
            rel = float((got - ref).norm() / ref.norm())
            ctrl = {name: float((bad[i] - ref).norm() / ref.norm())
                    for name, bad in faults.items()}
            agree = float((got.argmax(-1) == ref.argmax(-1)).float().mean())
            rec[what] = dict(rel_l2_err=rel, argmax_agreement=agree,
                             controls=ctrl)
            say(f"ssm parity {HYBRID_ARCH} 1 group {backend} {what}: "
                f"|d|/|ref| {rel:.4g} (tol {tol}), argmax agreement "
                f"{agree:.3f}; controls "
                + ", ".join(f"{n} {v:.4g}" for n, v in ctrl.items()))
            gates.append((rel <= tol, f"ssm parity {backend} {what}: "
                                      f"|d|/|ref| {rel} > {tol}"))
            gates += [(v > tol, f"ssm parity {backend} {what}: the control "
                                f"({name}) reads {v} <= {tol}, so the limit "
                                "cannot see it") for name, v in ctrl.items()]
        say(f"ssm parity {backend}: card {card_s:.2f} s, CPU {cpu_s:.2f} s")
        out.append(rec)
    for ok, msg in gates:         # after every reading is printed
        require(ok, msg)
    del params, params_cpu
    torch.cuda.empty_cache()
    return out


def serve_ssm(torch, dev):
    """Phase serve_ssm: the two full-width serves, then the parity check."""
    t0 = time.perf_counter()
    runs = [serve_ssm_run(torch, dev, *r) for r in SSM_SERVE_RUNS]
    parity = serve_ssm_parity(torch, dev)
    secs = time.perf_counter() - t0
    say(f"serve_ssm: {secs:.1f} s")
    return runs, parity, secs


def profile_steps(torch, step, label, backend, dev, cpu_ops=True,
                  steps=PROFILE_STEPS, wall_ms=None):
    """Where a step's time goes: the step's wall time over ``steps`` steps
    (host clock, synchronised, without the profiler, whose own overhead
    inflates it; ``wall_ms`` when the caller timed the same step after
    its warm-up already), then device time by kernel over as many steps
    under torch.profiler, and the device's idle share.  ``cpu_ops=False``
    records the device activity only (a step of ~20k PyTorch ops makes
    the host events slow to collect).  Returns {"not measured": why} when
    the profiler records no device activity."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import ops as kops

    with kops.kernel_backend_ctx(backend, dev):
        if wall_ms is None:
            step()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(steps):
                step()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / steps
        # only the profiler's own calls are guarded: a failing step ends
        # the run
        prof = profile(activities=[ProfilerActivity.CUDA] + (
            [ProfilerActivity.CPU] if cpu_ops else []))
        try:
            prof.start()
        except RuntimeError as e:
            say(f"profile {label}: torch.profiler failed to start: {e}")
            return {"not measured": f"torch.profiler failed to start: {e}"}
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        try:
            prof.stop()
            # the raw events: prof.events() would build the host op tree,
            # ~100 times slower at tens of thousands of events
            events = prof.profiler.kineto_results.events()
        except RuntimeError as e:
            say(f"profile {label}: torch.profiler failed: {e}")
            return {"not measured": f"torch.profiler failed: {e}"}
    by_name, n_kernels = {}, 0
    for e in events:
        if (e.device_type() == torch.autograd.DeviceType.CUDA
                and not e.is_user_annotation()):
            n_kernels += 1
            by_name[e.name()] = (by_name.get(e.name(), 0.0)
                                 + e.duration_ns() / 1e6)
    if not by_name:
        say(f"profile {label}: the profiler saw no device time")
        return {"not measured": "no device events in torch.profiler"}
    groups = {}
    for name, ms in by_name.items():
        key = _profile_group(name)
        groups[key] = groups.get(key, 0.0) + ms / steps
    busy = sum(groups.values())
    top = sorted(((ms / steps, n[:60]) for n, ms in by_name.items()
                  if _profile_group(n) == "other"), reverse=True)[:6]
    res = {"wall_ms_per_step": wall_ms, "device_ms_per_step": busy,
           "idle_share": max(0.0, 1.0 - busy / wall_ms),
           "device_ops_per_step": n_kernels / steps,
           "device_ms_by_group": groups,
           "top_other_ms": [[n, ms] for ms, n in top]}
    say(f"profile {label}: {wall_ms:.2f} ms/step wall, device busy "
        f"{busy:.2f} ms ({100 * res['idle_share']:.1f}% idle) in "
        f"{res['device_ops_per_step']:.0f} device ops a step; by group "
        + ", ".join(f"{k} {v:.2f}" for k, v in sorted(groups.items()))
        + "; top other: "
        + ", ".join(f"{n} {ms:.2f}" for ms, n in top[:4]))
    return res


def _tree_cpu(tree):
    return {k: _tree_cpu(v) if isinstance(v, dict) else v.cpu()
            for k, v in tree.items()}


# ---------------------------------------------------------------------------
# phase 5: the LeNet-5 training step end to end
# ---------------------------------------------------------------------------

TRAIN_RUNS = ("int8", "emulate")
TRAIN_STEPS, TRAIN_BATCH, TRAIN_WARM = 150, 128, 5
# kernel launches per step: 5 forward matmuls, the head's G seed, the head
# and input updates, three hidden TDM frames
TRAIN_LAUNCHES = {"fxp_matmul": 5, "bp_gstep": 1, "sgd_dw_update": 2,
                  "bp_fused_unit": 3}
# One step, card against CPU, from the same params and batch: relative L2
# error of each parameter's update, |W_card - W_cpu| / |W_cpu - W_0|, and
# of the loss.  The G chain is rounded onto 2^-12 grids at every layer and
# its values are only a few grid steps large, so one value that an ulp of
# difference (another summation order, or PyTorch's softmax on the CPU
# against CUDA) moves across a rounding boundary changes a G element by a
# whole step, and the next frame's sums carry that step into a row of
# boundaries: a rare event with a large effect.  Reversing the order of
# every sum of the plain emulate step on the CPU alone moves the updates by
# 4.6% (w_in) and 2.1% (hidden) (tests/test_torch_training.py::
# test_lenet_update_sensitivity_to_sum_order).  The int8 chain rounds onto
# the same grids between its exact integer sums: 0.15 for both datapaths.
# The loss is a forward quantity: 1e-4.  A wrong index or layer order
# gives an uncorrelated update, |d|/|ref| ~ 1.4.
TRAIN_PARITY_TOL = 0.15
TRAIN_LOSS_TOL = 1e-4
# the one-step parity check's wide net: hidden frames of 2048 x 2048, which
# the first port of bp_fused_unit refused (Dout > 1024)
WIDE_TRAIN_HIDDEN = 2048


def _lenet_data(torch, dev):
    import numpy as np

    from repro_torch.configs.lenet5 import CONFIG
    from repro_torch.data import SyntheticClassificationDataset

    ds = SyntheticClassificationDataset(
        CONFIG.input_dim, CONFIG.num_classes, n_train=8192, n_test=2048,
        noise=3.5, seed=0)
    batches = list(ds.train_batches(TRAIN_BATCH, TRAIN_STEPS, seed=0))
    xs = torch.from_numpy(np.stack([b[0] for b in batches])).to(dev)
    ys = torch.from_numpy(np.stack([b[1] for b in batches])).to(dev)
    xt, yt = (torch.from_numpy(a).to(dev) for a in ds.test)
    return xs, ys, xt, yt


def _test_accuracy(torch, params, x, y) -> float:
    """The full-precision forward's accuracy on the test split, as the JAX
    package's convergence benchmark measures it (``eval_acc``)."""
    h = x
    for w in (params["w_in"], *params["hidden"]):
        h = torch.clamp_min(h @ w, 0.0)
    return float(((h @ params["w_out"]).argmax(-1) == y).float().mean())


def train_runs(torch, dev):
    from repro_torch import kernels as K
    from repro_torch.configs.lenet5 import CONFIG, LeNetConfig
    from repro_torch.core import (init_lenet_params, lenet_bits_table,
                                  make_lenet_train_step)

    xs, ys, xt, yt = _lenet_data(torch, dev)
    bits = lenet_bits_table(TABLE_I)
    runs, parity = [], []
    for backend in TRAIN_RUNS:
        params = init_lenet_params(CONFIG, seed=0, device=dev)
        step = make_lenet_train_step(CONFIG, bits, backend, dev)
        losses, secs = [], []
        torch.cuda.synchronize()
        K.reset_launch_counts()
        for i in range(TRAIN_STEPS):
            t0 = time.perf_counter()
            params, metrics = step(params, (xs[i], ys[i]), LR)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            losses.append(metrics["loss"])
        counts = K.launch_counts()
        loss = torch.stack(losses).cpu()
        require(bool(loss.isfinite().all()),
                f"train {backend}: a loss is not finite")
        first, last = float(loss[:20].mean()), float(loss[-20:].mean())
        for name, n in counts.items():
            want = TRAIN_LAUNCHES.get(name, 0) * TRAIN_STEPS
            require(n == want, f"train {backend}: {name} launched {n} times, "
                               f"expected {want}")
        require(last < 0.5 * first, f"train {backend}: mean loss "
                                    f"{first:.4f} -> {last:.4f} did not halve")
        rec = dict(run=f"train/{backend}", backend=backend, counts=counts,
                   steps=TRAIN_STEPS,
                   ms_per_step=1e3 * statistics.median(secs[TRAIN_WARM:]),
                   loss_first20=first, loss_last20=last,
                   test_acc=_test_accuracy(torch, params, xt, yt))
        say(f"train {backend}: {rec['ms_per_step']:.3f} ms/step (median after "
            f"{TRAIN_WARM} warm-up), loss {first:.4f} -> {last:.4f}, test acc "
            f"{rec['test_acc']:.4f}, launches {counts}")
        runs.append(rec)
        parity.append(train_parity(torch, dev, bits, backend, xs[0], ys[0]))
    # hidden frames wider than the first port's limit of 1024 (one step)
    wide = LeNetConfig(hidden=WIDE_TRAIN_HIDDEN)
    for backend in TRAIN_RUNS:
        parity.append(train_parity(torch, dev, bits, backend, xs[0], ys[0],
                                   wide, profile=False))
    return runs, parity


def train_parity(torch, dev, bits, backend, x, y, cfg=None, profile=True):
    """One step from the same params and batch: the card's kernels against
    the plain versions on the CPU; then a profile of the step."""
    from repro_torch.configs.lenet5 import CONFIG
    from repro_torch.core import init_lenet_params, make_lenet_train_step

    cfg = cfg or CONFIG
    params = init_lenet_params(cfg, seed=0, device=dev)
    params_cpu = _tree_cpu(params)
    step = make_lenet_train_step(cfg, bits, backend, dev)
    got, got_m = step(params, (x, y), LR)
    ref, ref_m = make_lenet_train_step(cfg, bits, backend, "cpu")(
        params_cpu, (x.cpu(), y.cpu()), LR)
    rel = {}
    for k, r in ref.items():
        g = got[k].cpu()
        require(g.shape == r.shape and bool(g.isfinite().all()),
                f"train parity {backend}: {k} not finite or misshapen")
        rel[k] = float((g - r).norm() / (r - params_cpu[k]).norm())
    loss_rel = abs(float(got_m["loss"]) - float(ref_m["loss"])) / abs(
        float(ref_m["loss"]))
    tol = TRAIN_PARITY_TOL
    label = f"{backend} hidden={cfg.hidden}"
    say(f"train parity {label}: update |d|/|ref| "
        + ", ".join(f"{k} {v:.3g}" for k, v in rel.items())
        + f" (tol {tol}); loss {float(got_m['loss']):.6f} vs "
          f"{float(ref_m['loss']):.6f}, rel {loss_rel:.3g} "
          f"(tol {TRAIN_LOSS_TOL})")
    require(max(rel.values()) <= tol,
            f"train parity {label}: update |d|/|ref| {rel} > {tol}")
    require(loss_rel <= TRAIN_LOSS_TOL,
            f"train parity {label}: loss rel {loss_rel} > {TRAIN_LOSS_TOL}")
    res = dict(backend=backend, hidden=cfg.hidden, update_rel_l2_err=rel,
               tol=f"|d|/|ref| <= {tol}", loss_rel_err=loss_rel,
               loss_tol=TRAIN_LOSS_TOL)
    if profile:
        res["profile"] = profile_steps(
            torch, lambda: step(params, (x, y), LR), f"train {backend}",
            backend, dev)
    return res


# ---------------------------------------------------------------------------
# phase 6: the layer engine training full-width qwen1.5-0.5b
# ---------------------------------------------------------------------------

# the JAX train driver's defaults (src/repro/launch/train.py) with its
# --quantize policy: qwen1.5-0.5b at full width and depth, seq 128, global
# batch 8, momentum, lr 3e-3, QuantPolicy(grad_scale=64), default_bits.
# Every step takes the same batch (SyntheticLMDataset seed 0, step 0): with
# a new batch each step the loss moves more from batch to batch than 20
# steps at lr 3e-3 move it over a vocabulary of 151936, while fitting one
# batch descends at once
LM_ARCH = "qwen1.5-0.5b"
TRAIN_LM_RUNS = ("int8", "emulate")
# 6 steps (10 until the ssm and hybrid training phase needed the time),
# the descent read over the first and last 3, the profiles over 3 steps
TRAIN_LM_STEPS, TRAIN_LM_WARM, TRAIN_LM_PROFILE = 6, 2, 3
TRAIN_LM_SEQ, TRAIN_LM_BATCH = 128, 8
TRAIN_LM_LR, TRAIN_LM_OPTIMIZER, TRAIN_LM_GRAD_SCALE = 3e-3, "momentum", 64.0
# kernel launches per step at 24 layers: 7 dense units a layer (q, k, v, o,
# gate, up, down), each once in the forward and once in the backward's
# re-linearisation (fxp_matmul), with one dx (bp_gstep) and one dW
# (sgd_dw_update) in the backward
TRAIN_LM_LAUNCHES = {"fxp_matmul": 336, "bp_gstep": 168, "sgd_dw_update": 168,
                     "bp_fused_unit": 0, "decode_prologue": 0,
                     "paged_attention": 0}
# One step of a 2-layer full-width net, card against CPU, from the same
# params and batch: relative L2 of each parameter's update and of the loss.
# tests/test_torch_engine.py::test_update_sensitivity_justifies_card_
# tolerance: on the CPU alone, one f32 ulp on every master moves the int8
# updates by up to 6.2% (an activation at an int8 rounding tie flips its
# payload) and the emulate updates by 1.4%, and the loss by 3.2e-4;
# reversed sum orders move emulate's by 1.2%; a swapped layer order > 100%.
# Each backend's limit is over twice its own largest spread.
TRAIN_LM_PARITY_TOL = {"emulate": 0.05, "int8": 0.15}
TRAIN_LM_LOSS_TOL = 2e-3
TRAIN_LM_PARITY_LAYERS, TRAIN_LM_PARITY_BATCH, TRAIN_LM_PARITY_SEQ = 2, 2, 64
TRAIN_LM_LAYERS = 24


# stochastic rounding (the JAX driver's --stochastic, no --quantize-updates):
# G rounded with noise keyed fold_in(fold_in(fold_in(key(1), step), layer),
# row), the JAX driver's keys, drawn by util/prng.py in plain int64 PyTorch
# ops (JAX computes them in XLA outside any Pallas kernel).  The launches a
# step are train_lm's: the rounding runs after each layer's VJP
TRAIN_LM_STOCH_STEPS = 3
NOISE_SEEDS = (0, 1, 2 ** 32 - 1)
NOISE_FOLDS = ((), (7,), (7, 3, 5), (2 ** 32 - 1, 0))
NOISE_SHAPES = ((), (5,), (4, 129, 33))
NOISE_ROW_SHAPE, NOISE_OFFSETS = (8, 6, 7), (0, 3)
# one layer's G in train_lm: [batch, seq, d_model] f32
NOISE_G_SHAPE = (TRAIN_LM_BATCH, TRAIN_LM_SEQ, D)


def _lm_step(torch, cfg, backend, dev, stochastic=False,
             optimizer=TRAIN_LM_OPTIMIZER):
    from repro_torch.core import QuantPolicy, StepOptions, make_train_step
    from repro_torch.optim import OptimizerConfig

    ocfg = OptimizerConfig(kind=optimizer)
    return make_train_step(cfg, QuantPolicy(grad_scale=TRAIN_LM_GRAD_SCALE,
                                            stochastic=stochastic),
                           ocfg, StepOptions(kernel_backend=backend),
                           device=dev), ocfg


def _step_key(step: int):
    """The JAX driver's key of ``step``: fold_in(key(1), step)."""
    from repro_torch.util import prng

    return prng.fold_in(prng.key(1), step)


def _same_bits(torch, a, b) -> bool:
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and bool(torch.equal(a.cpu(), b.cpu()))


def check_noise(torch, dev):
    """util/prng.py on the card against the same draws on the CPU, bit for
    bit: keys and fold chains of NOISE_SEEDS, bits and uniforms of
    NOISE_SHAPES, the row form at NOISE_OFFSETS, and one full layer's G
    draw; then the time of that draw and of the G rounding it feeds, as
    the engine calls them (CUDA events, cold L2: ~170 small launches, so
    the host's enqueue shows; the profile of train_lm's stochastic step
    gives their device time)."""
    from repro_torch.quant import fixed_point as FP
    from repro_torch.util import prng

    n = 0
    for seed in NOISE_SEEDS:
        for folds in NOISE_FOLDS:
            kc, kd = prng.key(seed), prng.key(seed, dev)
            for d in folds:
                kc, kd = prng.fold_in(kc, d), prng.fold_in(kd, d)
            require(kd.cpu().tolist() == kc.tolist(),
                    f"noise: key {seed} folds {folds}: card {kd.tolist()} "
                    f"cpu {kc.tolist()}")
            for shape in NOISE_SHAPES:
                require(_same_bits(torch, prng.random_bits(kd, shape),
                                   prng.random_bits(kc, shape))
                        and _same_bits(torch, prng.uniform(kd, shape),
                                       prng.uniform(kc, shape)),
                        f"noise: draws of {shape} under key {seed} folds "
                        f"{folds} differ between the card and the CPU")
                n += 2
            for off in NOISE_OFFSETS:
                require(_same_bits(
                    torch, prng.uniform_rows(kd, NOISE_ROW_SHAPE, off),
                    prng.uniform_rows(kc, NOISE_ROW_SHAPE, off)),
                    f"noise: rows at offset {off} under key {seed} folds "
                    f"{folds} differ")
                n += 1
    # layer 23's G key of step 0, as the engine folds it (on the host)
    kc = prng.fold_in(_step_key(0), TRAIN_LM_LAYERS - 1)
    require(_same_bits(torch, prng.uniform_rows(kc, NOISE_G_SHAPE, 0,
                                                device=dev),
                       prng.uniform_rows(kc, NOISE_G_SHAPE, 0)),
            f"noise: the {NOISE_G_SHAPE} G draw differs between the card "
            "and the CPU")
    n += 1
    g = torch.randn(NOISE_G_SHAPE, device=dev) * 0.01
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.int32, device=dev)
    draw_ms = time_ms(lambda: prng.uniform_rows(kc, NOISE_G_SHAPE, 0,
                                                device=dev), torch, flush)
    round_ms = time_ms(lambda: FP.stochastic_round_batched(g, 2, 12, kc, 0),
                       torch, flush)
    rtn_ms = time_ms(lambda: FP.quantize(g, 2, 12), torch, flush)
    elems = math.prod(NOISE_G_SHAPE)
    # each draw reads nothing and writes 4 bytes an element; the rounding
    # reads G and writes q(G)
    draw_bound, _ = bound(4 * elems, 0, "int8")
    res = dict(bitwise_checks=n, g_shape=list(NOISE_G_SHAPE),
               draw_ms=draw_ms, round_stochastic_ms=round_ms,
               round_nearest_ms=rtn_ms, draw_bound_ms=draw_bound,
               per_step_draw_ms=draw_ms * TRAIN_LM_LAYERS)
    say(f"noise: {n} draws bitwise equal on the card and the CPU; one "
        f"{NOISE_G_SHAPE} G draw {draw_ms:.4f} ms (bound {draw_bound:.5f} "
        f"ms), stochastic rounding of G {round_ms:.4f} ms against "
        f"round-to-nearest {rtn_ms:.4f} ms; x{TRAIN_LM_LAYERS} layers = "
        f"{res['per_step_draw_ms']:.2f} ms of draws a step")
    return res


def train_lm_runs(torch, dev):
    """TRAIN_LM_STEPS steps of each backend from the same seeds on one
    batch: every loss finite, the mean of the last half below that of the
    first half, the launches a step exactly TRAIN_LM_LAUNCHES; the timed
    ms/step, tokens/s and a profile of TRAIN_LM_PROFILE steps against
    that ms/step."""
    import numpy as np

    from repro_torch import kernels as K
    from repro_torch.configs import get_config
    from repro_torch.core import default_bits, init_train_state
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.models import lm
    from repro_torch.optim import Hyper

    cfg = get_config(LM_ARCH)
    ds = SyntheticLMDataset(cfg.vocab_size, TRAIN_LM_SEQ, TRAIN_LM_BATCH,
                            seed=0)
    batch = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
             for k, v in ds.batch_at(0).items()}
    bits = default_bits(cfg)
    runs = []
    for backend in TRAIN_LM_RUNS:
        t_run = time.perf_counter()
        params = lm.init_params(cfg, seed=0, device=dev)
        step, ocfg = _lm_step(torch, cfg, backend, dev)
        state = init_train_state(params, ocfg)
        losses, secs = [], []
        torch.cuda.synchronize()
        K.reset_launch_counts()
        for i in range(TRAIN_LM_STEPS):
            t0 = time.perf_counter()
            params, state, m = step(params, state, batch,
                                    Hyper(lr=TRAIN_LM_LR, step=i), bits)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            losses.append(m["loss"])
        counts = K.launch_counts()
        loss = torch.stack(losses).cpu()
        require(bool(loss.isfinite().all()),
                f"train_lm {backend}: a loss is not finite: {loss.tolist()}")
        half = TRAIN_LM_STEPS // 2
        first, last = (float(loss[:half].mean()),
                       float(loss[-half:].mean()))
        for name, n in counts.items():
            want = TRAIN_LM_LAUNCHES[name] * TRAIN_LM_STEPS
            require(n == want, f"train_lm {backend}: {name} launched {n} "
                               f"times, expected {want}")
        require(last < first, f"train_lm {backend}: mean loss of the first "
                              f"{half} steps {first:.4f}, of the last {half} "
                              f"{last:.4f}: no descent")
        ms = 1e3 * statistics.median(secs[TRAIN_LM_WARM:])
        rec = dict(run=f"train_lm/{backend}", backend=backend, counts=counts,
                   steps=TRAIN_LM_STEPS, ms_per_step=ms,
                   tokens_per_s=TRAIN_LM_BATCH * TRAIN_LM_SEQ / (ms / 1e3),
                   loss_first_half=first, loss_last_half=last,
                   losses=[float(v) for v in loss],
                   grad_norm_last=float(m["grad_norm"]),
                   peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 2**30)
        say(f"train_lm {backend}: {ms:.2f} ms/step (median after "
            f"{TRAIN_LM_WARM} warm-up), {rec['tokens_per_s']:.0f} tokens/s, "
            f"loss {first:.4f} -> {last:.4f}, peak memory "
            f"{rec['peak_mem_gb']:.2f} GiB, launches {counts}")
        t_prof = time.perf_counter()
        rec["profile"] = profile_steps(
            torch, lambda: step(params, state, batch,
                                Hyper(lr=TRAIN_LM_LR, step=0), bits),
            f"train_lm {backend}", backend, dev, cpu_ops=False,
            steps=TRAIN_LM_PROFILE, wall_ms=ms)
        say(f"train_lm {backend}: {t_prof - t_run:.1f} s to train, "
            f"{time.perf_counter() - t_prof:.1f} s to profile")
        runs.append(rec)
        del params, state, step
        torch.cuda.empty_cache()
    return runs


def train_lm_stochastic(torch, dev):
    """The int8 step with stochastic rounding, keyed as the JAX driver keys
    it: TRAIN_LM_STOCH_STEPS steps from seed-0 params on train_lm's batch,
    every loss finite and exactly TRAIN_LM_LAUNCHES a step; the same steps
    again from the same params, which must end on bitwise the same params;
    then profiles of TRAIN_LM_PROFILE round-to-nearest and as many
    stochastic int8 steps, in
    turns, from the same params and state (wall times move between runs,
    so the two are compared within one)."""
    import numpy as np

    from repro_torch import kernels as K
    from repro_torch.configs import get_config
    from repro_torch.core import default_bits, init_train_state
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.models import lm
    from repro_torch.optim import Hyper
    from repro_torch.util.tree import tree_leaves_with_path

    cfg = get_config(LM_ARCH)
    batch = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
             for k, v in SyntheticLMDataset(cfg.vocab_size, TRAIN_LM_SEQ,
                                            TRAIN_LM_BATCH, seed=0)
             .batch_at(0).items()}
    bits = default_bits(cfg)
    step, ocfg = _lm_step(torch, cfg, "int8", dev, stochastic=True)
    finals, total = [], {}
    for run in range(2):
        params = lm.init_params(cfg, seed=0, device=dev)
        state = init_train_state(params, ocfg)
        losses, secs = [], []
        for i in range(TRAIN_LM_STOCH_STEPS):
            torch.cuda.synchronize()
            K.reset_launch_counts()
            t0 = time.perf_counter()
            params, state, m = step(params, state, batch,
                                    Hyper(lr=TRAIN_LM_LR, step=i), bits,
                                    _step_key(i))
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            counts = K.launch_counts()
            total = {k: total.get(k, 0) + v for k, v in counts.items()}
            require(counts == TRAIN_LM_LAUNCHES,
                    f"train_lm stochastic: step {i} launched {counts}, "
                    f"expected {TRAIN_LM_LAUNCHES}")
            losses.append(float(m["loss"]))
        require(all(math.isfinite(v) for v in losses),
                f"train_lm stochastic: losses {losses}")
        finals.append(([x.cpu() for _, x in tree_leaves_with_path(params)],
                       losses, secs))
        if run == 0:
            last = (params, state)
        else:
            del params, state
    (a, loss_a, secs_a), (b, loss_b, _) = finals
    differ = sum(not _same_bits(torch, x, y) for x, y in zip(a, b))
    require(differ == 0 and loss_a == loss_b,
            f"train_lm stochastic: two runs from the same params and keys "
            f"differ in {differ} of {len(a)} leaves, losses {loss_a} vs "
            f"{loss_b}")
    params, state = last
    rec = dict(run="train_lm/int8/stochastic", backend="int8", counts=total,
               steps=TRAIN_LM_STOCH_STEPS, losses=loss_a,
               ms_per_step_timed=[1e3 * t for t in secs_a],
               bitwise_leaves=len(a))
    say(f"train_lm stochastic int8: {TRAIN_LM_STOCH_STEPS} steps, "
        f"{TRAIN_LM_LAUNCHES['fxp_matmul']}/{TRAIN_LM_LAUNCHES['bp_gstep']}/"
        f"{TRAIN_LM_LAUNCHES['sgd_dw_update']} launches each, losses "
        f"{loss_a}, step ms {[round(1e3 * t, 2) for t in secs_a]}; a second "
        f"run from the same params and keys equal bitwise on all {len(a)} "
        f"leaves")
    del finals, a, b
    rtn_step, _ = _lm_step(torch, cfg, "int8", dev)
    rtn = profile_steps(
        torch, lambda: rtn_step(params, state, batch,
                                Hyper(lr=TRAIN_LM_LR, step=0), bits),
        "train_lm int8 round-to-nearest", "int8", dev, cpu_ops=False,
        steps=TRAIN_LM_PROFILE)
    rec["profile"] = prof = profile_steps(
        torch, lambda: step(params, state, batch,
                            Hyper(lr=TRAIN_LM_LR, step=0), bits,
                            _step_key(0)),
        "train_lm int8 stochastic", "int8", dev, cpu_ops=False,
        steps=TRAIN_LM_PROFILE)
    rec["profile_round_to_nearest"] = rtn
    if "device_ms_by_group" in prof and "device_ms_by_group" in rtn:
        rec["against_round_to_nearest"] = dict(
            wall_ms=[rtn["wall_ms_per_step"], prof["wall_ms_per_step"]],
            device_ms=[rtn["device_ms_per_step"], prof["device_ms_per_step"]],
            prng_ms=[rtn["device_ms_by_group"].get("prng", 0.0),
                     prof["device_ms_by_group"].get("prng", 0.0)])
        say(f"train_lm int8 round-to-nearest -> stochastic: wall "
            f"{rtn['wall_ms_per_step']:.2f} -> {prof['wall_ms_per_step']:.2f}"
            f" ms/step, device {rtn['device_ms_per_step']:.2f} -> "
            f"{prof['device_ms_per_step']:.2f} ms, prng group "
            f"{rec['against_round_to_nearest']['prng_ms'][0]:.2f} -> "
            f"{rec['against_round_to_nearest']['prng_ms'][1]:.2f} ms")
    del params, state, last, step, rtn_step
    torch.cuda.empty_cache()
    return rec


def train_lm_parity(torch, dev):
    """One step of a TRAIN_LM_PARITY_LAYERS-layer full-width net on the
    card and on the CPU (plain versions), from the same params and batch:
    each backend, and int8 with stochastic rounding under step 0's key."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core import default_bits, init_train_state
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.models import lm
    from repro_torch.optim import Hyper
    from repro_torch.util.tree import tree_leaves_with_path

    cfg = dataclasses.replace(get_config(LM_ARCH),
                              num_layers=TRAIN_LM_PARITY_LAYERS)
    batch = SyntheticLMDataset(cfg.vocab_size, TRAIN_LM_PARITY_SEQ,
                               TRAIN_LM_PARITY_BATCH, seed=0).batch_at(0)
    bits, out = default_bits(cfg), []
    for backend, stochastic in [(b, False) for b in TRAIN_LM_RUNS] + [
            ("int8", True)]:
        params = lm.init_params(cfg, seed=0, device=dev)
        params_cpu = _tree_cpu(params)
        res = {}
        for where, p in (("card", params), ("cpu", params_cpu)):
            d = dev if where == "card" else "cpu"
            step, ocfg = _lm_step(torch, cfg, backend, d, stochastic)
            t0 = time.perf_counter()
            new, _, m = step(p, init_train_state(p, ocfg),
                             {k: torch.from_numpy(np.ascontiguousarray(v))
                              for k, v in batch.items()},
                             Hyper(lr=TRAIN_LM_LR, step=0), bits,
                             _step_key(0) if stochastic else None)
            res[where] = (_tree_cpu(new), float(m["loss"]),
                          time.perf_counter() - t0)
        (got, got_loss, t_card), (ref, ref_loss, t_cpu) = (res["card"],
                                                           res["cpu"])
        rel = {}
        for (k, r), (_, g), (_, p0) in zip(*map(tree_leaves_with_path, (
                ref, got, params_cpu))):
            require(g.shape == r.shape and bool(g.isfinite().all()),
                    f"train_lm parity {backend}: {k} not finite/misshapen")
            rel[k] = float((g - r).norm() / (r - p0).norm())
        loss_rel = abs(got_loss - ref_loss) / abs(ref_loss)
        tol = TRAIN_LM_PARITY_TOL[backend]
        label = backend + (" stochastic" if stochastic else "")
        say(f"train_lm parity {label} ({TRAIN_LM_PARITY_LAYERS} layers, "
            f"full width): update |d|/|ref| max {max(rel.values()):.3g} "
            f"({max(rel, key=rel.get)}; tol {tol}); loss "
            f"{got_loss:.6f} vs {ref_loss:.6f}, rel {loss_rel:.3g} (tol "
            f"{TRAIN_LM_LOSS_TOL}); card {t_card:.2f} s, cpu {t_cpu:.2f} s")
        require(max(rel.values()) <= tol,
                f"train_lm parity {label}: update |d|/|ref| {rel} > "
                f"{tol}")
        require(loss_rel <= TRAIN_LM_LOSS_TOL,
                f"train_lm parity {label}: loss rel {loss_rel} > "
                f"{TRAIN_LM_LOSS_TOL}")
        out.append(dict(backend=backend, stochastic=stochastic,
                        layers=TRAIN_LM_PARITY_LAYERS,
                        update_rel_l2_err=rel, tol=tol,
                        loss_rel_err=loss_rel, loss_tol=TRAIN_LM_LOSS_TOL))
        del params, params_cpu, res, got, ref
    return out


# ---------------------------------------------------------------------------
# phase 5e: the layer engine on the ssm and hybrid families
# ---------------------------------------------------------------------------

# train_lm's step (momentum, grad_scale 64, default bits, lr 3e-3) on one
# synthetic batch of TRAIN_LM_BATCH x TRAIN_LM_SEQ, on full-width
# zamba2-2.7b (both backends, all 54 layers) and mamba2-370m (no kernel to
# choose) cut to TRAIN_SSM_MAMBA_LAYERS of its 48 layers: its step is
# host-bound (89% idle at 48 layers), and the cut keeps the script's time
TRAIN_SSM_MAMBA_LAYERS = 16
TRAIN_SSM_RUNS = ((HYBRID_ARCH, "int8", HYBRID_TRAIN_LAUNCHES, None),
                  (HYBRID_ARCH, "emulate", HYBRID_TRAIN_LAUNCHES, None),
                  (SSM_ARCH, "int8", SSM_LAUNCHES, TRAIN_SSM_MAMBA_LAYERS))
TRAIN_SSM_STEPS, TRAIN_SSM_WARM, TRAIN_SSM_PROFILE = 6, 2, 3
TRAIN_SSM_STOCH_STEPS, TRAIN_SSM_DRIVER_STEPS = 2, 3
# the card-against-CPU check: one step of zamba2-2.7b cut to one group (6
# Mamba2 layers and one application of the shared block) under each
# backend, and of mamba2-370m cut to 2 layers, at full width from the same
# params and batch (SSM_TRAIN_PARITY_BATCH x SSM_TRAIN_PARITY_SEQ), read
# as the relative L2 of the update (new params minus the step-start
# params) against the CPU's, three ways:
#   * the whole update, every leaf together, within SSM_TRAIN_PARITY_TOL
#     (train_lm's TRAIN_LM_PARITY_TOL).  The large matrices set it;
#   * each leaf on its own, the Mamba2 vectors A_log and dt_bias aside,
#     within SSM_TRAIN_LEAF_TOL, so that a fault in a small leaf (D_skip,
#     conv_b_*, gate_norm, a norm) shows;
#   * A_log and dt_bias within SSM_TRAIN_VECTOR_TOL: their gradients sum
#     over every position and head, and one f32 ulp added to every master
#     moves their updates by up to 0.53 of themselves on the CPU alone,
#     where every other leaf moves by at most 0.055 (int8) and 0.026
#     (emulate) on the hybrid and 0.025 on the ssm, and the whole update by
#     0.040, 0.022 and 0.0023 (tests/test_torch_engine_ssm.py::
#     test_update_sensitivity_justifies_ssm_card_tolerance).
# Sound runs on the card (PERF.md; H100 80GB HBM3, 700 W) read, whole /
# largest other leaf / A_log or dt_bias: 0.0742 / 0.0861 / 0.212 (int8)
# and 0.0228 / 0.0267 / 0.134 (emulate) on the one group, 0.0048 / 0.0078
# / 0.069 on mamba2's 2 layers, the same in every run.  Each limit is
# about twice the larger of its sound card reading and its CPU one-ulp
# spread.  The controls, the hybrid's card step again under serve_ssm's
# dropped-K faults (SSM_FAULTS), must read beyond the whole and the leaf
# limits each, and the larger of them beyond the vectors' limit; the
# dropped K split reads 1.09 whole and the dropped K tile 0.295 / 0.287.
# mamba2 launches no kernel, so no dropped-K fault reaches it: its cut has
# no control.
SSM_TRAIN_PARITY_BATCH, SSM_TRAIN_PARITY_SEQ = 2, 64
SSM_TRAIN_PARITY_TOL = dict(TRAIN_LM_PARITY_TOL)
SSM_TRAIN_VECTORS = ("blocks/mamba/A_log", "blocks/mamba/dt_bias")
SSM_TRAIN_LEAF_TOL = {"emulate": 0.06, "int8": 0.2}
SSM_TRAIN_VECTOR_TOL = 1.0
SSM_TRAIN_LOSS_TOL = TRAIN_LM_LOSS_TOL
SSM_TRAIN_PARITY_CUTS = ((HYBRID_ARCH, "attn_every", ("int8", "emulate")),
                         (SSM_ARCH, 2, ("int8",)))


def _lm_batch(torch, cfg, dev, batch=TRAIN_LM_BATCH, seq=TRAIN_LM_SEQ):
    import numpy as np

    from repro_torch.data import SyntheticLMDataset

    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
            for k, v in SyntheticLMDataset(cfg.vocab_size, seq, batch,
                                           seed=0).batch_at(0).items()}


def train_ssm_run(torch, dev, arch, backend, launches, cfg=None,
                  phase="train_ssm"):
    """TRAIN_SSM_STEPS steps of ``arch`` (``cfg`` when given, a depth cut
    of it) from seed-0 params on one batch: every loss finite, the mean of
    the last 2 below that of the first 2, exactly ``launches`` each step;
    the timed ms/step, tokens/s, peak memory, the last aux and a profile
    of TRAIN_SSM_PROFILE steps."""
    from repro_torch import kernels as K
    from repro_torch.configs import get_config
    from repro_torch.core import default_bits, init_train_state
    from repro_torch.models import lm
    from repro_torch.optim import Hyper

    cfg = cfg or get_config(arch)
    batch, bits = _lm_batch(torch, cfg, dev), default_bits(cfg)
    t_run = time.perf_counter()
    torch.cuda.reset_peak_memory_stats(dev)
    params = lm.init_params(cfg, seed=0, device=dev)
    step, ocfg = _lm_step(torch, cfg, backend, dev)
    state = init_train_state(params, ocfg)
    losses, secs, per_step = [], [], []
    for i in range(TRAIN_SSM_STEPS):
        torch.cuda.synchronize()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        params, state, m = step(params, state, batch,
                                Hyper(lr=TRAIN_LM_LR, step=i), bits)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        per_step.append(K.launch_counts())
        losses.append(float(m["loss"]))
    n = TRAIN_SSM_WARM
    first, last = sum(losses[:n]) / n, sum(losses[-n:]) / n
    ms = 1e3 * statistics.median(secs[TRAIN_SSM_WARM:])
    label = f"{phase} {arch} {backend}"
    rec = dict(run=f"{phase}/{arch}/{backend}", arch=arch,
               layers=cfg.num_layers, backend=backend, steps=TRAIN_SSM_STEPS,
               counts={k: sum(c[k] for c in per_step) for k in launches},
               ms_per_step=ms, ms_per_step_timed=[1e3 * t for t in secs],
               tokens_per_s=TRAIN_LM_BATCH * TRAIN_LM_SEQ / (ms / 1e3),
               losses=losses, loss_first=first, loss_last=last,
               aux_last=float(m["aux"]),
               grad_norm_last=float(m["grad_norm"]),
               peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 2**30)
    say(f"{label} ({cfg.num_layers} layers): {ms:.2f} ms/step (median "
        f"after {TRAIN_SSM_WARM} warm-up), {rec['tokens_per_s']:.0f} "
        f"tokens/s, losses {[round(v, 4) for v in losses]} (first {n} "
        f"{first:.4f}, last {n} {last:.4f}), aux {rec['aux_last']:.6f}, "
        f"peak memory {rec['peak_mem_gb']:.2f} GiB, launches a step "
        f"{per_step[0]}")
    require(all(math.isfinite(v) for v in losses),
            f"{label}: a loss is not finite: {losses}")
    for i, c in enumerate(per_step):
        require(c == launches, f"{label}: step {i} launched {c}, expected "
                               f"{launches}")
    require(last < first, f"{label}: mean loss of the first {n} steps "
                          f"{first:.4f}, of the last {n} {last:.4f}: no "
                          "descent")
    t_prof = time.perf_counter()
    rec["profile"] = profile_steps(
        torch, lambda: step(params, state, batch,
                            Hyper(lr=TRAIN_LM_LR, step=0), bits),
        label, backend, dev, cpu_ops=False, steps=TRAIN_SSM_PROFILE,
        wall_ms=ms)
    say(f"{label}: {t_prof - t_run:.1f} s to train, "
        f"{time.perf_counter() - t_prof:.1f} s to profile")
    del params, state, step
    torch.cuda.empty_cache()
    return rec


def train_ssm_stochastic(torch, dev, arch=HYBRID_ARCH,
                         launches=HYBRID_TRAIN_LAUNCHES, cfg=None,
                         phase="train_ssm"):
    """``arch``'s (zamba2-2.7b's; ``cfg`` when given) int8 step with
    stochastic rounding under the JAX driver's keys, TRAIN_SSM_STOCH_STEPS
    steps twice from seed-0 params: ``launches`` a step, every loss
    finite, and the second run's params bitwise the first's (compared on
    the card)."""
    from repro_torch import kernels as K
    from repro_torch.configs import get_config
    from repro_torch.core import default_bits, init_train_state
    from repro_torch.models import lm
    from repro_torch.optim import Hyper
    from repro_torch.util.tree import tree_leaves

    cfg = cfg or get_config(arch)
    batch, bits = _lm_batch(torch, cfg, dev), default_bits(cfg)
    step, ocfg = _lm_step(torch, cfg, "int8", dev, stochastic=True)
    finals, total, counts = [], {}, []
    for _ in range(2):
        params = lm.init_params(cfg, seed=0, device=dev)
        state = init_train_state(params, ocfg)
        losses = []
        for i in range(TRAIN_SSM_STOCH_STEPS):
            torch.cuda.synchronize()
            K.reset_launch_counts()
            params, state, m = step(params, state, batch,
                                    Hyper(lr=TRAIN_LM_LR, step=i), bits,
                                    _step_key(i))
            torch.cuda.synchronize()
            counts.append(K.launch_counts())
            total = {k: total.get(k, 0) + v for k, v in counts[-1].items()}
            losses.append(float(m["loss"]))
        del state
        finals.append((tree_leaves(params), losses))
        del params
    (a, loss_a), (b, loss_b) = finals
    differ = sum(not _same_bits(torch, x, y) for x, y in zip(a, b))
    say(f"{phase} {arch} int8 stochastic: {TRAIN_SSM_STOCH_STEPS} "
        f"steps twice, losses {loss_a} and {loss_b}; {differ} of {len(a)} "
        f"leaves differ; launches a step {counts[0]}")
    require(all(c == launches for c in counts),
            f"{phase} stochastic: launches {counts}, expected "
            f"{launches} a step")
    require(all(math.isfinite(v) for v in loss_a),
            f"{phase} stochastic: losses {loss_a}")
    require(differ == 0 and loss_a == loss_b,
            f"{phase} stochastic: two runs from the same params and keys "
            f"differ in {differ} of {len(a)} leaves, losses {loss_a} vs "
            f"{loss_b}")
    n_leaves = len(a)
    del finals, a, b, step
    torch.cuda.empty_cache()
    return dict(run=f"{phase}/{arch}/int8/stochastic",
                backend="int8", counts=total, losses=loss_a,
                bitwise_leaves=n_leaves)


def train_ssm_driver(torch, dev):
    """``launch.train.main`` in-process on full-width zamba2-2.7b with
    --quantize --stochastic, int8, TRAIN_SSM_DRIVER_STEPS steps and no
    checkpoint directory (one checkpoint would be 18.8 GB): exactly
    HYBRID_TRAIN_LAUNCHES a step and every loss finite."""
    from repro_torch import kernels as K
    from repro_torch.launch import train

    argv = ["--arch", HYBRID_ARCH, "--device", "cuda", "--quantize",
            "--stochastic", "--kernel-backend", "int8", "--steps",
            str(TRAIN_SSM_DRIVER_STEPS), "--seq-len", str(TRAIN_LM_SEQ),
            "--global-batch", str(TRAIN_LM_BATCH), "--log-every", "1",
            "--deadline-s", str(DRIVER_DEADLINE_S)]
    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    losses = train.main(argv)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = K.launch_counts()
    want = {k: v * TRAIN_SSM_DRIVER_STEPS
            for k, v in HYBRID_TRAIN_LAUNCHES.items()}
    say(f"train_ssm driver {HYBRID_ARCH}: {TRAIN_SSM_DRIVER_STEPS} steps in "
        f"{secs:.1f} s (with its init), losses {losses}, launches {counts}")
    require(counts == want, f"train_ssm driver: launches {counts}, "
                            f"expected {want}")
    require(len(losses) == TRAIN_SSM_DRIVER_STEPS
            and all(math.isfinite(v) for v in losses),
            f"train_ssm driver: losses {losses}")
    torch.cuda.empty_cache()
    return dict(run=f"train_ssm/{HYBRID_ARCH}/driver", backend="int8",
                counts=counts, losses=losses, seconds=secs)


def _update_rel(ref, got, p0):
    """The relative L2 of the update, |got - ref| / |ref - p0| over every
    leaf together, and {leaf: the same of that leaf} (0 where both of its
    updates are 0)."""
    from repro_torch.util.tree import tree_leaves_with_path

    rel, num2, den2 = {}, 0.0, 0.0
    for (k, r), (_, g), (_, w) in zip(*map(tree_leaves_with_path,
                                           (ref, got, p0))):
        require(g.shape == r.shape and bool(g.isfinite().all()),
                f"{k}: not finite or misshapen")
        num, den = float((g - r).norm()), float((r - w).norm())
        num2, den2 = num2 + num ** 2, den2 + den ** 2
        rel[k] = num / den if den else (0.0 if num == 0 else math.inf)
    return math.sqrt(num2 / den2), rel


def _update_readings(ref, got, p0):
    """The update's relative L2 three ways: (whole, largest leaf other than
    SSM_TRAIN_VECTORS, largest of SSM_TRAIN_VECTORS), each a (value, leaf)
    pair, and {leaf: reading}."""
    whole, rel = _update_rel(ref, got, p0)
    vec = {k: v for k, v in rel.items() if k in SSM_TRAIN_VECTORS}
    other = {k: v for k, v in rel.items() if k not in SSM_TRAIN_VECTORS}
    worst = [(whole, "whole")] + [
        (d[k], k) for d in (other, vec) for k in [max(d, key=d.get)]]
    return tuple(worst), rel


def train_ssm_parity(torch, dev):
    """One step of each SSM_TRAIN_PARITY_CUTS cut on the card and on the
    CPU (plain versions) from the same params and batch: the relative L2
    of the update within SSM_TRAIN_PARITY_TOL (whole), SSM_TRAIN_LEAF_TOL
    (each other leaf) and SSM_TRAIN_VECTOR_TOL (A_log, dt_bias), and the
    loss within SSM_TRAIN_LOSS_TOL; the hybrid's card step launches one
    group's kernels, and the dropped-K controls read beyond the limits."""
    import dataclasses

    from repro_torch import kernels as K
    from repro_torch.configs import get_config
    from repro_torch.core import default_bits, init_train_state
    from repro_torch.kernels import ops as kops
    from repro_torch.models import lm
    from repro_torch.optim import Hyper

    out, gates = [], []
    for arch, layers, backends in SSM_TRAIN_PARITY_CUTS:
        full = get_config(arch)
        cfg = dataclasses.replace(full, num_layers=(
            full.attn_every if layers == "attn_every" else layers))
        hybrid = cfg.family == "hybrid"
        batch = _lm_batch(torch, cfg, "cpu", SSM_TRAIN_PARITY_BATCH,
                          SSM_TRAIN_PARITY_SEQ)
        bits = default_bits(cfg)
        want = ({k: v // lm.hybrid_groups(full)[0]
                 for k, v in HYBRID_TRAIN_LAUNCHES.items()} if hybrid
                else SSM_LAUNCHES)
        for backend in backends:
            params = lm.init_params(cfg, seed=0, device=dev)
            params_cpu = _tree_cpu(params)

            def run(p, d):
                step, ocfg = _lm_step(torch, cfg, backend, d)
                K.reset_launch_counts()
                t0 = time.perf_counter()
                new, _, m = step(p, init_train_state(p, ocfg), batch,
                                 Hyper(lr=TRAIN_LM_LR, step=0), bits)
                loss = float(m["loss"])
                return (_tree_cpu(new), loss, time.perf_counter() - t0,
                        K.launch_counts())

            got, got_loss, t_card, counts = run(params, dev)
            ref, ref_loss, t_cpu, _ = run(params_cpu, "cpu")
            reads, rel = _update_readings(ref, got, params_cpu)
            loss_rel = abs(got_loss - ref_loss) / abs(ref_loss)
            ctrl = {}
            for name, cut in (SSM_FAULTS if hybrid else ()):
                undo = _dropped_k(kops, cfg.d_ff, cut)
                try:
                    bad = run(params, dev)[0]
                finally:
                    undo()
                ctrl[name] = _update_readings(ref, bad, params_cpu)[0]
            tols = (SSM_TRAIN_PARITY_TOL[backend], SSM_TRAIN_LEAF_TOL[backend],
                    SSM_TRAIN_VECTOR_TOL)
            label = (f"train_ssm parity {arch} {cfg.num_layers} layers "
                     f"{backend}")

            def show(r):
                return "; ".join(f"{k if k == 'whole' else 'leaf ' + k} "
                                 f"{v:.4g}" for v, k in r)
            say(f"{label}: update |d|/|ref| {show(reads)} (tol whole, other "
                f"leaves, vectors {tols}); median leaf "
                f"{statistics.median(rel.values()):.4g}; loss "
                f"{got_loss:.6f} vs {ref_loss:.6f}, rel {loss_rel:.3g} (tol "
                f"{SSM_TRAIN_LOSS_TOL}); controls "
                + (", ".join(f"{n}: {show(v)}" for n, v in ctrl.items())
                   or "none")
                + f"; launches {counts}; card {t_card:.2f} s, cpu "
                f"{t_cpu:.2f} s")
            gates += [(counts == want, f"{label}: launches {counts}, "
                                       f"expected {want}"),
                      (loss_rel <= SSM_TRAIN_LOSS_TOL,
                       f"{label}: loss rel {loss_rel} > "
                       f"{SSM_TRAIN_LOSS_TOL}")]
            gates += [(v <= tol, f"{label}: update |d|/|ref| {v} ({k}) > "
                                 f"{tol}")
                      for (v, k), tol in zip(reads, tols)]
            # each control beyond the whole and the leaf limits, the
            # larger control beyond the vectors' limit
            for i, what in enumerate(("whole", "leaf", "vectors")):
                seen = [(n, v[i][0]) for n, v in ctrl.items()]
                for n, v in (seen if i < 2 or not seen
                             else [max(seen, key=lambda c: c[1])]):
                    gates.append((v > tols[i], f"{label}: the control ({n}) "
                                  f"reads {v} <= the {what} limit "
                                  f"{tols[i]}, so the limit cannot see it"))
            out.append(dict(arch=arch, layers=cfg.num_layers,
                            backend=backend, update_rel_l2_err=reads[0][0],
                            update_rel_l2_err_leaf_max=list(reads[1]),
                            update_rel_l2_err_vector_max=list(reads[2]),
                            update_rel_l2_err_by_leaf=rel, tol=tols[0],
                            leaf_tol=tols[1], vector_tol=tols[2],
                            loss_rel_err=loss_rel,
                            loss_tol=SSM_TRAIN_LOSS_TOL,
                            controls={n: [r[0] for r in v]
                                      for n, v in ctrl.items()},
                            card_s=t_card, cpu_s=t_cpu))
            del params, params_cpu, got, ref
            torch.cuda.empty_cache()
    for ok, msg in gates:         # after every reading is printed
        require(ok, msg)
    return out


def train_ssm(torch, dev):
    """Phase train_ssm: the full-width runs, the stochastic pair, the
    driver, then the parity checks."""
    t0 = time.perf_counter()
    import dataclasses

    from repro_torch.configs import get_config

    runs = [train_ssm_run(torch, dev, arch, backend, launches,
                          cfg=None if layers is None else dataclasses.replace(
                              get_config(arch), num_layers=layers))
            for arch, backend, launches, layers in TRAIN_SSM_RUNS]
    runs.append(train_ssm_stochastic(torch, dev))
    runs.append(train_ssm_driver(torch, dev))
    parity = train_ssm_parity(torch, dev)
    secs = time.perf_counter() - t0
    say(f"train_ssm: {secs:.1f} s")
    return runs, parity, secs


# ---------------------------------------------------------------------------
# phase 5f: the moe family and sliding-window decode (mixtral-8x7b)
# ---------------------------------------------------------------------------

# mixtral-8x7b (configs/mixtral_8x7b.py, arXiv 2401.04088: d 4096, 32 heads
# and 8 KV heads of 128, 8 experts of 14336, top-2, a window of 4096, vocab
# 32000) at its full width, f32 masters from seed 0, bf16 compute, cut in
# depth only (its 32 f32 layers are 186 GB).  Its attention runs on the
# kernels (q, k, v and o through the dense unit, the fused decode
# prologue); its router and experts are plain products, as the JAX package
# computes them outside any Pallas kernel.  A prefill runs q, k, v and o on
# fxp_matmul, 4 a layer; a decode step the prologue, one a layer, and the
# tail's o-projection and the experts as products; a train step the four
# projections in the forward and in the re-linearisation, with one dx and
# one dW each in the backward
MOE_ARCH = "mixtral-8x7b"
MOE_SERVE_LAYERS, MOE_TRAIN_LAYERS = 4, 2
MOE_PREFILL_LAUNCHES = dict(CONT_PREFILL_LAUNCHES,
                            fxp_matmul=4 * MOE_SERVE_LAYERS)
MOE_DECODE_LAUNCHES = dict(CONT_PREFILL_LAUNCHES, fxp_matmul=0,
                           decode_prologue=MOE_SERVE_LAYERS)
MOE_TRAIN_LAUNCHES = dict(CONT_PREFILL_LAUNCHES,
                          fxp_matmul=2 * 4 * MOE_TRAIN_LAYERS,
                          bp_gstep=4 * MOE_TRAIN_LAYERS,
                          sgd_dw_update=4 * MOE_TRAIN_LAYERS)
MOE_TRAIN_BACKENDS = ("int8", "emulate")
# the serve parity: mixtral cut to one layer and its window to
# MOE_PARITY_WINDOW, so that the ring of a MOE_PARITY_PROMPT-token prompt
# wraps in the prefill and again as it decodes; MOE_PARITY_SLOTS rows, a
# prefill and MOE_PARITY_STEPS decode steps on the card and on the CPU
# from the same weights and tokens (the CPU decodes the card's argmax
# tokens), under each backend.  The logits' relative L2, the largest over
# the prefill and the decode steps, lies within MOE_PARITY_TOL; the share
# of (token, k) routing picks that differ between the two devices is
# printed.  The controls, the card's run again with the last quarter of
# K zeroed where K is d_model (q, k, v and o of the prefill:
# ``_dropped_k``) and with the routing weights left un-renormalised, must
# read beyond it.  Sound runs read 0.0039 (int8) and 0.0071 (emulate, 3
# of 304 picks differing), the controls 1.18 and 0.32 on both backends
# (PERF.md; H100 80GB HBM3, 700 W): the limit, 0.05, is seven
# times the larger sound reading and a sixth of the finer control
MOE_PARITY_WINDOW, MOE_PARITY_PROMPT = 64, 72
MOE_PARITY_SLOTS, MOE_PARITY_STEPS = 2, 4
MOE_PARITY_TOL = {"int8": 0.05, "emulate": 0.05}
MOE_FAULT_SPLITS = 4    # the dropped-K control zeroes the last quarter
# the train parity: one step of mixtral cut to one layer, batch
# MOE_TRAIN_PARITY_BATCH x MOE_TRAIN_PARITY_SEQ, card against CPU (int8):
# the update's relative L2 as a whole (train_lm's limit), of each leaf but
# the router (train_ssm's leaf limit) and of the router on its own (its
# gradient reaches it through the routing probabilities and changes with
# every pick that flips between the devices; it is held to the leaf
# limit); the dropped-K control beyond all three.  Sound runs read 0.0170
# whole, 0.0248 the largest other leaf (attn/wq) and 0.0032 the router;
# the control 1.29, 1.38 and 1.41 (PERF.md; H100 80GB HBM3, 700
# W); on the CPU alone one f32 ulp on every master moves them by at most
# half the limits (tests/test_torch_engine_moe.py::
# test_update_sensitivity_justifies_moe_card_tolerance).  The CPU side
# holds the layer, the embedding and the head (1.58 B f32 masters) with
# momentum: it runs with plain SGD instead when the host has less than
# MOE_TRAIN_PARITY_MIN_FREE_GB free
MOE_TRAIN_PARITY_BATCH, MOE_TRAIN_PARITY_SEQ = 2, 32
MOE_TRAIN_PARITY_BACKEND = "int8"
MOE_TRAIN_PARITY_TOL = dict(TRAIN_LM_PARITY_TOL)
MOE_TRAIN_LEAF_TOL = dict(SSM_TRAIN_LEAF_TOL)
MOE_ROUTER_TOL = MOE_TRAIN_LEAF_TOL
MOE_ROUTER_LEAF = "blocks/moe/router"
MOE_TRAIN_PARITY_MIN_FREE_GB = 64.0
# phase 3 at mixtral's attention (d 4096, 32 heads and 8 KV heads of 128):
# the dense units of its train step (T = TRAIN_LM_BATCH x TRAIN_LM_SEQ),
# q and o 4096 x 4096, k and v 4096 x 1024 (the o-projection takes W cast
# to the compute dtype)
MIXTRAL_D, MIXTRAL_KV = 4096, 8 * 128
MIXTRAL_ENGINE_UNITS = (("mixtral_q", MIXTRAL_D, MIXTRAL_D, "float32"),
                        ("mixtral_kv", MIXTRAL_D, MIXTRAL_KV, "float32"),
                        ("mixtral_o", MIXTRAL_D, MIXTRAL_D, "bfloat16"))


def _moe_cfg(full, layers, window=None):
    """``full`` cut to ``layers`` layers (and its window to ``window``)."""
    import dataclasses

    cfg = dataclasses.replace(full, num_layers=layers)
    if window is not None:
        cfg = dataclasses.replace(cfg, swa_window=window)
    return cfg


def _n_params(tree) -> int:
    from repro_torch.util.tree import tree_leaves

    return sum(t.numel() for t in tree_leaves(tree))


def _describe_moe(cfg, full) -> str:
    return (f"{MOE_ARCH} at full width (d {cfg.d_model}, {cfg.num_experts} "
            f"experts of {cfg.moe_d_ff}, top-{cfg.experts_per_token}, "
            f"{cfg.num_heads} heads and {cfg.num_kv_heads} KV heads of "
            f"{cfg.head_dim}, vocab {cfg.vocab_size}, window "
            f"{cfg.swa_window}), reduced to {cfg.num_layers} of "
            f"{full.num_layers} layers")


def moe_serve(torch, dev):
    """The scheduler (contiguous mode) on mixtral cut to MOE_SERVE_LAYERS
    layers, through the engine's hooks (``EngineHooks.for_model``, as the
    serve CLI builds them; the CLI has no depth flag): B prompts of
    CONT_PROMPT tokens, CONT_NEW new, bf16 KV, the int8 backend; every
    request finishes and the serve launches exactly B prefills' and its
    decode steps' kernels.  Then the engine's own entry points
    (``_engine_serve_checks``)."""
    from repro_torch import kernels as K
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.serving import (BatchScheduler, EngineHooks, Request,
                                     ServeConfig)

    full = get_config(MOE_ARCH)
    cfg = _moe_cfg(full, MOE_SERVE_LAYERS)
    t0 = time.perf_counter()
    params = lm.init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    n = _n_params(params)
    say(f"moe serve: {_describe_moe(cfg, full)}: {n / 1e9:.3f} B f32 "
        f"masters ({4 * n / 1e9:.1f} GB), drawn in "
        f"{time.perf_counter() - t0:.1f} s")
    serve = ServeConfig(num_slots=B, eos_id=None, max_len=CONT_MAX_LEN,
                        mode="contiguous", cache_dtype="bfloat16",
                        kernel_backend="int8")
    hooks = EngineHooks.for_model(params, cfg, serve)
    inner, decode_s = hooks.decode, [0.0]

    def timed_decode(*a):
        t = time.perf_counter()
        out = inner(*a)
        torch.cuda.synchronize()
        decode_s[0] += time.perf_counter() - t
        return out
    hooks.decode = timed_decode
    sched = BatchScheduler(serve, hooks)
    reqs = [Request(uid=i, prompt=p, max_new_tokens=CONT_NEW)
            for i, p in enumerate(_cont_prompts(torch, cfg))]
    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    for r in reqs:
        sched.submit(r)
    sched.run_until_drained()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts, steps = K.launch_counts(), sched.steps_run
    tokens = sum(len(r.generated) for r in reqs)
    require(all(r.done and len(r.generated) == CONT_NEW for r in reqs),
            f"moe serve: {sum(r.done for r in reqs)}/{B} finished, "
            f"{[len(r.generated) for r in reqs]} tokens")
    want = {k: B * MOE_PREFILL_LAUNCHES[k] + steps * MOE_DECODE_LAUNCHES[k]
            for k in counts}
    require(steps == CONT_NEW - 1 and counts == want,
            f"moe serve: {steps} decode steps, launches {counts}, expected "
            f"{want}")
    rec = dict(run=f"moe/serve/{MOE_ARCH}/int8/bfloat16", arch=MOE_ARCH,
               layers=cfg.num_layers, params=n, backend="int8",
               cache="bfloat16", counts=counts, tokens=tokens, seconds=secs,
               tokens_per_s=tokens / secs, decode_steps=steps,
               ms_per_decode_step=1e3 * decode_s[0] / max(steps, 1))
    say(f"moe serve {MOE_ARCH} ({cfg.num_layers} layers) contiguous "
        f"int8/bfloat16: {tokens} tokens in {secs:.2f} s = "
        f"{rec['tokens_per_s']:.1f} tok/s, {steps} decode steps at "
        f"{rec['ms_per_decode_step']:.2f} ms/step, launches {counts}")
    del sched, hooks
    _engine_serve_checks(torch, dev, MOE_ARCH, cfg, params,
                         MOE_PREFILL_LAUNCHES, MOE_DECODE_LAUNCHES, rec)
    del params
    torch.cuda.empty_cache()
    return rec


def _route_recorder(L):
    """Wrap ``L.moe_route`` so that each call's top_e lands on the host;
    returns (the records, the undo)."""
    real, seen = L.moe_route, []

    def recording(params, x, cfg):
        r = real(params, x, cfg)
        seen.append(r["top_e"].reshape(-1, r["top_e"].shape[-1]).cpu())
        return r
    L.moe_route = recording
    return seen, lambda: setattr(L, "moe_route", real)


def _route_replayer(torch, L, picks):
    """Install into ``L`` a ``moe_route`` whose i-th call takes the i-th
    of ``picks`` (top_e as ``_route_recorder`` records it, on any device)
    for its top-k, its probabilities and all else its own; returns the
    undo."""
    real_route, real_top_k, calls = L.moe_route, L.top_k_lower_first, []

    def replaying(params, x, cfg):
        e = picks[len(calls)].to(x.device).reshape(*x.shape[:2], -1)
        calls.append(e)
        L.top_k_lower_first = lambda probs, k: (
            torch.gather(probs, -1, e), e)
        try:
            return real_route(params, x, cfg)
        finally:
            L.top_k_lower_first = real_top_k
    L.moe_route = replaying

    def undo():
        L.moe_route = real_route
        require(len(calls) == len(picks), f"route replay: {len(calls)} "
                f"calls for {len(picks)} recorded")
    return undo


def _unnormalised_routes(torch, L):
    """Install into ``L`` a ``moe_route`` whose sorted routing weights are
    the raw top-k probabilities, not renormalised to sum to 1 (a fault
    control); returns the undo."""
    real = L.moe_route

    def faulty(params, x, cfg):
        r = real(params, x, cfg)
        raw = torch.gather(r["probs"], -1, r["top_e"]).reshape(x.shape[0], -1)
        r["sw"] = torch.gather(raw.to(x.dtype), -1, r["order"])
        return r
    L.moe_route = faulty
    return lambda: setattr(L, "moe_route", real)


def _moe_parity_side(torch, p, cfg, toks, backend, d, feed,
                     steps=MOE_PARITY_STEPS, cache_dtype=None):
    """A prefill of ``toks`` and ``steps`` decode steps on ``d`` under
    ``backend`` (a bf16 cache unless ``cache_dtype`` names another),
    decoding ``feed`` (the card's argmax tokens) when given, else this
    side's own.  Returns (the logits of the prefill and of each
    step, on the host; the tokens fed; every routing pick, [token, k]; the
    launches of the prefill and of the steps)."""
    from repro_torch import kernels as K
    from repro_torch.kernels import ops as kops
    from repro_torch.models import layers as L
    from repro_torch.serving import engine as E

    seen, undo = _route_recorder(L)
    own, feed = feed is None, list(feed or [])
    try:
        K.reset_launch_counts()
        logits, state = E.prefill(p, cfg, {"tokens": torch.from_numpy(toks)},
                                  toks.shape[1] + steps,
                                  cache_dtype or torch.bfloat16,
                                  kernel_backend=backend)
        outs, pre = [logits.cpu()], K.launch_counts()
        K.reset_launch_counts()
        with kops.kernel_backend_ctx(backend, d):
            for i in range(steps):
                if own:
                    feed.append(torch.argmax(outs[-1], dim=-1)[:, None]
                                .to(torch.int32))
                logits, state = E.decode_step(p, cfg, state, feed[i].to(d))
                outs.append(logits.cpu())
        dec = K.launch_counts()
    finally:
        undo()
    return outs, feed, torch.cat(seen), (pre, dec)


def _logit_rel(got, ref) -> float:
    """The largest relative L2 over the prefill's and the steps' logits."""
    return max(float((g - r).norm() / r.norm()) for g, r in zip(got, ref))


def moe_serve_parity(torch, dev):
    """Mixtral cut to one layer and its window to MOE_PARITY_WINDOW on the
    card and on the CPU (``_moe_parity_side``) under each backend: the
    logits within MOE_PARITY_TOL, the routing picks compared, the card's
    launches exactly one layer's, and each fault control beyond the
    limit."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops as kops
    from repro_torch.models import layers as L
    from repro_torch.models import lm

    full = get_config(MOE_ARCH)
    cfg = _moe_cfg(full, 1, window=MOE_PARITY_WINDOW)
    params = lm.init_params(cfg, seed=2, device=dev)
    params_cpu = _tree_cpu(params)
    toks = np.random.default_rng(14).integers(
        0, cfg.vocab_size, (MOE_PARITY_SLOTS, MOE_PARITY_PROMPT)).astype(
        np.int32)
    per_pre = {k: v // MOE_SERVE_LAYERS
               for k, v in MOE_PREFILL_LAUNCHES.items()}
    per_dec = {k: MOE_PARITY_STEPS * v // MOE_SERVE_LAYERS
               for k, v in MOE_DECODE_LAUNCHES.items()}
    say(f"moe serve parity: {_describe_moe(cfg, full)}, window cut to "
        f"{MOE_PARITY_WINDOW} (reduced) so that the ring wraps: "
        f"{MOE_PARITY_SLOTS} rows of {MOE_PARITY_PROMPT} prompt tokens, "
        f"{MOE_PARITY_STEPS} decode steps")
    out, gates = [], []
    for backend in ("int8", "emulate"):
        tol = MOE_PARITY_TOL[backend]
        t0 = time.perf_counter()
        card = _moe_parity_side(torch, params, cfg, toks, backend, dev, None)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        cpu = _moe_parity_side(torch, params_cpu, cfg, toks, backend, "cpu",
                               card[1])
        cpu_s = time.perf_counter() - t0
        undo = _dropped_k(kops, cfg.d_model,
                          cfg.d_model // MOE_FAULT_SPLITS)
        try:
            dropped = _moe_parity_side(torch, params, cfg, toks, backend,
                                       dev, card[1])
        finally:
            undo()
        undo = _unnormalised_routes(torch, L)
        try:
            unnorm = _moe_parity_side(torch, params, cfg, toks, backend, dev,
                                      card[1])
        finally:
            undo()
        for o in card[0]:
            require(tuple(o.shape) == (MOE_PARITY_SLOTS, cfg.vocab_size)
                    and bool(o.isfinite().all()),
                    f"moe parity {backend}: logits {tuple(o.shape)} not "
                    "finite or of the wrong shape")
        rel = _logit_rel(card[0], cpu[0])
        steps_rel = [float((g - r).norm() / r.norm())
                     for g, r in zip(card[0], cpu[0])]
        ctrl = {"dropped K split": _logit_rel(dropped[0], cpu[0]),
                "un-renormalised routing": _logit_rel(unnorm[0], cpu[0])}
        picks = card[2].shape[0] * card[2].shape[1]
        differ = int((card[2] != cpu[2]).sum())
        agree = float(np.mean([float((g.argmax(-1) == r.argmax(-1))
                                     .float().mean())
                               for g, r in zip(card[0], cpu[0])]))
        rec = dict(backend=backend, tol=f"|d|/|ref| <= {tol}",
                   rel_l2_err=rel, rel_l2_err_by_step=steps_rel,
                   argmax_agreement=agree, picks=picks, picks_differ=differ,
                   picks_differ_share=differ / picks, controls=ctrl,
                   launches=card[3], card_s=card_s, cpu_s=cpu_s)
        say(f"moe parity {backend}: |d|/|ref| {rel:.4g} (prefill, then "
            f"each step: {', '.join(f'{v:.4g}' for v in steps_rel)}; tol "
            f"{tol}), argmax agreement {agree:.3f}, routing picks differ "
            f"{differ} of {picks} ({differ / picks:.4f}); controls "
            + ", ".join(f"{k} {v:.4g}" for k, v in ctrl.items())
            + f"; launches {card[3]}; card {card_s:.2f} s, CPU "
            f"{cpu_s:.2f} s")
        gates.append((card[3] == (per_pre, per_dec),
                      f"moe parity {backend}: card launches {card[3]}, "
                      f"expected {per_pre} and {per_dec}"))
        gates.append((rel <= tol, f"moe parity {backend}: |d|/|ref| {rel} > "
                                  f"{tol}"))
        gates += [(v > tol, f"moe parity {backend}: the control ({k}) reads "
                            f"{v} <= {tol}, so the limit cannot see it")
                  for k, v in ctrl.items()]
        out.append(rec)
    for ok, msg in gates:         # after every reading is printed
        require(ok, msg)
    del params, params_cpu
    torch.cuda.empty_cache()
    return out


def _host_free_gb() -> float:
    """MemAvailable of the host, in GB (0 where /proc/meminfo is
    unreadable)."""
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    return int(line.split()[1]) * 1024 / 1e9
    except OSError:
        pass
    return 0.0


def moe_train_parity(torch, dev):
    """One step of mixtral cut to one layer on the card and on the CPU
    (plain versions) from the same params and batch: the update's relative
    L2 within MOE_TRAIN_PARITY_TOL (whole), MOE_TRAIN_LEAF_TOL (each leaf
    but the router) and MOE_ROUTER_TOL (the router), the loss within
    TRAIN_LM_LOSS_TOL; the card's launches one layer's; the dropped-K
    control beyond the three limits."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops as kops

    full = get_config(MOE_ARCH)
    cfg = _moe_cfg(full, 1)
    backend = MOE_TRAIN_PARITY_BACKEND
    return _router_train_parity(
        torch, dev, arch=MOE_ARCH, cfg=cfg, label=f"moe train parity "
        f"{backend}", describe=_describe_moe(cfg, full), backend=backend,
        shape=(MOE_TRAIN_PARITY_BATCH, MOE_TRAIN_PARITY_SEQ),
        want={k: v // MOE_TRAIN_LAYERS for k, v in MOE_TRAIN_LAUNCHES.items()},
        tols=(MOE_TRAIN_PARITY_TOL[backend], MOE_TRAIN_LEAF_TOL[backend],
              MOE_ROUTER_TOL[backend]),
        min_free_gb=MOE_TRAIN_PARITY_MIN_FREE_GB,
        control=("dropped K split", lambda: _dropped_k(
            kops, cfg.d_model, cfg.d_model // MOE_FAULT_SPLITS)))


def _router_train_parity(torch, dev, *, arch, cfg, label, describe, backend,
                         shape, want, tols, min_free_gb, control,
                         replayed_tol=None):
    """One step of ``cfg`` (a moe model cut to one layer) on the card and
    on the CPU (plain versions) from the same seed-0 params and a batch of
    ``shape``: the routing picks that differ counted, the update's
    relative L2 within ``tols`` (whole, each leaf but the router, the
    router), the loss within TRAIN_LM_LOSS_TOL, the card's launches
    ``want``; the card's step again under ``control`` (its name and an
    installer that returns the undo) beyond the three limits.  Given
    ``replayed_tol``, the card's step again with the CPU's picks replayed
    (``_route_replayer``): its whole update within ``replayed_tol``,
    which the control exceeds.  The CPU side runs with plain SGD when the
    host has less than ``min_free_gb`` free."""
    from repro_torch import kernels as K
    from repro_torch.core import default_bits, init_train_state
    from repro_torch.models import layers as L
    from repro_torch.models import lm
    from repro_torch.optim import Hyper

    batch = _lm_batch(torch, cfg, "cpu", *shape)
    bits = default_bits(cfg)
    free_gb = _host_free_gb()
    opt = TRAIN_LM_OPTIMIZER if free_gb >= min_free_gb else "sgd"
    params = lm.init_params(cfg, seed=0, device=dev)
    params_cpu = _tree_cpu(params)
    say(f"{label}: {describe}, {_n_params(params) / 1e9:.3f} B masters, "
        f"batch {shape[0]} x {shape[1]}; host {free_gb:.1f} GB free, so "
        f"the optimizer is {opt}"
        + ("" if opt == TRAIN_LM_OPTIMIZER else
           f" (plain SGD: under {min_free_gb} GB free)"))

    def run(p, d):
        step, ocfg = _lm_step(torch, cfg, backend, d, optimizer=opt)
        K.reset_launch_counts()
        t0 = time.perf_counter()
        new, _, m = step(p, init_train_state(p, ocfg), batch,
                         Hyper(lr=TRAIN_LM_LR, step=0), bits)
        res = (_tree_cpu(new), float(m["loss"]), float(m["aux"]),
               time.perf_counter() - t0, K.launch_counts())
        del new
        return res

    def recorded(p, d):
        seen, undo = _route_recorder(L)
        try:
            return run(p, d), seen
        finally:
            undo()
    (got, got_loss, got_aux, t_card, counts), card_picks = recorded(params,
                                                                    dev)
    (ref, ref_loss, ref_aux, t_cpu, _), cpu_picks = recorded(params_cpu,
                                                             "cpu")
    require(len(card_picks) == len(cpu_picks),
            f"{label}: {len(card_picks)} routings on the card, "
            f"{len(cpu_picks)} on the CPU")
    picks = sum(e.numel() for e in cpu_picks)
    differ = sum(int((g != r).sum()) for g, r in zip(card_picks, cpu_picks))
    control_name, install = control
    undo = install()
    try:
        bad = run(params, dev)[0]
    finally:
        undo()
    replayed = None
    if replayed_tol is not None:
        undo = _route_replayer(torch, L, cpu_picks)
        try:
            replayed = run(params, dev)[0]
        finally:
            undo()

    def readings(new):
        whole, rel = _update_rel(ref, new, params_cpu)
        others = {k: v for k, v in rel.items() if k != MOE_ROUTER_LEAF}
        leaf = max(others, key=others.get)
        return (whole, (others[leaf], leaf), rel[MOE_ROUTER_LEAF]), rel
    (whole, (leaf_v, leaf), router), rel = readings(got)
    (c_whole, (c_leaf_v, c_leaf), c_router), _ = readings(bad)
    del bad
    if replayed is not None:
        (r_whole, (r_leaf_v, r_leaf), r_router), r_rel = readings(replayed)
        del replayed
    loss_rel = abs(got_loss - ref_loss) / abs(ref_loss)
    say(f"{label}: update |d|/|ref| whole {whole:.4g} (tol {tols[0]}), "
        f"largest other leaf {leaf} {leaf_v:.4g} (tol {tols[1]}), "
        f"median leaf {statistics.median(rel.values()):.4g}; loss "
        f"{got_loss:.6f} vs {ref_loss:.6f}, rel {loss_rel:.3g} (tol "
        f"{TRAIN_LM_LOSS_TOL}); aux {got_aux:.6f} vs {ref_aux:.6f}; "
        f"launches {counts}; card {t_card:.2f} s, CPU {t_cpu:.2f} s; "
        f"control ({control_name}): whole {c_whole:.4g}, leaf "
        f"{c_leaf} {c_leaf_v:.4g}, router {c_router:.4g}")
    say(f"{label}: router {MOE_ROUTER_LEAF} |d|/|ref| {router:.4g} (tol "
        f"{tols[2]}); routing picks differ {differ} of {picks} over "
        f"{len(cpu_picks)} routings ({differ / picks:.4f})")
    if replayed_tol is not None:
        say(f"{label}: the CPU's picks replayed on the card: whole "
            f"{r_whole:.4g} (tol {replayed_tol}), largest other leaf "
            f"{r_leaf} {r_leaf_v:.4g}, median leaf "
            f"{statistics.median(r_rel.values()):.4g}, router "
            f"{r_router:.4g}")
    gates = [(counts == want, f"{label}: launches {counts}, expected {want}"),
             (loss_rel <= TRAIN_LM_LOSS_TOL,
              f"{label}: loss rel {loss_rel} > {TRAIN_LM_LOSS_TOL}"),
             (whole <= tols[0], f"{label}: whole {whole} > {tols[0]}"),
             (leaf_v <= tols[1], f"{label}: {leaf} {leaf_v} > {tols[1]}"),
             (router <= tols[2], f"{label}: router {router} > {tols[2]}"),
             (c_whole > tols[0], f"{label}: the control reads whole "
                                 f"{c_whole} <= {tols[0]}"),
             (c_leaf_v > tols[1], f"{label}: the control's largest leaf "
                                  f"reads {c_leaf_v} <= {tols[1]}"),
             (c_router > tols[2], f"{label}: the control's router reads "
                                  f"{c_router} <= {tols[2]}")]
    if replayed_tol is not None:
        gates += [(r_whole <= replayed_tol, f"{label}: with the CPU's picks "
                   f"replayed, whole {r_whole} > {replayed_tol}"),
                  (c_whole > replayed_tol, f"{label}: the control reads "
                   f"whole {c_whole} <= {replayed_tol}")]
    out = dict(arch=arch, layers=1, backend=backend, optimizer=opt,
               host_free_gb=free_gb, update_rel_l2_err=whole,
               update_rel_l2_err_leaf_max=[leaf_v, leaf],
               update_rel_l2_err_router=router,
               update_rel_l2_err_by_leaf=rel, tol=tols[0], leaf_tol=tols[1],
               router_tol=tols[2], loss_rel_err=loss_rel,
               loss_tol=TRAIN_LM_LOSS_TOL, aux=got_aux, aux_cpu=ref_aux,
               control={"name": control_name, "whole": c_whole,
                        "leaf": [c_leaf_v, c_leaf], "router": c_router},
               counts=counts, card_s=t_card, cpu_s=t_cpu, picks=picks,
               picks_differ=differ, routings=len(cpu_picks))
    if replayed_tol is not None:
        out["replayed"] = dict(tol=replayed_tol, whole=r_whole,
                               leaf=[r_leaf_v, r_leaf], router=r_router,
                               by_leaf=r_rel)
    del got, ref
    for ok, msg in gates:         # after every reading is printed
        require(ok, msg)
    del params, params_cpu
    torch.cuda.empty_cache()
    return out


def moe_phase(torch, dev):
    """Phase moe: the serve, its parity, the train runs, the stochastic
    pair, then the train parity."""
    import gc

    from repro_torch.configs import get_config

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    runs = [moe_serve(torch, dev)]
    serve_parity = moe_serve_parity(torch, dev)
    full = get_config(MOE_ARCH)
    cfg = _moe_cfg(full, MOE_TRAIN_LAYERS)
    say(f"moe train: {_describe_moe(cfg, full)}")
    runs += [train_ssm_run(torch, dev, MOE_ARCH, backend,
                           MOE_TRAIN_LAUNCHES, cfg=cfg, phase="moe_train")
             for backend in MOE_TRAIN_BACKENDS]
    runs.append(train_ssm_stochastic(torch, dev, MOE_ARCH,
                                     MOE_TRAIN_LAUNCHES, cfg=cfg,
                                     phase="moe_train"))
    train_parity = moe_train_parity(torch, dev)
    secs = time.perf_counter() - t0
    say(f"moe: {secs:.1f} s")
    return runs, serve_parity, train_parity, secs


# ---------------------------------------------------------------------------
# phase mla: deepseek-v2-lite-16b (MLA, top-6 moe with shared experts)
# ---------------------------------------------------------------------------

# deepseek-v2-lite-16b (configs/deepseek_v2_lite_16b.py, arXiv 2405.04434)
# at full width.  Every MLA product and the router, routed and shared
# experts are plain products, as the JAX package computes them outside
# any Pallas kernel; the fused decode prologue excludes MLA and paged
# serving refuses it: a prefill, a decode step and a train step launch
# none of the six kernels.  The int8 and emulate backends therefore
# compute the same bits here (tests/test_torch_engine_mla.py): the serve
# and the train runs take int8
MLA_ARCH = "deepseek-v2-lite-16b"
MLA_SERVE_LAYERS, MLA_TRAIN_LAYERS = 27, 4
MLA_LAUNCHES = {name: 0 for name in SOURCES}
MLA_BACKEND = "int8"
# the serve at full depth needs the masters (4 B a parameter) and, beside
# them, one layer's bf16 expert casts, the latent cache and the logits:
# the phase fails unless the card has the masters and
# MLA_SERVE_HEADROOM_GB free before the init
MLA_SERVE_HEADROOM_GB = 6.0
# the serve parity: deepseek cut to one layer, MLA_PARITY_SLOTS rows of
# MLA_PARITY_PROMPT prompt tokens and MLA_PARITY_STEPS decode steps on the
# card and on the CPU from the same weights and tokens (the CPU decodes the
# card's argmax tokens), int8: the logits' relative L2, the largest over
# the prefill and the steps, within MLA_PARITY_TOL; the routing picks that
# differ printed.  The router picks 6 of 64 experts with near-uniform
# probabilities, so the two devices' bf16 roundings flip some picks; the
# CPU's run again with every router weight one bf16 ulp off
# (``_router_ulp_nudged``) reads what such flips cost at full width, and
# must lie within the limit too.  The controls, the card's run again with
# the last quarter of the latent cache's rank zeroed before each decode
# step attends (dropped latent) and with the absorbed query left without
# w_uk (q_nope zero-padded to the rank: un-absorbed), must read beyond it.
# Sound runs read 0.0080 (6 of 432 picks differing), the nudge 0.0054 (29
# flipped), the controls 0.88 and 1.21 (PERF.md; H100 80GB HBM3, 700 W):
# the limit, 0.05, is six times the larger sound reading and a
# seventeenth of the finer control
MLA_PARITY_PROMPT, MLA_PARITY_SLOTS, MLA_PARITY_STEPS = 32, 2, 4
MLA_PARITY_TOL = 0.05
MLA_NUDGE_SEED = 1
MLA_LATENT_SPLITS = 4   # the dropped-latent control zeroes the last quarter
# the two MLA code paths on the card, one layer computed in f32 (f32
# cache): the absorbed decode's logits at position t against the last
# logits of the materialised prefill of the same t + 1 tokens, their
# relative L2, the largest over the MLA_PARITY_STEPS positions; the
# un-absorbed control beyond it.  In bf16 the decode rounds its score
# products to bf16 before the f32 softmax and the prefill does not: the
# attention outputs differ by ~0.5% (CPU, one full-width layer's MLA),
# enough to flip a top-6 routing pick, so the gate holds the algebra in
# f32 (the CPU reads ~1e-6 on the attention output) and the bf16 readings
# are printed beside it
MLA_ABSORB_TOL = 1e-3
# the train parity: one step of deepseek cut to one layer, batch
# MLA_TRAIN_PARITY_BATCH x MLA_TRAIN_PARITY_SEQ, card against CPU (int8):
# the update's relative L2 whole, of each leaf but the router, and of the
# router, within the moe phase's limits; then the card's step again with
# the CPU's routing picks replayed, which leaves the arithmetic alone to
# differ: its whole update within MLA_REPLAYED_TOL.  The control, the
# card's step again with the last quarter of the latent's rank zeroed in
# the forward and the re-linearisation, lies beyond all four.  Sound runs
# read 0.0457 whole, 0.1223 the largest other leaf (moe/w_gate) and 0.0947
# the router with 8 of 768 picks differing; with the CPU's picks replayed
# 0.0062, 0.0077 and 0.0038: the flips carry the free readings, which the
# moe phase's limits hold loosely, and the replayed update is held to
# 0.05, eight times its reading and an eighteenth of the control's 0.90
# (PERF.md; H100 80GB HBM3, 700 W)
MLA_TRAIN_PARITY_BATCH, MLA_TRAIN_PARITY_SEQ = 2, 32
MLA_TRAIN_PARITY_TOL = dict(MOE_TRAIN_PARITY_TOL)
MLA_TRAIN_LEAF_TOL = dict(MOE_TRAIN_LEAF_TOL)
MLA_ROUTER_TOL = dict(MOE_ROUTER_TOL)
MLA_REPLAYED_TOL = 0.05
MLA_TRAIN_PARITY_MIN_FREE_GB = 24.0


def _mla_cfg(full, layers):
    """``full`` cut to ``layers`` layers."""
    import dataclasses

    return dataclasses.replace(full, num_layers=layers)


def _describe_mla(cfg, full) -> str:
    return (f"{MLA_ARCH} at full width (d {cfg.d_model}, {cfg.num_heads} "
            f"heads, MLA rank {cfg.kv_lora_rank} with nope/rope/v "
            f"{cfg.qk_nope_dim}/{cfg.qk_rope_dim}/{cfg.v_head_dim}, "
            f"{cfg.num_experts} experts of {cfg.moe_d_ff}, "
            f"top-{cfg.experts_per_token}, {cfg.num_shared_experts} shared, "
            f"vocab {cfg.vocab_size}), {cfg.num_layers} of "
            f"{full.num_layers} layers")


def _layer_bytes(cfg) -> int:
    """(f32 bytes of one layer's masters, of the rest: the embedding
    and the final norm), from ``param_count``."""
    import dataclasses

    one = dataclasses.replace(cfg, num_layers=1).param_count()
    none = dataclasses.replace(cfg, num_layers=0).param_count()
    return 4 * (one - none), 4 * none


def _mla_serve_fits(torch, dev, full):
    """Print the card's free memory before the serve's init and require
    that MLA_SERVE_LAYERS layers' masters and MLA_SERVE_HEADROOM_GB fit
    it."""
    free, total = torch.cuda.mem_get_info(dev)
    per_layer, rest = _layer_bytes(full)
    need = MLA_SERVE_LAYERS * per_layer + rest + MLA_SERVE_HEADROOM_GB * 1e9
    say(f"mla serve: card memory {free / 2**30:.2f} GiB free of "
        f"{total / 2**30:.2f} GiB before the init; a layer's masters "
        f"{per_layer / 1e9:.3f} GB, embedding and norms {rest / 1e9:.3f} GB: "
        f"{MLA_SERVE_LAYERS} layers and {MLA_SERVE_HEADROOM_GB} GB of "
        f"headroom need {need / 2**30:.2f} GiB")
    require(free >= need, f"mla serve: {free / 2**30:.2f} GiB free, "
                          f"{MLA_SERVE_LAYERS} layers need "
                          f"{need / 2**30:.2f} GiB")


def mla_serve(torch, dev):
    """The scheduler (contiguous mode) on deepseek-v2-lite at full width
    and depth (``_mla_serve_fits``) through the
    engine's hooks: B prompts of CONT_PROMPT tokens, CONT_NEW new, bf16
    latent cache, the int8 backend; every request finishes and the serve
    launches no kernel.  Then the engine's own entry points
    (``_engine_serve_checks``: prefill ms, a decode step, a profile) and a
    snapshot restored to equal streams."""
    from repro_torch import kernels as K
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.serving import (BatchScheduler, EngineHooks, Request,
                                     ServeConfig)

    full = get_config(MLA_ARCH)
    _mla_serve_fits(torch, dev, full)
    cfg = _mla_cfg(full, MLA_SERVE_LAYERS)
    t0 = time.perf_counter()
    params = lm.init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    n = _n_params(params)
    say(f"mla serve: {_describe_mla(cfg, full)}: {n / 1e9:.3f} B f32 "
        f"masters ({4 * n / 2**30:.2f} GiB), drawn in "
        f"{time.perf_counter() - t0:.1f} s; card memory "
        f"{torch.cuda.mem_get_info(dev)[0] / 2**30:.2f} GiB free after")
    serve = ServeConfig(num_slots=B, eos_id=None, max_len=CONT_MAX_LEN,
                        mode="contiguous", cache_dtype="bfloat16",
                        kernel_backend=MLA_BACKEND)
    hooks = EngineHooks.for_model(params, cfg, serve)
    inner, decode_s = hooks.decode, [0.0]

    def timed_decode(*a):
        t = time.perf_counter()
        out = inner(*a)
        torch.cuda.synchronize()
        decode_s[0] += time.perf_counter() - t
        return out
    hooks.decode = timed_decode
    sched = BatchScheduler(serve, hooks)
    reqs = [Request(uid=i, prompt=p, max_new_tokens=CONT_NEW)
            for i, p in enumerate(_cont_prompts(torch, cfg))]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    K.reset_launch_counts()
    t0 = time.perf_counter()
    for r in reqs:
        sched.submit(r)
    sched.run_until_drained()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts, steps = K.launch_counts(), sched.steps_run
    tokens = sum(len(r.generated) for r in reqs)
    require(all(r.done and len(r.generated) == CONT_NEW for r in reqs),
            f"mla serve: {sum(r.done for r in reqs)}/{B} finished, "
            f"{[len(r.generated) for r in reqs]} tokens")
    require(steps == CONT_NEW - 1 and counts == MLA_LAUNCHES,
            f"mla serve: {steps} decode steps, launches {counts}, expected "
            f"{MLA_LAUNCHES}")
    rec = dict(run=f"mla/serve/{MLA_ARCH}/{MLA_BACKEND}/bfloat16",
               arch=MLA_ARCH, layers=cfg.num_layers, params=n,
               backend=MLA_BACKEND, cache="bfloat16", counts=counts,
               tokens=tokens, seconds=secs, tokens_per_s=tokens / secs,
               decode_steps=steps,
               ms_per_decode_step=1e3 * decode_s[0] / max(steps, 1),
               peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 2**30)
    say(f"mla serve {MLA_ARCH} ({cfg.num_layers} layers) contiguous "
        f"{MLA_BACKEND}/bfloat16: {tokens} tokens in {secs:.2f} s = "
        f"{rec['tokens_per_s']:.1f} tok/s, {steps} decode steps at "
        f"{rec['ms_per_decode_step']:.2f} ms/step, peak memory "
        f"{rec['peak_mem_gb']:.2f} GiB, launches {counts}")
    del sched, hooks
    _engine_serve_checks(torch, dev, MLA_ARCH, cfg, params, MLA_LAUNCHES,
                         MLA_LAUNCHES, rec)
    rec["snapshot"] = snapshot_restore(torch, dev, params, cfg,
                                       "contiguous")
    del params
    torch.cuda.empty_cache()
    return rec


def _router_ulp_nudged(torch, params):
    """``params`` with every router weight moved by one bf16 ulp (the
    dtype the router product runs in), up or down at random from seed
    MLA_NUDGE_SEED: the router's bf16 bits differ from the masters' by
    exactly one in the last place."""
    moe = params["blocks"]["moe"]
    r = moe["router"]
    bits = r.to(torch.bfloat16).view(torch.int16)
    step = (2 * torch.randint(0, 2, r.shape, generator=torch.Generator()
                              .manual_seed(MLA_NUDGE_SEED))
            - 1).to(torch.int16).to(r.device)
    nudged = (bits + step).view(torch.bfloat16).to(r.dtype)
    return dict(params, blocks=dict(params["blocks"],
                                    moe=dict(moe, router=nudged)))


def _dropped_latent_decode(torch, L):
    """Install into ``L`` an ``mla_decode`` that zeroes the last
    1/MLA_LATENT_SPLITS of the latent cache's rank before each step
    attends (a fault control); returns the undo."""
    real = L.mla_decode

    def faulty(params, x, cfg, cache, pos):
        r = cache["ckv"].shape[-1]
        cache["ckv"][..., r - r // MLA_LATENT_SPLITS:] = 0
        return real(params, x, cfg, cache, pos)
    L.mla_decode = faulty
    return lambda: setattr(L, "mla_decode", real)


def _unabsorbed_query(torch, L):
    """Install into ``L`` an ``mla_absorb_q`` that skips w_uk: q_nope
    zero-padded to the latent rank (a fault control); returns the undo."""
    real = L.mla_absorb_q

    def faulty(q_nope, w_uk):
        q = q_nope[:, 0]
        return torch.nn.functional.pad(q, (0, w_uk.shape[0] - q.shape[-1]))
    L.mla_absorb_q = faulty
    return lambda: setattr(L, "mla_absorb_q", real)


def _dropped_latent(torch, L):
    """Install into ``L`` an ``_mla_latent`` whose latent has its last
    1/MLA_LATENT_SPLITS of the rank zeroed, in the prefill, the decode,
    the forward and the re-linearisation alike (a fault control); returns
    the undo."""
    real = L._mla_latent

    def faulty(params, x, cfg, positions):
        c_kv, k_pe = real(params, x, cfg, positions)
        r = c_kv.shape[-1]
        keep = torch.ones(r, dtype=c_kv.dtype, device=c_kv.device)
        keep[r - r // MLA_LATENT_SPLITS:] = 0
        return c_kv * keep, k_pe
    L._mla_latent = faulty
    return lambda: setattr(L, "_mla_latent", real)


def _absorbed_vs_materialised(torch, dev, params, cfg, toks, dtype):
    """``cfg`` computed in ``dtype`` with a cache of that dtype, its
    experts' capacity raised so that no pick is dropped, on ``dev``: a
    prefill of ``toks`` and MLA_PARITY_STEPS absorbed decode
    steps on the argmax tokens, then for each step the materialised
    prefill of the prompt and the tokens fed so far.  Returns (the
    relative L2 of each step's logits against its prefill's last logits,
    the largest of the same with the un-absorbed control)."""
    import dataclasses

    from repro_torch.models import layers as L
    from repro_torch.serving import engine as E

    # an expert's capacity of 2 t slots for a t-token prefill: no pick is
    # dropped, as none is in a one-token decode step, so the two paths
    # differ in their attention alone
    cfg = dataclasses.replace(
        cfg, compute_dtype=dtype,
        capacity_factor=2.0 * cfg.num_experts / cfg.experts_per_token)
    cache = getattr(torch, dtype)
    dec = _moe_parity_side(torch, params, cfg, toks, MLA_BACKEND, dev, None,
                           MLA_PARITY_STEPS, cache)
    undo = _unabsorbed_query(torch, L)
    try:
        bad = _moe_parity_side(torch, params, cfg, toks, MLA_BACKEND, dev,
                               dec[1], MLA_PARITY_STEPS, cache)
    finally:
        undo()
    mats = []
    for i in range(MLA_PARITY_STEPS):
        seq = torch.cat([torch.from_numpy(toks)]
                        + [f.cpu() for f in dec[1][:i + 1]], dim=1)
        logits, _ = E.prefill(params, cfg, {"tokens": seq}, seq.shape[1],
                              cache, kernel_backend=MLA_BACKEND)
        mats.append(logits.cpu())

    def rels(side):
        return [float((g - r).norm() / r.norm())
                for g, r in zip(side[0][1:], mats)]
    return rels(dec), max(rels(bad))


def mla_serve_parity(torch, dev):
    """deepseek cut to one layer on the card and on the CPU
    (``_moe_parity_side``, int8): the logits within MLA_PARITY_TOL, the
    routing picks compared, no launch, each control beyond the limit; then
    the absorbed decode against the materialised prefill on the card
    (``_absorbed_vs_materialised``) in f32 within MLA_ABSORB_TOL, the
    un-absorbed control beyond it, and in bf16 printed."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models import layers as L
    from repro_torch.models import lm

    full = get_config(MLA_ARCH)
    cfg = _mla_cfg(full, 1)
    params = lm.init_params(cfg, seed=2, device=dev)
    params_cpu = _tree_cpu(params)
    toks = np.random.default_rng(15).integers(
        0, cfg.vocab_size, (MLA_PARITY_SLOTS, MLA_PARITY_PROMPT)).astype(
        np.int32)
    backend, tol, steps = MLA_BACKEND, MLA_PARITY_TOL, MLA_PARITY_STEPS
    say(f"mla serve parity: {_describe_mla(cfg, full)}: "
        f"{MLA_PARITY_SLOTS} rows of {MLA_PARITY_PROMPT} prompt tokens, "
        f"{steps} decode steps, {backend}")
    t0 = time.perf_counter()
    card = _moe_parity_side(torch, params, cfg, toks, backend, dev, None,
                            steps)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = _moe_parity_side(torch, params_cpu, cfg, toks, backend, "cpu",
                           card[1], steps)
    cpu_s = time.perf_counter() - t0
    nudge = _moe_parity_side(torch, _router_ulp_nudged(torch, params_cpu),
                             cfg, toks, backend, "cpu", card[1], steps)
    nudge_rel = _logit_rel(nudge[0], cpu[0])
    nudge_differ = int((nudge[2] != cpu[2]).sum())
    ctrl = {}
    for name, install in (("dropped latent", _dropped_latent_decode),
                          ("un-absorbed", _unabsorbed_query)):
        undo = install(torch, L)
        try:
            side = _moe_parity_side(torch, params, cfg, toks, backend, dev,
                                    card[1], steps)
        finally:
            undo()
        ctrl[name] = _logit_rel(side[0], cpu[0])
    for o in card[0]:
        require(tuple(o.shape) == (MLA_PARITY_SLOTS, cfg.vocab_size)
                and bool(o.isfinite().all()),
                f"mla parity: logits {tuple(o.shape)} not finite or of the "
                "wrong shape")
    rel = _logit_rel(card[0], cpu[0])
    steps_rel = [float((g - r).norm() / r.norm())
                 for g, r in zip(card[0], cpu[0])]
    picks = card[2].shape[0] * card[2].shape[1]
    differ = int((card[2] != cpu[2]).sum())
    absorb = {dt: _absorbed_vs_materialised(torch, dev, params, cfg, toks,
                                            dt)
              for dt in ("float32", "bfloat16")}
    rec = dict(backend=backend, tol=f"|d|/|ref| <= {tol}", rel_l2_err=rel,
               rel_l2_err_by_step=steps_rel, picks=picks,
               picks_differ=differ, picks_differ_share=differ / picks,
               router_ulp_nudge=dict(rel_l2_err=nudge_rel,
                                     picks_differ=nudge_differ),
               controls=ctrl, launches=card[3], card_s=card_s, cpu_s=cpu_s,
               absorbed_vs_materialised=absorb,
               absorbed_tol=f"float32 |d|/|ref| <= {MLA_ABSORB_TOL}")
    say(f"mla parity {backend}: |d|/|ref| {rel:.4g} (prefill, then each "
        f"step: {', '.join(f'{v:.4g}' for v in steps_rel)}; tol {tol}), "
        f"routing picks differ {differ} of {picks} "
        f"({differ / picks:.4f}); the CPU with its router nudged one bf16 "
        f"ulp: {nudge_rel:.4g}, picks differ {nudge_differ}; controls "
        + ", ".join(f"{k} {v:.4g}" for k, v in ctrl.items())
        + f"; launches {card[3]}; card {card_s:.2f} s, CPU {cpu_s:.2f} s")
    for dt, (vals, bad) in absorb.items():
        say(f"mla absorbed decode vs materialised prefill on the card, "
            f"{dt}: |d|/|ref| {', '.join(f'{v:.4g}' for v in vals)}"
            + (f" (tol {MLA_ABSORB_TOL})" if dt == "float32" else
               " (printed, not gated)")
            + f"; the un-absorbed control reads {bad:.4g}")
    vals, bad = absorb["float32"]
    none = {k: 0 for k in SOURCES}
    gates = [(card[3] == (none, none),
              f"mla parity: card launches {card[3]}, expected none"),
             (rel <= tol, f"mla parity: |d|/|ref| {rel} > {tol}"),
             (nudge_rel <= tol, f"mla parity: the one-ulp router nudge "
                                f"reads {nudge_rel} > {tol}"),
             (max(vals) <= MLA_ABSORB_TOL,
              f"mla absorbed vs materialised: {vals} > {MLA_ABSORB_TOL}"),
             (bad > MLA_ABSORB_TOL,
              f"mla absorbed vs materialised: the un-absorbed control reads "
              f"{bad} <= {MLA_ABSORB_TOL}")]
    gates += [(v > tol, f"mla parity: the control ({k}) reads {v} <= {tol},"
                        f" so the limit cannot see it")
              for k, v in ctrl.items()]
    for ok, msg in gates:         # after every reading is printed
        require(ok, msg)
    del params, params_cpu
    torch.cuda.empty_cache()
    return rec


def mla_train_parity(torch, dev):
    """One step of deepseek cut to one layer on the card and on the CPU
    (``_router_train_parity``): the routing picks that differ counted, the
    update within MLA_TRAIN_PARITY_TOL, MLA_TRAIN_LEAF_TOL and
    MLA_ROUTER_TOL, and with the CPU's picks replayed on the card within
    MLA_REPLAYED_TOL, no launch, the dropped-latent control beyond
    them."""
    from repro_torch.configs import get_config
    from repro_torch.models import layers as L

    full = get_config(MLA_ARCH)
    cfg = _mla_cfg(full, 1)
    return _router_train_parity(
        torch, dev, arch=MLA_ARCH, cfg=cfg,
        label=f"mla train parity {MLA_BACKEND}",
        describe=_describe_mla(cfg, full), backend=MLA_BACKEND,
        shape=(MLA_TRAIN_PARITY_BATCH, MLA_TRAIN_PARITY_SEQ),
        want=MLA_LAUNCHES,
        tols=(MLA_TRAIN_PARITY_TOL[MLA_BACKEND],
              MLA_TRAIN_LEAF_TOL[MLA_BACKEND], MLA_ROUTER_TOL[MLA_BACKEND]),
        min_free_gb=MLA_TRAIN_PARITY_MIN_FREE_GB,
        control=("dropped latent", lambda: _dropped_latent(torch, L)),
        replayed_tol=MLA_REPLAYED_TOL)


def mla_phase(torch, dev):
    """Phase mla: the full-depth serve (earlier phases' memory freed
    first), its parity and the absorbed-vs-materialised check, the train
    runs at MLA_TRAIN_LAYERS layers, the stochastic pair, then the train
    parity."""
    import gc

    from repro_torch.configs import get_config

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    runs = [mla_serve(torch, dev)]
    serve_parity = mla_serve_parity(torch, dev)
    full = get_config(MLA_ARCH)
    cfg = _mla_cfg(full, MLA_TRAIN_LAYERS)
    say(f"mla train: {_describe_mla(cfg, full)} (reduced from "
        f"{full.num_layers})")
    runs.append(train_ssm_run(torch, dev, MLA_ARCH, MLA_BACKEND,
                              MLA_LAUNCHES, cfg=cfg, phase="mla_train"))
    runs.append(train_ssm_stochastic(torch, dev, MLA_ARCH, MLA_LAUNCHES,
                                     cfg=cfg, phase="mla_train"))
    train_parity = mla_train_parity(torch, dev)
    secs = time.perf_counter() - t0
    say(f"mla: {secs:.1f} s")
    return runs, serve_parity, train_parity, secs


# ---------------------------------------------------------------------------
# phase 7: the train driver, killed and resumed bitwise
# ---------------------------------------------------------------------------

# the JAX train driver's defaults with --quantize and --stochastic (train_lm's
# stochastic run, through the driver, as the JAX package's kill drill runs
# it; round-to-nearest stays driven by train_lm): a checkpoint after step 4
# (step 5) and at the end (step 8)
DRIVER_STEPS, DRIVER_CKPT_EVERY, DRIVER_CRASH = 8, 4, 6
DRIVER_RESUME = DRIVER_CKPT_EVERY + 1
# no batch waits this long, so the loader never substitutes one and the
# stall of run B only delays its step 5
DRIVER_DEADLINE_S = 600.0
# an F-bit anneal (search/anneal.py) whose ramp crosses B's kill at step 6
# and B''s resume from step 5 (a resume under another spec is refused
# before its first step: tests/test_torch_search_driver.py)
DRIVER_ANNEAL = "0:16,3:14,6:12"
DRIVER_ARGS = ["--arch", LM_ARCH, "--device", "cuda", "--quantize",
               "--stochastic", "--bit-anneal", DRIVER_ANNEAL,
               "--kernel-backend", "auto", "--optimizer", TRAIN_LM_OPTIMIZER,
               "--seq-len", str(TRAIN_LM_SEQ),
               "--global-batch", str(TRAIN_LM_BATCH),
               "--steps", str(DRIVER_STEPS),
               "--ckpt-every", str(DRIVER_CKPT_EVERY), "--log-every", "1",
               "--deadline-s", str(DRIVER_DEADLINE_S)]
# the driver in a fresh interpreter, with src on its path and no
# PYTHONPATH (src/sitecustomize.py would reach for the JAX package); it
# fails if the JAX package or JAX got imported
DRIVER_CMD = (
    "import sys; sys.path.insert(0, {src!r}); "
    "from repro_torch.launch.train import main; main(sys.argv[1:]); "
    "bad = [m for m in ('jax', 'repro') if m in sys.modules]; "
    "sys.exit(f'imported {{bad}}' if bad else 0)")
DRIVER_TIMEOUT_S = 900
STEP_LINE = re.compile(r"step\s+(\d+) loss (\d+\.\d+) gnorm \S+ lr \S+ "
                       r"(\d+\.\d+)s")
CKPT_LINE = re.compile(r"checkpoint step (\d+): snapshot (\d+\.\d+) s, "
                       r"write (\d+\.\d+) s")


class _Tee:
    """stdout that is also kept (run A's log lines)."""

    def __init__(self, out):
        self.out, self.lines = out, []

    def write(self, text):
        self.lines.append(text)
        return self.out.write(text)

    def flush(self):
        self.out.flush()

    def text(self) -> str:
        return "".join(self.lines)


def _step_lines(text: str) -> dict:
    """{step: (loss string, seconds since the loop began)}."""
    return {int(m[1]): (m[2], float(m[3])) for m in STEP_LINE.finditer(text)}


def _manifest_crcs(ckpt_dir, step) -> dict:
    from repro_torch.ckpt._msgpack import unpackb

    m = unpackb((pathlib.Path(ckpt_dir) / f"step_{step:08d}"
                 / "manifest.msgpack").read_bytes())
    return {e["path"]: (e["crc32"], e["nbytes"]) for e in m["leaves"]}


def _tree_crcs(tree) -> dict:
    """{path: (crc32, nbytes)} of a (params, opt_state) tuple on the card,
    with the checkpoint's leaf paths."""
    import zlib

    from repro_torch.util.tree import tree_leaves_with_path

    out = {}
    for path, x in tree_leaves_with_path(tree):
        a = x.cpu().numpy()
        out[path] = (zlib.crc32(a.tobytes()), a.nbytes)
    return out


def _run_driver(argv, expect: int):
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "REPRO_FAULT_PLAN")}
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-c", DRIVER_CMD.format(src=str(SRC)), *argv],
        capture_output=True, text=True, env=env, cwd=ROOT,
        timeout=DRIVER_TIMEOUT_S)
    secs = time.perf_counter() - t0
    require(out.returncode == expect,
            f"train_driver: {argv[-4:]} exited {out.returncode}, expected "
            f"{expect}\nstdout: {out.stdout[-2000:]}\n"
            f"stderr: {out.stderr[-3000:]}")
    return out, secs


def train_driver(torch, dev):
    """Runs A, B, B' and the flip drill (module docstring, phase
    5d)."""
    import contextlib
    import gc
    import shutil
    import tempfile
    import warnings

    from repro_torch import kernels as K
    from repro_torch.ckpt import restore_checkpoint, verify_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.core import init_train_state
    from repro_torch.ft import FAULT_EXIT_CODE, flip_one_bit
    from repro_torch.launch import train
    from repro_torch.models import lm
    from repro_torch.optim import OptimizerConfig

    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    root = pathlib.Path(tempfile.mkdtemp(prefix="chip-smoke-driver-"))
    free_gb = shutil.disk_usage(root).free / 1e9
    say(f"train_driver: {free_gb:.1f} GB free on the disk of {root}")
    rec = dict(run="train_driver/int8/stochastic/anneal",
               anneal=DRIVER_ANNEAL, free_disk_gb=free_gb)
    try:
        # ---- run A, in-process, through the entry point a user calls ----
        dir_a = root / "a"
        tee = _Tee(sys.stdout)
        K.reset_launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(tee):
            losses = train.main(DRIVER_ARGS + ["--ckpt-dir", str(dir_a)])
        rec["seconds_a"] = time.perf_counter() - t0
        counts = K.launch_counts()
        for name, n in counts.items():
            want = TRAIN_LM_LAUNCHES[name] * DRIVER_STEPS
            require(n == want, f"train_driver A: {name} launched {n} times, "
                               f"expected {want}")
        require(len(losses) == DRIVER_STEPS
                and all(math.isfinite(v) for v in losses),
                f"train_driver A: losses {losses}")
        for s in (DRIVER_RESUME, DRIVER_STEPS):
            problems = verify_checkpoint(dir_a, s)
            require(not problems, f"train_driver A: checkpoint {s}: "
                                  f"{problems}")
        log_a = _step_lines(tee.text())
        require(sorted(log_a) == list(range(DRIVER_STEPS)),
                f"train_driver A: logged steps {sorted(log_a)}")
        crc_a = {s: _manifest_crcs(dir_a, s)
                 for s in (DRIVER_RESUME, DRIVER_STEPS)}
        nbytes = sum(n for _, n in crc_a[DRIVER_STEPS].values())
        saves = [(int(s), float(a), float(b))
                 for s, a, b in CKPT_LINE.findall(tee.text())]
        require([s for s, _, _ in saves] == [DRIVER_RESUME, DRIVER_STEPS],
                f"train_driver A: checkpoint timings {saves}")
        # the interval after a save holds that save's snapshot
        after_save = {s + 1 for s in range(1, DRIVER_STEPS)
                      if s % DRIVER_CKPT_EVERY == 0}
        gaps = [log_a[s][1] - log_a[s - 1][1]
                for s in range(1, DRIVER_STEPS) if s not in after_save]
        ms = 1e3 * statistics.median(gaps)
        rec.update(counts=counts, losses=losses, ms_per_step=ms,
                   step_gaps_s=gaps,
                   tokens_per_s=TRAIN_LM_BATCH * TRAIN_LM_SEQ / (ms / 1e3),
                   ckpt_bytes=nbytes, ckpt_leaves=len(crc_a[DRIVER_STEPS]),
                   snapshot_s=[a for _, a, _ in saves],
                   write_s=[b for _, _, b in saves])
        say(f"train_driver A: {ms:.2f} ms/step (median of {len(gaps)} "
            f"logged gaps without a save), {rec['tokens_per_s']:.0f} "
            f"tokens/s, loss {losses[0]:.4f} -> {losses[-1]:.4f}, "
            f"checkpoint {nbytes} bytes in {rec['ckpt_leaves']} leaves, "
            f"snapshot {rec['snapshot_s']} s, write {rec['write_s']} s, "
            f"{rec['seconds_a']:.1f} s in all, launches {counts}")

        # ---- restore and verify onto the card; the flip drill ------------
        cfg = get_config(LM_ARCH)
        params = lm.init_params(cfg, seed=0, device=dev)
        template = (params, init_train_state(
            params, OptimizerConfig(kind=TRAIN_LM_OPTIMIZER)))
        t0 = time.perf_counter()
        tree, step, _ = restore_checkpoint(dir_a, template)
        torch.cuda.synchronize()
        rec["restore_verify_s"] = time.perf_counter() - t0
        require(step == DRIVER_STEPS, f"train_driver: restored step {step}")
        del tree
        flipped = flip_one_bit(dir_a, DRIVER_STEPS, seed=0)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            tree, step, _ = restore_checkpoint(dir_a, template)
        require(any("failed verification" in str(w.message)
                    for w in caught),
                f"train_driver flip: no verification warning after "
                f"flipping {flipped}: {[str(w.message) for w in caught]}")
        require(step == DRIVER_RESUME,
                f"train_driver flip: recovered step {step}, expected "
                f"{DRIVER_RESUME}")
        got = _tree_crcs(tree)
        differ = [k for k, v in crc_a[DRIVER_RESUME].items()
                  if got.get(k) != v]
        require(set(got) == set(crc_a[DRIVER_RESUME]) and not differ,
                f"train_driver flip: {len(differ)} leaves of the recovered "
                f"step differ from A's: {differ[:8]}")
        say(f"train_driver: restore+verify of checkpoint {DRIVER_STEPS} "
            f"onto the card {rec['restore_verify_s']:.2f} s; flip drill: "
            f"{flipped} flipped, warned, recovered step {step} bitwise")
        del params, template, tree
        gc.collect()
        torch.cuda.empty_cache()
        shutil.rmtree(dir_a)

        # ---- run B, killed at DRIVER_CRASH; run B', resumed --------------
        # the step-5 checkpoint (3.71 GB) takes longer to write than a step
        # takes to run, so B's plan holds step 5's batch back for twice A's
        # longest write: the checkpoint lands before the kill, as in a run
        # whose steps outlast its writes
        stall = round(2 * max(rec["write_s"]) + 5, 1)
        require(stall < DRIVER_DEADLINE_S, f"train_driver: stall {stall} s")
        dir_b = root / "b"
        plan = f"stall@{DRIVER_RESUME}:{stall};crash@{DRIVER_CRASH}"
        out_b, rec["seconds_b"] = _run_driver(
            DRIVER_ARGS + ["--ckpt-dir", str(dir_b), "--fault-plan", plan],
            FAULT_EXIT_CODE)
        require(f"injected crash at step {DRIVER_CRASH}" in out_b.stderr,
                f"train_driver B: {out_b.stderr[-2000:]}")
        require(not (dir_b / f"step_{DRIVER_STEPS:08d}").exists(),
                "train_driver B: the final checkpoint exists after the kill")
        log_b = _step_lines(out_b.stdout)
        require(sorted(log_b) == list(range(DRIVER_CRASH))
                and all(log_b[s][0] == log_a[s][0] for s in log_b),
                f"train_driver B: losses {log_b} against A's {log_a}")
        out_r, rec["seconds_b_resumed"] = _run_driver(
            DRIVER_ARGS + ["--ckpt-dir", str(dir_b), "--resume"], 0)
        require(f"resumed from step {DRIVER_RESUME}" in out_r.stdout,
                f"train_driver B': {out_r.stdout[-2000:]}")
        log_r = _step_lines(out_r.stdout)
        require(sorted(log_r) == list(range(DRIVER_RESUME, DRIVER_STEPS))
                and all(log_r[s][0] == log_a[s][0] for s in log_r),
                f"train_driver B': losses {log_r} against A's {log_a}")
        crc_r = _manifest_crcs(dir_b, DRIVER_STEPS)
        differ = sorted(k for k, v in crc_a[DRIVER_STEPS].items()
                        if crc_r.get(k) != v)
        require(set(crc_r) == set(crc_a[DRIVER_STEPS]) and not differ,
                f"train_driver B': {len(differ)} of {len(crc_r)} leaves of "
                f"checkpoint {DRIVER_STEPS} differ from A's: {differ[:8]}")
        shutil.rmtree(dir_b)
        rec.update(stall_s=stall, crash_step=DRIVER_CRASH,
                   resumed_from=DRIVER_RESUME, bitwise_leaves=len(crc_r))
        say(f"train_driver: B killed at step {DRIVER_CRASH} (exit "
            f"{FAULT_EXIT_CODE}, step-5 batch held {stall} s, "
            f"{rec['seconds_b']:.1f} s); B' resumed from step "
            f"{DRIVER_RESUME} ({rec['seconds_b_resumed']:.1f} s): all "
            f"{len(crc_r)} crc32s of checkpoint {DRIVER_STEPS} equal A's, "
            f"losses of steps {DRIVER_RESUME}-{DRIVER_STEPS - 1} equal "
            f"A's as strings")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    rec["seconds"] = time.perf_counter() - t_phase
    say(f"train_driver: {rec['seconds']:.1f} s")
    return rec


# ---------------------------------------------------------------------------
# phase 8: the bitwidth search (search/)
# ---------------------------------------------------------------------------

# the LeNet sweep (run_sweep(SweepConfig()): 784-256x4-10, 3 groups, the
# 6-point DEFAULT_GRID, 120 probe steps of batch 128 at lr 0.05, seed 0) on
# the card and on the CPU from the same weights.  Its gated losses (the
# baseline, each group's chosen probe, the final plan's) lie within this of
# the CPU's (absolute), and a decision nearer its threshold than this may
# differ: on the CPU alone one f32 ulp on every weight with every sum
# reversed moves the gated losses by under 2e-3 and the probe that decides
# the escalation ((1,5) in every group, 0.011 above its threshold) by up to
# 0.0111; the limit is over twice that
# (tests/test_torch_search.py::test_probe_spread_justifies_card_tolerances)
SEARCH_LENET_LOSS_TOL = 0.025
# part 2: the driver's --bit-search at full width (24 layers, int8),
# train_driver's shapes, 3 steps a probe, 2 training steps, no checkpoint
SEARCH_DRIVER_ARGS = ["--arch", LM_ARCH, "--device", "cuda", "--quantize",
                      "--kernel-backend", "auto",
                      "--optimizer", TRAIN_LM_OPTIMIZER,
                      "--seq-len", str(TRAIN_LM_SEQ),
                      "--global-batch", str(TRAIN_LM_BATCH),
                      "--bit-search", "2", "--bit-probe-steps", "3",
                      "--steps", "2", "--log-every", "1"]
SEARCH_PROBE_STEPS, SEARCH_TRAIN_STEPS = 3, 2
# part 4: the JAX suite's EXPORT_PLAN (tests/test_bit_search.py)
EXPORT_FORMATS = ((2, 5), (1, 6), (2, 12), (4, 10))
PLAN_LINE = re.compile(r"\[train\] bit-search \((\d+) probes, "
                       r"(\d+\.\d+)s\): (.*)")
PROBE_LOSS = re.compile(r"(?:loss|->) (\S+)")
NO_LAUNCHES = {name: 0 for name in SOURCES}


def _recording_sweep(sensitivity, make_probe, sweep, num_layers_of):
    """select_plan over ``make_probe()``'s probe, recording every probe's
    schedule (per-layer formats and enabled) and full-precision loss."""
    probe = make_probe()
    record = []

    def rec(schedule):
        loss = probe(schedule)
        record.append(((tuple(zip(schedule.w_i.tolist(),
                                  schedule.w_f.tolist())),
                        float(schedule.enabled)), loss))
        return loss
    t0 = time.perf_counter()
    plan = sensitivity.select_plan(rec, num_layers_of, sweep)
    return plan, record, time.perf_counter() - t0


def _same_plan(label, card, cpu, rec_card, rec_cpu, tol, rel: bool):
    """Gate two sweeps' plans: the same formats, the baseline, each group's
    chosen loss and the final loss within ``tol`` (relative if ``rel``).
    Where the formats differ, the first probe on which the two sides
    decided differently must lie nearer the threshold than ``tol`` on the
    CPU: then it is printed, not failed.  Returns the largest difference
    and what the comparison found."""
    def diff(a, b):
        return abs(a - b) / abs(b) if rel else abs(a - b)
    worst = diff(card.baseline_loss, cpu.baseline_loss)
    require(worst <= tol, f"{label}: baseline {card.baseline_loss} vs CPU "
                          f"{cpu.baseline_loss} beyond {tol}")
    thr_cpu = cpu.baseline_loss + cpu.target
    thr_card = card.baseline_loss + card.target
    if card.formats() != cpu.formats():
        for (s_a, l_a), (s_b, l_b) in zip(rec_card, rec_cpu):
            require(s_a == s_b, f"{label}: the sweeps probed {s_a} on the "
                                f"card against {s_b} on the CPU before any "
                                f"decision differed")
            if (l_a <= thr_card) != (l_b <= thr_cpu):
                margin = diff(l_b, thr_cpu)
                require(margin < tol,
                        f"{label}: plans differ ({card.formats()} against "
                        f"{cpu.formats()}) at {s_b}: card {l_a}, CPU {l_b}, "
                        f"threshold {thr_cpu}, margin {margin} >= {tol}")
                say(f"{label}: plans differ at {s_b}, a decision "
                    f"{margin:.3g} from the threshold {thr_cpu:.6f} (tol "
                    f"{tol}): card {l_a:.6f}, CPU {l_b:.6f}; not gated")
                return worst, "near-threshold decision"
        raise SmokeFailure(f"{label}: plans differ with no differing "
                           f"decision")
    for g_a, g_b in zip(card.groups, cpu.groups):
        d = diff(g_a.probe_loss, g_b.probe_loss)
        require(d <= tol, f"{label}: group {g_a.group} loss "
                          f"{g_a.probe_loss} vs CPU {g_b.probe_loss} beyond "
                          f"{tol}")
        worst = max(worst, d)
    d = diff(card.final_loss, cpu.final_loss)
    require(d <= tol, f"{label}: final loss {card.final_loss} vs CPU "
                      f"{cpu.final_loss} beyond {tol}")
    margins = [diff(l, thr_cpu) for _, l in rec_cpu[1:]]
    return max(worst, d), f"equal plans; least CPU margin {min(margins):.3g}"


def search_lenet(torch, dev):
    """Part 1: the LeNet-5 sweep at the JAX defaults, card and CPU."""
    from repro_torch import kernels as K
    from repro_torch.configs.lenet5 import CONFIG
    from repro_torch.search import sensitivity as S

    sweep = S.SweepConfig()
    out = {}
    for where in ("card", "cpu"):
        K.reset_launch_counts()
        out[where] = _recording_sweep(
            S, lambda: S.make_lenet_probe(
                sweep, device=dev if where == "card" else "cpu")[0], sweep,
            CONFIG.num_layers - 2)
        if where == "card":
            counts = K.launch_counts()
            require(counts == NO_LAUNCHES, f"search LeNet: the plain probes "
                                           f"launched {counts}")
    (card, rec_card, t_card), (cpu, rec_cpu, t_cpu) = out["card"], out["cpu"]
    for (s, l) in rec_card:
        require(math.isfinite(l), f"search LeNet: probe {s} loss {l}")
    worst, found = _same_plan("search LeNet", card, cpu, rec_card, rec_cpu,
                              SEARCH_LENET_LOSS_TOL, rel=False)
    say(f"search LeNet (784-256x4-10, {card.num_layers} groups, grid "
        f"{len(sweep.grid)}, {sweep.probe_steps} steps a probe): card "
        f"{card.describe()}; CPU {cpu.describe()}; {card.probes} probes on "
        f"the card in {t_card:.2f} s, {cpu.probes} on the CPU in "
        f"{t_cpu:.2f} s; largest gated |d| {worst:.3g} (tol "
        f"{SEARCH_LENET_LOSS_TOL}); {found}")
    return dict(run="search/lenet", counts=counts, probes=card.probes,
                probes_cpu=cpu.probes, seconds=t_card, seconds_cpu=t_cpu,
                ms_per_probe_step=1e3 * t_card / (card.probes
                                                  * sweep.probe_steps),
                plan=card.to_json(), plan_cpu=cpu.to_json(),
                probe_losses=[l for _, l in rec_card],
                probe_losses_cpu=[l for _, l in rec_cpu],
                max_gated_diff=worst, tol=SEARCH_LENET_LOSS_TOL,
                comparison=found)


def search_driver(torch, dev):
    """Part 2: ``launch.train.main`` with --bit-search at full width, in a
    temporary working directory (the plans land under its artifacts/)."""
    import contextlib
    import shutil
    import tempfile

    from repro_torch import kernels as K
    from repro_torch.launch import train
    from repro_torch.search.export import load_serve_plan
    from repro_torch.search.plan import BitPlan

    work = pathlib.Path(tempfile.mkdtemp(prefix="chip-smoke-search-"))
    cwd = os.getcwd()
    tee = _Tee(sys.stdout)
    try:
        os.chdir(work)
        K.reset_launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(tee):
            losses = train.main(SEARCH_DRIVER_ARGS)
        seconds = time.perf_counter() - t0
        counts = K.launch_counts()
        plan = BitPlan.load(str(work / "artifacts" / "bit_plan.json"))
        serve_plan = load_serve_plan(str(work / "artifacts"
                                         / "bit_plan_serve.json"))
    finally:
        os.chdir(cwd)
        shutil.rmtree(work, ignore_errors=True)
    text = tee.text()
    m = PLAN_LINE.search(text)
    require(m is not None and "[bit-search] baseline loss" in text,
            f"search driver: no sweep log or plan line: {text[-2000:]}")
    probes, sweep_s = int(m[1]), float(m[2])
    require(plan.probes == probes and plan.describe() == m[3].strip(),
            f"search driver: bit_plan.json {plan.describe()} ({plan.probes} "
            f"probes) against the log's {m[3]} ({probes})")
    require(len(serve_plan.layers) == plan.num_layers == TRAIN_LM_LAYERS,
            f"search driver: serve plan of {len(serve_plan.layers)} layers")
    require("[train] train<->serve int8 parity: OK" in text,
            f"search driver: parity line {text[-1500:]}")
    probe_losses = [float(v) for line in text.splitlines()
                    if line.startswith("[bit-search]")
                    for v in PROBE_LOSS.findall(line)]
    require(len(probe_losses) == probes
            and all(math.isfinite(v) for v in probe_losses),
            f"search driver: probe losses {probe_losses} ({probes} probes)")
    require(len(losses) == SEARCH_TRAIN_STEPS
            and all(math.isfinite(v) for v in losses),
            f"search driver: training losses {losses}")
    steps = probes * SEARCH_PROBE_STEPS + SEARCH_TRAIN_STEPS
    want = {name: TRAIN_LM_LAUNCHES[name] * steps for name in SOURCES}
    want["decode_prologue"] = 1   # the export's prologue check
    require(counts == want, f"search driver: launches {counts}, expected "
                            f"{want} ({probes} probes x "
                            f"{SEARCH_PROBE_STEPS} + {SEARCH_TRAIN_STEPS})")
    ms = 1e3 * sweep_s / (probes * SEARCH_PROBE_STEPS)
    say(f"search driver (qwen1.5-0.5b, 24 layers, int8, --bit-search 2, "
        f"{SEARCH_PROBE_STEPS} steps a probe): {plan.describe()}; probes "
        f"{probes}, sweep {sweep_s:.1f} s, {ms:.1f} ms a probe step, "
        f"{seconds:.1f} s in all; parity OK; launches {counts}")
    return dict(run="search/driver", counts=counts, probes=probes,
                sweep_seconds=sweep_s, ms_per_probe_step=ms, seconds=seconds,
                plan=plan.to_json(), probe_losses=probe_losses,
                losses=losses), plan


def search_export(torch, dev, plans):
    """Part 3: ``verify_train_serve_parity`` on the card, once a plan."""
    from repro_torch import kernels as K
    from repro_torch.search.export import verify_train_serve_parity

    out = []
    for label, plan in plans:
        K.reset_launch_counts()
        t0 = time.perf_counter()
        res = verify_train_serve_parity(plan, device=dev)
        secs = time.perf_counter() - t0
        counts = K.launch_counts()
        diffs = {k: v for k, v in res.items() if k.endswith("_diff")}
        require(res["ok"] and all(v == 0 for v in diffs.values()),
                f"search export {label}: {res}")
        require(counts == dict(NO_LAUNCHES, decode_prologue=1),
                f"search export {label}: launches {counts}")
        say(f"search export {label} ({plan.num_layers} layers): ok, every "
            f"diff 0 {diffs}, {secs:.3f} s, launches {counts}")
        out.append(dict(run=f"search/export/{label}", counts=counts,
                        seconds=secs, result=res))
    return out


def search_phase(torch, dev):
    """Parts 1-3 of the search phase (module docstring); part 4 runs in
    ``train_driver``."""
    import gc

    from repro_torch.search.plan import plan_from_formats

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    runs = [search_lenet(torch, dev)]
    drv, plan = search_driver(torch, dev)
    runs.append(drv)
    runs += search_export(torch, dev, [
        ("driver-plan", plan),
        ("EXPORT_PLAN", plan_from_formats(list(EXPORT_FORMATS)))])
    secs = time.perf_counter() - t0
    say(f"search: {secs:.1f} s")
    return runs, secs


# ---------------------------------------------------------------------------
# the summary line
# ---------------------------------------------------------------------------

def kernel_rows(torch, dev, gen):
    """Phase 3: every timed row of every kernel."""
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.int32, device=dev)
    one = torch.zeros(1, device=dev)
    say(f"timer floor: {time_ms(lambda: one.zero_(), torch, flush):.5f}"
        " ms for a one-element fill, the least any row can read")
    rows = check_fxp_matmul(torch, dev, flush, gen)
    rows += check_decode_prologue(torch, dev, flush, gen)
    rows += check_paged_attention(torch, dev, flush, gen)
    rows += check_fxp_matmul_lenet(torch, dev, flush, gen)
    rows += check_bp_gstep(torch, dev, flush, gen)
    rows += check_sgd_dw_update(torch, dev, flush, gen)
    rows += check_sgd_dw_update_dense(torch, dev, flush, gen)
    rows += check_bp_fused_unit(torch, dev, flush, gen)
    for units in (ENGINE_UNITS, ZAMBA2_ENGINE_UNITS, MIXTRAL_ENGINE_UNITS):
        rows += check_engine_units(torch, dev, flush, gen, units)
    return rows


HEADLINE = {"fxp_matmul": ("int8/int8/bits=off/identity", f"{B}x{D}x{FF}"),
            "bp_gstep": ("int8/bits=on/relu", "T128 Dout10 Din256"),
            "sgd_dw_update": ("int8/w_in/w_bits=None", "T128 Din784 Dout256"),
            "bp_fused_unit": ("int8/w_bits=(2, 12) absmax",
                              "T128 Din256 Dout256"),
            "decode_prologue": ("int8/bfloat16",
                                f"B{B} D{D} H{H} Hkv{HKV} hd{HD} bias rope"),
            "paged_attention": ("bfloat16/pool=int8", None)}


def summarize(rows, runs):
    kernels = []
    for name, (source, replaces) in SOURCES.items():
        mine = [r for r in rows if r["name"] == name]
        variant, shape = HEADLINE[name]
        head = next(r for r in mine if r["variant"] == variant
                    and (shape is None or r["shape"] == shape))
        launches = sum(run["counts"][name] for run in runs)
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches, max_abs_err=head["max_abs_err"],
            max_err=head["max_abs_err"], tol=head["tol"], ms=head["ms"],
            plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
            bound_by=head["bound_by"], library_ms=head["library_ms"],
            headline=f"{variant} {head['shape']}",
            launches_by_run={run["run"]: run["counts"][name]
                             for run in runs},
            variants=[{k: v for k, v in r.items() if k != "name"}
                      for r in mine]))
    return kernels


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma-separated subset of {PHASES}")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
    phases = [p for p in args.phases.split(",") if p]
    require(set(phases) <= set(PHASES), f"unknown phase in {phases}")

    import torch
    require(torch.cuda.is_available(), "CUDA is not available")
    require((SRC / "repro_torch" / "__init__.py").is_file(),
            f"no port package under {SRC}")
    sys.path.insert(0, str(SRC))
    import repro_torch
    require(pathlib.Path(repro_torch.__file__).resolve().is_relative_to(SRC),
            f"repro_torch imported from {repro_torch.__file__}, not {SRC}")
    from repro_torch import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0].strip()
    kind = torch.cuda.get_device_name(0)
    say(f"device: {kind} | nvidia-smi: {smi} | torch {torch.__version__} "
        f"CUDA {torch.version.cuda} | python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    _build.build_all()
    phase_s = {"device": t0 - t_start, "build": time.perf_counter() - t0}
    say(f"build: {phase_s['build']:.2f} s")
    for name in _build.SOURCES:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                say(f"  ptxas {name}: {line.strip()}")

    rows, runs = [], []
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def timed(name, fn):
        t = time.perf_counter()
        out = fn()
        phase_s[name] = time.perf_counter() - t
        return out

    def dump(**parts):
        print(json.dumps(parts, default=str), flush=True)

    if "kernels" in phases:
        rows += timed("kernels", lambda: kernel_rows(torch, dev, gen))
    if "edges" in phases:
        timed("edges", lambda: check_edges(torch, dev, gen))
    if "serve" in phases:
        def serve():
            out = serve_runs(torch)
            parity = decode_parity(torch, dev)
            out.append(serve_contiguous(torch, dev))
            return out, parity
        serve_out, parity = timed("serve", serve)
        runs += serve_out
        dump(serve=serve_out, decode_parity=parity)
    if "serve_ssm" in phases:
        ssm_runs, ssm_par, ssm_s = timed("serve_ssm",
                                         lambda: serve_ssm(torch, dev))
        runs += ssm_runs
        dump(serve_ssm=ssm_runs, ssm_parity=ssm_par, seconds=ssm_s)
    if "train" in phases:
        train, train_par = timed("train", lambda: train_runs(torch, dev))
        runs += train
        dump(train=train, train_parity=train_par)
    if "noise" in phases:
        dump(noise=timed("noise", lambda: check_noise(torch, dev)))
    if "train_lm" in phases:
        def train_lm():
            out = train_lm_runs(torch, dev)
            out.append(train_lm_stochastic(torch, dev))
            return out, train_lm_parity(torch, dev)
        lm_runs, lm_par = timed("train_lm", train_lm)
        runs += lm_runs
        dump(train_lm=lm_runs, train_lm_parity=lm_par)
    if "train_ssm" in phases:
        ssm_train, ssm_train_par, ssm_train_s = timed(
            "train_ssm", lambda: train_ssm(torch, dev))
        runs += ssm_train
        dump(train_ssm=ssm_train, train_ssm_parity=ssm_train_par,
             seconds=ssm_train_s)
    if "moe" in phases:
        moe_runs, moe_serve_par, moe_train_par, moe_s = timed(
            "moe", lambda: moe_phase(torch, dev))
        runs += moe_runs
        dump(moe=moe_runs, moe_serve_parity=moe_serve_par,
             moe_train_parity=moe_train_par, seconds=moe_s)
    if "mla" in phases:
        mla_runs, mla_serve_par, mla_train_par, mla_s = timed(
            "mla", lambda: mla_phase(torch, dev))
        runs += mla_runs
        dump(mla=mla_runs, mla_serve_parity=mla_serve_par,
             mla_train_parity=mla_train_par, seconds=mla_s)
    if "search" in phases:
        search_runs, search_s = timed("search",
                                      lambda: search_phase(torch, dev))
        runs += search_runs
        dump(search=search_runs, seconds=search_s)
    if "train_driver" in phases:
        drv = timed("train_driver", lambda: train_driver(torch, dev))
        runs.append(drv)
        dump(train_driver=drv)
    phase_s["total"] = time.perf_counter() - t_start
    say("phase seconds: " + ", ".join(f"{k} {v:.1f}"
                                      for k, v in phase_s.items()))
    require("jax" not in sys.modules and "repro" not in sys.modules,
            "the port pulled in jax or the JAX package")
    if set(phases) != set(PHASES):
        say(f"ran phases {phases} only: no result line")
        return 3
    kernels = summarize(rows, runs)
    for k in kernels:
        require(k["launches"] > 0, f"{k['name']}: never launched on a path")
        for key in ("ms", "plain_ms", "bound_ms", "max_abs_err"):
            require(isinstance(k[key], float) and math.isfinite(k[key]),
                    f"{k['name']}: {key} = {k[key]}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        say(f"FAILED: {e}")
        sys.exit(1)
