#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py            # every phase; needs one CUDA card

Phases (any failure exits non-zero before the result line is printed):

1. device   -- the card's name and power limit (nvidia-smi), torch and CUDA
               versions.
2. build    -- nvcc builds every kernel of ``src/repro_torch/csrc`` (one
               process per source, all at once) into ``build/kernels``.
3. kernels  -- each kernel against its plain PyTorch version on the card, at
               the full-width decode shapes of qwen1.5-0.5b (8 slots), for
               both datapaths and both compute dtypes, with the tolerance
               stated beside each check.  Times are CUDA-event medians of 25
               launches after warm-up, each launch after a write of 128 MB
               that evicts the 50 MB L2 (the decode path reads every weight
               cold).  ``library_ms`` times one PyTorch call that computes the
               same function, as a yardstick; the port never calls it.
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
5. summary  -- one ``{"kernels": [...]}`` line, the card's line, and last
               ``{"ok": true, "device": {...}}``.

``--phases`` picks a subset (for example ``--phases device,build,kernels``);
the result line is printed only when every phase ran.  The script imports
nothing of JAX nor of the JAX package ``repro``.
"""
from __future__ import annotations

import argparse
import json
import math
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"
PHASES = ("device", "build", "kernels", "serve")

HBM_BYTES_PER_S = 3.35e12                     # H100 SXM HBM3
PEAK_OPS = {"float32": 67e12, "bfloat16": 989e12, "int8": 1979e12}
FLUSH_BYTES = 128 << 20                       # > the 50 MB L2
REPS, WARM = 25, 3

# qwen1.5-0.5b decode widths (configs/qwen1_5_0_5b.py), 8 slots
B, D, H, HKV, HD, FF = 8, 1024, 16, 16, 64, 2816
BS, M = 16, 32                                # block size, blocks per slot

SOURCES = {
    "fxp_matmul": ("src/repro_torch/csrc/fxp_matmul.cu",
                   "src/repro/kernels/fxp_matmul.py:138"),
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
    write of ``flush`` that evicts L2."""
    for _ in range(WARM):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        flush.zero_()
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
    shapes = [(B, D, FF), (B, FF, D), (5, 1000, 333)]
    # datapath, x dtype, (xa_bits, w_bits, out_bits), act
    variants = [
        ("emulate", torch.float32, (None, None, None), "identity"),
        ("emulate", torch.bfloat16, (None, None, None), "identity"),
        ("emulate", torch.float32, ((4, 10), (2, 12), (4, 10)), "silu"),
        ("int8", torch.int8, (None, None, None), "identity"),
        ("int8", torch.int8, (None, None, (4, 10)), "silu"),
    ]
    for (m, k, n) in shapes:
        x = torch.randn((m, k), generator=gen, device=dev)
        w = torch.randn((k, n), generator=gen, device=dev) * k ** -0.5
        qx, sx = quantize_int8_absmax(x)
        qw, sw = quantize_int8_absmax(w)
        for datapath, xdt, (xa, wb, ob), act in variants:
            if (m, k, n) == (5, 1000, 333) and ob is not None:
                continue
            kw = dict(xa_bits=xa, w_bits=wb, out_bits=ob, act=act,
                      datapath=datapath)
            if datapath == "int8":
                a, bw = qx, qw
                kw["scale"] = sx * sw
                kind, nbytes = "int8", m * k + k * n + 4 * m * n
            else:
                a, bw = x.to(xdt), w
                kind = "bfloat16" if xdt == torch.bfloat16 else "float32"
                nbytes = a.element_size() * m * k + 4 * k * n + 4 * m * n
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
            else:
                wb16 = bw.to(torch.bfloat16)
                library_ms = time_ms(lambda: torch.matmul(a, wb16), torch,
                                     flush)
                library_note = "torch.matmul bf16 (weights pre-cast)"
            bms, by = bound(nbytes, 2.0 * m * k * n, kind)
            rows.append(dict(
                name="fxp_matmul",
                variant=f"{datapath}/{str(xdt).split('.')[-1]}"
                        f"/bits={'on' if xa or ob else 'off'}/{act}",
                shape=f"{m}x{k}x{n}", max_abs_err=err, tol=tol, ms=ms,
                plain_ms=plain_ms, library_ms=library_ms,
                library=library_note, bound_ms=bms, bound_by=by))
            say(f"fxp_matmul {rows[-1]['variant']} {m}x{k}x{n}: err {err:.3g}"
                f" ({tol}) {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
                f"{library_ms if library_ms is None else round(library_ms, 4)}"
                f" ms, bound {bms:.4f} ms ({by})")
    return rows


def check_decode_prologue(torch, dev, flush, gen):
    from repro_torch.kernels.decode_prologue import (fused_prologue,
                                                     prologue_plain)
    from repro_torch.quant.int8 import quantize_int8_absmax

    rows = []
    nscale = 1.0 + 0.1 * torch.randn((D,), generator=gen, device=dev)
    ws = [torch.randn((D, nh * HD), generator=gen, device=dev) * D ** -0.5
          for nh in (H, HKV, HKV)]
    biases = tuple(0.1 * torch.randn((nh, HD), generator=gen, device=dev)
                   for nh in (H, HKV, HKV))
    pos = torch.randint(0, BS * M, (B,), generator=gen, device=dev,
                        dtype=torch.int32)
    stat = dict(use_rope=True, theta=1e6, eps=1e-6, h=H, hkv=HKV, hd=HD)
    x32 = torch.randn((B, D), generator=gen, device=dev)
    q8 = [quantize_int8_absmax(w) for w in ws]
    for dt in (torch.float32, torch.bfloat16):
        x = x32.to(dt)
        for datapath in ("emulate", "int8"):
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
            scale_ref = max(float(r.float().abs().max()) for r in ref)
            if dt == torch.float32:
                # f32 sums in another order, and cos/sin/pow of the rope
                # angle (up to 511 rad) in another library
                atol, rtol, tol = (2e-4 * scale_ref, 2e-4,
                                   "|d| <= 2e-4*max|ref| + 2e-4*|ref|")
            else:
                # the reference rounds to bf16 after the dot, after the bias
                # and after the rope: up to one bf16 ulp (2^-7 relative) at
                # each of them
                atol, rtol, tol = (2.0 ** -7 * scale_ref, 2.0 ** -6,
                                   "|d| <= 2^-7*max|ref| + 2^-6*|ref|")
            if datapath == "int8":
                # the normed row, rounded in another order, may move one
                # activation payload by one step: sx * max|w| per output
                xn = x.float() * torch.rsqrt(
                    x.float().square().mean(-1, keepdim=True) + 1e-6) * nscale
                sx = float(xn.abs().amax()) / 127.0
                step = sx * max(float(w.abs().max()) for w in ws)
                atol += 2 * step
                tol += f" + 2*sx*max|w| ({2 * step:.3g})"
            err, ok = 0.0, True
            for g_, r_ in zip(got, ref):
                e, o = compare(g_.float(), r_.float(), atol=atol, rtol=rtol)
                err, ok = max(err, e), ok and o
            require(ok, f"decode_prologue {datapath} {dt}: max err {err} "
                        f"beyond {tol}")
            ms = time_ms(lambda: run(fused_prologue), torch, flush)
            plain_ms = time_ms(lambda: run(prologue_plain), torch, flush)
            isz = x.element_size()
            nbytes = (wbytes + isz * B * D + 4 * D + 4 * B
                      + 4 * (H + 2 * HKV) * HD
                      + isz * B * (H + 2 * HKV) * HD)
            kind = "int8" if datapath == "int8" else str(dt).split(".")[-1]
            bms, by = bound(nbytes, 2.0 * B * D * (H + 2 * HKV) * HD, kind)
            rows.append(dict(
                name="decode_prologue",
                variant=f"{datapath}/{str(dt).split('.')[-1]}",
                shape=f"B{B} D{D} H{H} Hkv{HKV} hd{HD} bias rope",
                max_abs_err=err, tol=tol, ms=ms, plain_ms=plain_ms,
                library_ms=None, library="no single PyTorch call",
                bound_ms=bms, bound_by=by))
            say(f"decode_prologue {rows[-1]['variant']}: err {err:.3g} "
                f"({tol}) {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
                f"{bms:.4f} ms ({by})")
    return rows


def check_paged_attention(torch, dev, flush, gen):
    import torch.nn.functional as F

    from repro_torch.kernels.paged_attention import (gather_kv,
                                                     paged_attention,
                                                     paged_attention_plain)
    from repro_torch.serving.engine import quant_kv_rows

    rows = []
    n_blocks = 1 + B * M
    # every slot owns M blocks, in a shuffled order; slot 0 is inactive
    perm = 1 + torch.randperm(B * M, generator=gen, device=dev)
    tables = perm.reshape(B, M).to(torch.int32).contiguous()
    tables[0] = 0
    lens = torch.tensor([0, BS - 1, BS, 100, 255, 300, 400, BS * M - 1],
                        dtype=torch.int32, device=dev)
    kv = torch.randn((2, n_blocks, BS, HKV, HD), generator=gen, device=dev)
    scale = HD ** -0.5
    for dt in (torch.float32, torch.bfloat16):
        q = torch.randn((B, H, HD), generator=gen, device=dev).to(dt)
        for pool_kind in ("dt", "int8"):
            if pool_kind == "int8":
                pool = {}
                for name, t in (("k", kv[0]), ("v", kv[1])):
                    p8, s8 = quant_kv_rows(t.reshape(-1, HKV, HD))
                    pool[name] = p8.reshape(t.shape)
                    pool[f"{name}_scale"] = s8.reshape(t.shape[:2])
            else:
                pool = {"k": kv[0].to(dt).contiguous(),
                        "v": kv[1].to(dt).contiguous()}
            kw = dict(groups=H // HKV, scale=scale)
            got = paged_attention(q, pool, tables, lens, **kw)
            ref = paged_attention_plain(q, pool, tables, lens, **kw)
            torch.cuda.synchronize()
            vmax = float(kv[1].abs().max())
            kk, vv = gather_kv(pool, tables, dt)
            qs = q[:, :, None, :]                            # [B, H, 1, hd]
            ks_, vs_ = kk.transpose(1, 2), vv.transpose(1, 2)  # [B,Hkv,T,hd]
            mask = (torch.arange(M * BS, device=dev)[None, :]
                    <= lens[:, None])[:, None, None, :]
            if dt == torch.float32:
                atol, rtol = 1e-5 * vmax, 1e-5
                tol = "|d| <= 1e-5*max|v| + 1e-5*|ref| (f32 sums, exp)"
            else:
                # both sides round P to bf16 from f32 scores summed in
                # another order and exp'd in another library, so a weight
                # near a rounding tie may land one bf16 ulp (<= 2^-7 P)
                # away: allow one such weight per row, at the row's largest
                # P and max|v|; then each side rounds the output to bf16,
                # one ulp (<= 2^-7 |ref|) apart
                s = torch.einsum("bhd,bhtd->bht", qs[:, :, 0].float(),
                                 ks_.repeat_interleave(H // HKV, 1).float())
                pmax = torch.softmax(
                    (s * scale).masked_fill(~mask[:, :, 0], -math.inf),
                    dim=-1).amax(-1)                               # [B, H]
                atol = (2.0 ** -7 * vmax * pmax.double())[..., None]
                rtol = 2.0 ** -7
                tol = ("|d| <= 2^-7*max_t(P)*max|v| + 2^-7*|ref| (one bf16 P "
                       "ulp per row, one output ulp)")
            err, ok = compare(got.float(), ref.float(), atol=atol, rtol=rtol)
            require(ok, f"paged_attention {dt} pool={pool_kind}: max err "
                        f"{err} beyond {tol}")
            ms = time_ms(lambda: paged_attention(q, pool, tables, lens, **kw),
                         torch, flush)
            plain_ms = time_ms(
                lambda: paged_attention_plain(q, pool, tables, lens, **kw),
                torch, flush)
            # yardstick: SDPA over K/V already gathered and dequantized
            library_ms = time_ms(
                lambda: F.scaled_dot_product_attention(qs, ks_, vs_,
                                                       attn_mask=mask,
                                                       scale=scale),
                torch, flush)
            nvalid = torch.clamp(lens.long() + 1, max=M * BS)
            tok = float(nvalid.sum())
            el = pool["k"].element_size()
            nbytes = (2 * tok * HKV * HD * el
                      + (2 * 4 * tok if pool_kind == "int8" else 0)
                      + 2 * q.numel() * q.element_size() + 4 * B * (M + 1))
            bms, by = bound(nbytes, 4.0 * tok * H * HD,
                            str(dt).split(".")[-1])
            rows.append(dict(
                name="paged_attention",
                variant=f"{str(dt).split('.')[-1]}/pool={pool_kind}",
                shape=f"B{B} bs{BS} M{M} H{H} Hkv{HKV} hd{HD} "
                      f"lens={lens.tolist()}",
                max_abs_err=err, tol=tol, ms=ms, plain_ms=plain_ms,
                library_ms=library_ms,
                library="F.scaled_dot_product_attention on gathered K/V",
                bound_ms=bms, bound_by=by))
            say(f"paged_attention {rows[-1]['variant']}: err {err:.3g} "
                f"({tol}) {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
                f"{library_ms:.4f} ms, bound {bms:.4f} ms ({by})")
    return rows


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
PROFILE_GROUPS = (("fxp_matmul", "fxp_"), ("decode_prologue", "prologue_"),
                  ("paged_attention", "paged_attention_"))


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
        for name, n in counts.items():
            require(n > 0, f"serve {backend}: kernel {name} never launched")
        steps = report["decode_steps"]
        rec = dict(backend=backend, cache=cache, counts=counts,
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
                        profile=profile_decode(
                            torch, lambda: E.paged_decode_step(
                                params, cfg, pool, tables.to(dev),
                                lens.to(dev), toks.to(dev), "kernel"),
                            backend, dev)))
    return out


def profile_decode(torch, step, backend, dev):
    """Where a decode step's time goes: the step's wall time (host clock,
    synchronised, without the profiler, whose own overhead inflates it),
    then device time by kernel over as many steps under torch.profiler,
    and the device's idle share.  Returns {"not measured": why} when the
    profiler records no device activity."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import ops as kops

    with kops.kernel_backend_ctx(backend, dev):
        step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(PROFILE_STEPS):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / PROFILE_STEPS
        # only the profiler's own calls are guarded: a failing step ends
        # the run
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        try:
            prof.start()
        except RuntimeError as e:
            say(f"profile {backend}: torch.profiler failed to start: {e}")
            return {"not measured": f"torch.profiler failed to start: {e}"}
        for _ in range(PROFILE_STEPS):
            step()
        torch.cuda.synchronize()
        try:
            prof.stop()
            events = prof.events()
        except RuntimeError as e:
            say(f"profile {backend}: torch.profiler failed: {e}")
            return {"not measured": f"torch.profiler failed: {e}"}
    by_name = {}
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + e.time_range.elapsed_us() / 1e3)
    if not by_name:
        say(f"profile {backend}: the profiler saw no device time")
        return {"not measured": "no device events in torch.profiler"}
    groups = {}
    for name, ms in by_name.items():
        key = next((k for k, tag in PROFILE_GROUPS if tag in name), "other")
        groups[key] = groups.get(key, 0.0) + ms / PROFILE_STEPS
    busy = sum(groups.values())
    top = sorted(((ms / PROFILE_STEPS, n[:60]) for n, ms in by_name.items()
                  if not any(tag in n for _, tag in PROFILE_GROUPS)),
                 reverse=True)[:6]
    res = {"wall_ms_per_step": wall_ms, "device_ms_per_step": busy,
           "idle_share": max(0.0, 1.0 - busy / wall_ms),
           "device_ms_by_group": groups,
           "top_other_ms": [[n, ms] for ms, n in top]}
    say(f"profile {backend}: {wall_ms:.2f} ms/step wall, device busy "
        f"{busy:.2f} ms ({100 * res['idle_share']:.1f}% idle); by group "
        + ", ".join(f"{k} {v:.2f}" for k, v in sorted(groups.items()))
        + "; top other: "
        + ", ".join(f"{n} {ms:.2f}" for ms, n in top[:4]))
    return res


def _tree_cpu(tree):
    return {k: _tree_cpu(v) if isinstance(v, dict) else v.cpu()
            for k, v in tree.items()}


# ---------------------------------------------------------------------------
# the summary line
# ---------------------------------------------------------------------------

HEADLINE = {"fxp_matmul": ("int8/int8/bits=off/identity", f"{B}x{D}x{FF}"),
            "decode_prologue": ("int8/bfloat16", None),
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
            launches_by_run={f"{run['backend']}/{run['cache']}":
                             run["counts"][name] for run in runs},
            variants=[{k: v for k, v in r.items() if k != "name"}
                      for r in mine]))
    return kernels


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma-separated subset of {PHASES}")
    args = ap.parse_args(argv)
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
    say(f"build: {time.perf_counter() - t0:.2f} s")
    for name in _build.SOURCES:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                say(f"  ptxas {name}: {line.strip()}")

    rows, runs = [], []
    if "kernels" in phases:
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.int32, device=dev)
        rows += check_fxp_matmul(torch, dev, flush, gen)
        rows += check_decode_prologue(torch, dev, flush, gen)
        rows += check_paged_attention(torch, dev, flush, gen)
        del flush
    if "serve" in phases:
        runs = serve_runs(torch)
        parity = decode_parity(torch, dev)
        print(json.dumps({"serve": runs, "decode_parity": parity},
                         default=str), flush=True)
    require("jax" not in sys.modules and "repro" not in sys.modules,
            "the port pulled in jax or the JAX package")
    if set(phases) != set(PHASES):
        say(f"ran phases {phases} only: no result line")
        return 3
    kernels = summarize(rows, runs)
    for k in kernels:
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
