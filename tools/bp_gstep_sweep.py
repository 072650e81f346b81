#!/usr/bin/env python3
"""Time bp_gstep's launch plans on one CUDA card, to check the constants of
``kernels/bp_gstep.py::_plan`` there: the short path at each row count a
CTA (the LeNet head: Dout 10, Din 256, T 128 and 1024), and the tiled path
at each Dout split count (a LeNet hidden layer's dx at T 128 and 1024, a
2816-wide one, and qwen1.5-0.5b's MLP up-projection at T 2048), each line
with the plan's own choice and, for f32, ``g @ w.T`` beside it.

    python3 tools/bp_gstep_sweep.py        # from the repo root, on the card

Times are ``chip_smoke.time_ms`` medians (L2 evicted before each launch);
the first line is the card's name and power limit.  Exits 1 without CUDA.
"""
from __future__ import annotations

import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

SHORT = ((128, 256, 10), (1024, 256, 10))                 # (T, Din, Dout)
TILED = ((128, 256, 256), (1024, 256, 256), (128, 2816, 2816),
         (2048, 1024, 2816))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("bp_gstep_sweep: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels import bp_gstep as GS
    from repro_torch.kernels.common import sm_count
    from repro_torch.quant.int8 import quantize_int8_absmax

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    n_sm = sm_count(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    flush = torch.empty(cs.FLUSH_BYTES // 4, dtype=torch.int32, device=dev)
    for t, din, dout in SHORT + TILED:
        g = 0.01 * torch.randn((t, dout), generator=gen, device=dev)
        w = torch.randn((din, dout), generator=gen, device=dev) * dout ** -0.5
        z = torch.randn((t, din), generator=gen, device=dev)
        (qg, sg), (qw, sw) = quantize_int8_absmax(g), quantize_int8_absmax(w)
        for dp, a, b, s in (("emulate", g, w, None),
                            ("int8", qg, qw, (sg * sw).reshape(1))):
            for zz, bits, act in ((None, None, "identity"),
                                  (z, (2, 12), "relu")):
                tensors = (a, b) if zz is None else (a, b, zz)
                if dout < GS.SHORT_DOUT:
                    plans = [GS._plan(t, din, dout, n_sm, dp, rows=r)
                             for r in GS.SHORT_ROWS]
                    label = "rows"
                else:
                    nt = -(-dout // GS.TILE_K[dp])
                    plans = [GS._plan(t, din, dout, n_sm, dp, splits=k)
                             for k in (1, 2, 4, 8) if k <= nt]
                    label = "splits"
                times = []
                for p in plans:
                    ms = cs.time_ms(lambda: GS._launch(
                        a, b, zz, bits, act, dp, s, tensors, p), torch, flush)
                    times.append(f"{getattr(p, label)}: {ms:.4f}")
                own = GS._plan(t, din, dout, n_sm, dp)
                lib = ""
                if dp == "emulate" and zz is None:
                    ms = cs.time_ms(lambda: a @ b.T, torch, flush)
                    lib = f" | g @ w.T {ms:.4f}"
                print(f"T{t} Din{din} Dout{dout} {dp} {act}: plan {label} "
                      f"{getattr(own, label)} | ms by {label} "
                      + ", ".join(times) + lib, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
