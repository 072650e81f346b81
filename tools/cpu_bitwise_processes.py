#!/usr/bin/env python3
"""Count the fresh CPU processes that compute other bits than the rest.

Each probe runs in ``--runs`` fresh interpreters with two intra-op threads,
16 at a time, and prints how many runs gave each distinct result:

  exp    after a few float32 matmuls, the process's first exp of a
         131072-element tensor right after a parallel op on it, as in
         ``logsumexp`` (PyTorch hands the exp to MKL's vector math, split
         over the threads); ``--warm`` first makes one single-element
         exp, as ``repro_torch/__init__.py`` does at import
  step   one TaxoNN engine step of the train driver's reduced
         qwen1.5-0.5b, as the kill drills run it (``--reduced``, seq 32,
         batch 8, ``--quantize``, kernel backend off, momentum): its loss
         and grad norm, with the ``repro_torch`` under ``--src`` (default
         this checkout's ``src``; give a parent's ``src`` to compare)

    python3 tools/cpu_bitwise_processes.py exp --runs 600 [--warm]
    python3 tools/cpu_bitwise_processes.py step --runs 800 [--src DIR]

Runs on the CPU only; a bitwise check across processes (the driver's kill
and resume) needs one distinct result.
"""
from __future__ import annotations

import argparse
import collections
import concurrent.futures
import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]

EXP_CHILD = """
import sys, hashlib, numpy as np, torch
if {warm}:
    torch.exp(torch.zeros(1))
rng = np.random.default_rng(0)
for m, k, n in ((256, 128, 128), (256, 128, 512), (128, 256, 512)):
    a = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32))
    a @ b
v = torch.from_numpy(rng.standard_normal((8, 32, 512)).astype(np.float32))
e = torch.exp(v - torch.amax(v, -1, keepdim=True))
print(hashlib.sha1(e.numpy().tobytes()).hexdigest())
"""

STEP_CHILD = """
import sys, dataclasses
sys.path.insert(0, {src!r})
from repro_torch.configs import get_config
from repro_torch.core import (QuantPolicy, StepOptions, default_bits,
                              make_train_step)
from repro_torch.core.steps import init_train_state
from repro_torch.data import SyntheticLMDataset
from repro_torch.launch.train import _reduce
from repro_torch.models import lm
from repro_torch.optim import Hyper, OptimizerConfig
cfg = _reduce(get_config("qwen1.5-0.5b"))
ocfg = OptimizerConfig(kind="momentum", grad_clip=1.0)
policy = dataclasses.replace(QuantPolicy(grad_scale=64.0),
                             kernel_backend="off")
step = make_train_step(cfg, policy, ocfg, StepOptions(), device="cpu")
p = lm.init_params(cfg, seed=0, device="cpu")
batch = SyntheticLMDataset(cfg.vocab_size, 32, 8).batch_at(0)
_, _, m = step(p, init_train_state(p, ocfg), batch, Hyper(lr=3e-3, step=0),
               default_bits(cfg, enabled=True))
print(repr(float(m["loss"])), repr(float(m["grad_norm"])))
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("probe", choices=["exp", "step"])
    ap.add_argument("--runs", type=int, default=400)
    ap.add_argument("--warm", action="store_true")
    ap.add_argument("--src", default=str(ROOT / "src"))
    args = ap.parse_args(argv)
    code = (EXP_CHILD.format(warm=args.warm) if args.probe == "exp"
            else STEP_CHILD.format(src=args.src))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "2"

    def one(_):
        out = subprocess.run([sys.executable, "-c", code], env=env,
                             capture_output=True, text=True, timeout=600)
        return out.stdout.strip() or f"exit {out.returncode}"

    with concurrent.futures.ThreadPoolExecutor(16) as ex:
        results = collections.Counter(ex.map(one, range(args.runs)))
    print(f"{args.probe}{' --warm' if args.warm else ''} "
          f"({args.src if args.probe == 'step' else 'torch only'}): "
          f"{args.runs} processes, {len(results)} distinct result(s)")
    for res, n in results.most_common():
        print(f"  {n:5d}  {res[:80]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
