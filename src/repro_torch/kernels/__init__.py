"""The port's kernels: hand-written CUDA for Hopper beside plain PyTorch.

  fxp_matmul       -- forward PE op y = f(q_a(X) @ q_w(W)), emulate and int8
  decode_prologue  -- RMSNorm + QKV projection + RoPE for one decode token
  paged_attention  -- decode attention over the paged KV pool

Each wrapper (``WRAPPERS``, by kernel name) launches its CUDA kernel (``csrc/``) for CUDA
tensors, runs its plain PyTorch version for CPU tensors, and counts its
launches in ``<wrapper>.launches``.  ``ops`` holds the kernel-backend knob.
"""
from repro_torch.kernels import decode_prologue, fxp_matmul, ops, paged_attention

WRAPPERS = {"fxp_matmul": fxp_matmul.fxp_matmul,
            "decode_prologue": decode_prologue.fused_prologue,
            "paged_attention": paged_attention.paged_attention}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


__all__ = ["WRAPPERS", "decode_prologue", "fxp_matmul", "launch_counts",
           "ops", "paged_attention", "reset_launch_counts"]
