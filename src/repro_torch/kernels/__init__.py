"""The port's kernels: hand-written CUDA for Hopper beside plain PyTorch.

  fxp_matmul       -- forward PE op y = f(q_a(X) @ q_w(W)), emulate and int8
  bp_gstep         -- G-chain step G_i = q_g((G @ Wᵀ) ⊙ f'(Z))   (Eq. 8)
  sgd_dw_update    -- fused W_new = q_w(W - lr XᵀG)             (Eq. 9 + 1)
  bp_fused_unit    -- the whole TDM frame: Eq. 8, 9 and 1 in one launch
  decode_prologue  -- RMSNorm + QKV projection + RoPE for one decode token
  paged_attention  -- decode attention over the paged KV pool

Each wrapper (``WRAPPERS``, by kernel name) launches its CUDA kernel
(``csrc/``) for CUDA tensors, runs its plain PyTorch version for CPU
tensors, and counts its launches in ``<wrapper>.launches``.  ``ops`` holds
the kernel-backend knob, the ``*_op`` entry points and the tune cache of
the launches (``tune_*``, ``prime_tune_cache``).
"""
from repro_torch.kernels import (bp_fused_unit, bp_gstep, decode_prologue,
                                 fxp_matmul, ops, paged_attention,
                                 sgd_dw_update)

WRAPPERS = {"fxp_matmul": fxp_matmul.fxp_matmul,
            "bp_gstep": bp_gstep.bp_gstep,
            "sgd_dw_update": sgd_dw_update.sgd_dw_update,
            "bp_fused_unit": bp_fused_unit.bp_fused_unit,
            "decode_prologue": decode_prologue.fused_prologue,
            "paged_attention": paged_attention.paged_attention}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


__all__ = ["WRAPPERS", "bp_fused_unit", "bp_gstep", "decode_prologue",
           "fxp_matmul", "launch_counts", "ops", "paged_attention",
           "reset_launch_counts", "sgd_dw_update"]
