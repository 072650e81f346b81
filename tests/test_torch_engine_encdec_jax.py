"""Port parity of the TaxoNN layer engine on the encdec family against the
JAX package's engine run op by op (``jax.disable_jit``), int8 backend
(plain versions), round to nearest and stochastic: the config,
weights, batch and step of ``tests/test_torch_engine_encdec.py`` (kept
apart from it so that each file stays about a minute on the CPU; JAX op
by op compiles each primitive once a process, ~40 s for the first step).

JAX runs op by op because, jitted, its int8 rescale rounds
``acc * (s_x * s_w)`` one ulp from the op-by-op formula (ROADMAP, "Facts
about the reference"): on the encdec batch the jitted loss moves by 4.5e-4
against its own op-by-op run, which the port matches to 3e-7.

Tolerances:
  * the decoder's and the boundary's leaves: the f32 rule of
    ``tests/test_torch_engine.py`` (|d| <= 2e-6 + 1e-5|ref|, or one more
    lr*2^-12 on at most 1% of the elements); loss rel 1e-6, grad_norm rel
    1e-3.
  * the encoder's leaves: the relative L2 of each leaf's update,
    |new - ref| / |ref - p0|, within 0.05 (observed <= 0.0155, on the
    encoder's wk; 2.5e-5 in this file's round-to-nearest case, 0.0145 in
    another process where JAX's matmul precision was left at its
    default).  The gradient enters the encoder unquantized (dS summed
    over the decoder's layers, through ``enc_norm``'s VJP), and the int8
    dx quantizes it by its absmax: the head's and the layer norms' VJPs
    sum in other orders on each side (|d| ~1e-5 on every element of dS),
    and one ulp on the absmax element moves every payload of that operand
    (as ``tests/test_torch_engine_moe_jax.py`` finds for the moe's dz).
"""
import sys

import numpy as np
import pytest

sys.path.insert(0, __file__.rsplit("/", 1)[0])
from test_torch_engine import GRID  # noqa: E402
from test_torch_engine_jax import _grid_close  # noqa: E402
from test_torch_engine_encdec import (LR, _leaves, jax_step,  # noqa: E402
                                      port_step)
from test_torch_encdec import _one_thread  # noqa: E402,F401 (autouse)

ENC_UPDATE_REL = 0.05


@pytest.mark.parametrize("family,stochastic", [
    ("encdec", False), ("encdec", True)])
def test_taxonn_int8_step_matches_jax_op_by_op(family, stochastic):
    ref, ref_m = jax_step(family, "int8", "momentum", stochastic, jit=False)
    new, m, p0 = port_step(family, "int8", "momentum", stochastic)
    assert float(m["loss"]) == pytest.approx(ref_m["loss"], rel=1e-6)
    assert float(m["grad_norm"]) == pytest.approx(ref_m["grad_norm"],
                                                  rel=1e-3)
    leaves, w0 = _leaves(new), dict(_leaves(p0))
    assert len(leaves) == len(ref)
    encoder = []
    for (k, g), r in zip(leaves, ref):
        g = g.numpy()
        assert g.shape == r.shape and g.dtype == r.dtype, k
        if k.startswith("enc_blocks/"):
            w = w0[k].numpy()
            rel = np.linalg.norm(g - r) / np.linalg.norm(r - w)
            encoder.append(k)
            assert rel <= ENC_UPDATE_REL, (k, rel)
        else:
            assert _grid_close(g, r, 2e-6, 1e-5, LR * GRID), (
                k, np.abs(g - r).max())
    assert len(encoder) == (10 if family == "encdec" else 0)
