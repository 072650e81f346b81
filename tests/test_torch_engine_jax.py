"""Port parity of the TaxoNN layer engine against the JAX package's engine
(``repro.core``) with quantization on: one step of the port's taxonn step
against JAX's, for the configs, parameters, batches and tolerances stated
in ``tests/test_torch_engine.py`` (kept apart from it so that each file
stays well under a minute on the CPU: the bf16 case runs JAX op by op).
"""
import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import QuantPolicy as JQP
from repro.core import make_train_step as j_make
from repro.core.steps import default_bits as j_bits
from repro.core.steps import init_train_state as j_init
from repro.optim import Hyper as JHyper
from repro.optim import OptimizerConfig as JOCfg
from repro_torch.core import (QuantPolicy, StepOptions, default_bits,
                              make_train_step)
from repro_torch.optim import OptimizerConfig

from test_torch_engine import GRID, _batch, _leaves, _run, _setup, _tparams
from test_torch_encdec import _one_thread  # noqa: E402,F401 (autouse)


@functools.lru_cache(maxsize=None)
def _jax_step(name, backend, updates):
    """JAX's new params (numpy) and metrics after one quantized step."""
    jc, _, jp, _ = _setup(name)
    ocfg = JOCfg(kind="momentum")
    step = j_make(jc, JQP(grad_scale=64.0, kernel_backend=backend,
                          quantize_updates=updates), ocfg)
    bf16 = jc.compute_dtype == "bfloat16"
    args = (jp, j_init(jp, ocfg), {k: jnp.asarray(v)
                                   for k, v in _batch().items()},
            JHyper(lr=jnp.float32(0.05), step=jnp.int32(0)), j_bits(jc))
    with jax.disable_jit() if bf16 else contextlib.nullcontext():
        new, _, m = (step if bf16 else jax.jit(step))(*args)
    return ([np.asarray(x) for x in jax.tree.leaves(new)],
            {k: float(v) for k, v in m.items()})


def _grid_close(got, ref, atol, rtol, step):
    """Within atol + rtol|ref|, or one ``step`` more on <= 1% of elements."""
    err = np.abs(got - ref)
    over = err > atol + rtol * np.abs(ref)
    return (not over.any()) or (bool(np.all(err <= atol + rtol * np.abs(ref)
                                            + step))
                                and over.mean() <= 0.01)


@pytest.mark.parametrize("name,backend,updates", [
    ("tiny", "off", False), ("tiny", "int8", False),
    ("qwen_tiny", "int8", False), ("tiny", "off", True)])
def test_taxonn_step_matches_jax_quantized(name, backend, updates):
    """``updates``: the strict paper mode, q(lr*dW) in the G format."""
    _, tc, _, _ = _setup(name)
    p0 = _tparams(name)
    ref, ref_m = _jax_step(name, backend, updates)
    ocfg = OptimizerConfig(kind="momentum")
    step = make_train_step(tc, QuantPolicy(grad_scale=64.0,
                                           quantize_updates=updates), ocfg,
                           StepOptions(kernel_backend=backend), device="cpu")
    new, _, m = _run(step, p0, ocfg, _batch(), default_bits(tc))
    assert float(m["loss"]) == pytest.approx(ref_m["loss"], rel=1e-6)
    f32 = tc.compute_dtype == "float32"
    assert float(m["grad_norm"]) == pytest.approx(
        ref_m["grad_norm"], rel=1e-5 if f32 else 1e-3)
    assert float(m["tokens"]) == ref_m["tokens"]
    # one grid step of the update: lr * 2^-12, or 2^-12 itself where the
    # update is rounded onto the G grid (strict mode)
    step_w = GRID if updates else 0.05 * GRID
    for (k, g), r, (_, w0) in zip(_leaves(new), ref, _leaves(p0)):
        g, w0 = g.numpy(), w0.numpy()
        assert g.shape == r.shape and g.dtype == r.dtype, k
        if f32:
            assert _grid_close(g, r, 2e-6, 1e-5, step_w), (
                k, np.abs(g - r).max())
        elif k.split("/")[-1] in ("bq", "bk", "bv"):
            rel = np.linalg.norm(g - r) / np.linalg.norm(r - w0)
            assert rel <= 0.05, (k, rel)
        else:
            assert _grid_close(g, r, 0.0, 2.0 ** -22, 0.05 * GRID), (
                k, np.abs(g - r).max())


